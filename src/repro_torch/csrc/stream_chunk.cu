// The streaming runtime's whole chunk in one launch: K hours of every link,
// from the packed host block to the packed result.
//
// Replaces: the chunk step of the JAX streaming runtime,
// src/repro/fleet/runtime.py::_build_step_many (one jitted dispatch for K
// hours): the clip (runtime.py:418-424), the billing-calendar scan (:430-437),
// the tier fold (:448-467; the calendar form of the Pallas kernel
// src/repro/kernels/tiered_cost.py::tiered_cost_scan), the cost planes
// (:497-502), the prefix snapshots and window sums (:501-515) and the FSM
// lax.scan (:577). Before this kernel the port ran it as two kernels
// (tiered_cost_scan.cu's calendar entry and fsm_scan.cu's fsm_chunk) with
// eager torch ops between them; both stay, off the streaming path.
//
// In (flat float64 block, the runtime's _pack layout): demand (K, P), the CCI
// demand (K, P) when the chunk prices the CCI counterfactual on its own volume,
// then the host's pre-chunk window reads pre_v, pre_c (K, M). Fleet mode:
// P == M, one row per link. Out: the packed (8K + 4, M) float64 result, rows
// vpn, cci, r_vpn, r_cci, snap_v, snap_c, x, state (K each), then dcum,
// dcum_month, vpn_pref, cci_pref; and the FSM carry (4, M) int32.
//
// Each hour, in the plain version's order (kernels/ref.py::stream_chunk_ref):
//   d = minimum(demand, capacity)  (NaN if either is NaN, as torch.minimum:
//       tier::min_sel)
//   if ((t0 + k) % hours_per_month == 0) dcum_month = dcum
//   lo = dcum - dcum_month;  dcum = dcum + d
//   vpn = L_vpn + fold(lo, d);  cci = lease + c_cci * d_cci  (product, then sum)
//   snap = pref;  r = pref - pref[max(0, t0 + k - h)];  FSM hour;  pref += cost
// All float64 arithmetic uses _rn intrinsics and the file is compiled with
// -fmad=false, so every output equals the plain version's bit for bit. The
// fold is tier_fold.cuh's (tier::fold_term with min_sel/max_sel, the
// arithmetic of the tier::fold that tiered_cost_scan.cu's calendar entry
// runs) and the FSM hour fsm_step.cuh's triggers and fsm_step_flat
// (fsm_scan.cu's fsm_step with its transitions decided from the carry at
// once). A NaN hi = lo + d makes every tier segment NaN and so
// every term 0, in the plain version and in the fold alike (its min/max keep
// NaN): the hour's transfer is +0.0.
//
// What bounds it on an H100: at the runtime's chunk (2048 rows, K = 24) it
// moves ~4.8 MB, ~1.4 us at 3.35 TB/s, and at K = 1 ~0.6 MB. But each row is
// three dependent chains of K hours (the calendar prefix, the cost prefixes,
// the FSM carry), and a call is a few microseconds, so what a launch costs
// beyond the card's launch-and-drain floor is latency: the round trip of the
// loads, the chains and the hand-offs between them.
//
// Two launch forms; the wrapper picks one by K (kernels/stream_chunk.py::
// launch_form) and passes it as `form`:
//
// * the tick form (form 0, K <= kTickMaxK, tables of <= kTickMaxTiers tiers):
//   one thread walks one row's K hours end to end in registers (K is a
//   template constant, the tables an array of 4 or 8 registers padded with
//   zero-rate tiers, tier::fold_regs), one warp a block,
//   so 2048 rows are 64 blocks on 64 SMs. Every load of the row is issued
//   before the first use (an hour's 32 rows are 256 contiguous bytes), so the
//   launch pays one device-memory round trip; no shared memory, no barrier.
//   A window base inside the chunk is the row's own earlier snapshot, picked
//   from the register array by compile-time compares.
// * the chunk form (form S = 1..3, any K): the first design's (hour, row) split of the
//   fold and the window sums, pipelined over sub-tiles of kSub = 8 hours. A
//   block owns kRows = 16 rows and walks the chunk in tiles of 8S hours (S =
//   ceil(K / 8), at most kMaxSubs); its warps have roles:
//     pair warps (4 a sub-tile, one (hour, row) pair a thread): load their
//       pair's demand, CCI demand and window base, fold, form the cost
//       planes, the window sums and the raw triggers, store the planes;
//     the calendar warp (lane r on row r): loads its rows' demand for the
//       tile itself and runs the calendar prefix, a sub-tile at a time;
//     the prefix warp: the cost prefixes into the snapshots;
//     the FSM warp: the FSM over the triggers, integers only.
//   The FSM warp's chain then sets the pace: an hour of it is ~130 cycles on
//   the H100 (one warp issuing in order), so both forms step it with
//   fsm::fsm_step_flat, fsm_step's states decided from the carry at once.
//   A sub-tile is handed along with named barriers, each held by its four
//   pair warps and one chain warp (bar.arrive by the producer, bar.sync by
//   the consumer): lo (calendar -> pairs), fold (pairs -> prefix warp), pref
//   (prefix warp -> pairs), trig (pairs -> FSM warp), state (FSM warp ->
//   pairs). So the calendar walks sub-tile j + 1 while the pairs fold j and
//   the FSM walks j - 1, and no phase waits for a block-wide barrier: five
//   barriers a sub-tile, three sub-tiles take 15 of the 16 a block has (0 is
//   __syncthreads, once a tile, for the tables and for reusing the tile's
//   shared memory).
//
// The forecast-gated policy (ForecastGatedPolicy.step in replay mode,
// src/repro/fleet/runtime.py:297-306, and :519-524, :546-548 in the chunk) is
// a gated instance (kReplay) of each form: the hour's raw triggers go through
// fsm_step.cuh's fsm_gated_triggers, on the thresholds fsm_gate forms once a
// row, against the hour's predicted mode costs p_vpn, p_cci, two hour-major
// (T_pred, M) planes read at hour min(t0 + k, T_pred - 1) (the JAX runtime's
// clipped column). The tick form loads them with the row's other loads; in
// the chunk form the pair warps load their pair's two values with its demand
// (an hour's rows are contiguous, so the loads coalesce), and the FSM warp
// stays integer-only. The reactive and hysteresis instances read nothing of
// them and compile as before.
//
// The same policy in live mode (src/repro/fleet/runtime.py:541-575) is a LIVE
// instance of each form (the template's gate mode G: kUngated, kReplay or
// kLive): the SSM demand forecaster steps inside the chunk
// (live_forecast.cuh). Hour k's gates read the predicted mode costs of the
// forecast made after hour k - 1 (the carried pred_in at the chunk's first
// hour); after the hour, the forecaster consumes the hour's clipped demand d
// and makes the next forecast, which the result's ninth (K, M) plane holds
// (the tail moves to 9K). The forecast chain reads no decision, so it runs
// ahead of everything that does. In the tick form, after the clips, state by
// state (one state's chain in registers at a time, each hour's readout folded
// left over the states as they come: ~2K + 4 registers, not 4 x S). In the
// chunk form, at the top of each tile, before the tile's __syncthreads, with
// every thread of the block:
//   each pair thread (hour kk, row r) forms its hour's input u from the
//     demand it loads anyway and stores it in shared memory; __syncthreads;
//   thread c walks chain (row c % 16, state c / 16) of a pass of kLivePass
//     states over the tile's hours, one multiply, a multiply and an add an
//     hour, each hour's readout term into shared memory (its state in h_out
//     between tiles: a thread reads back its own store); __syncthreads;
//   each pair thread folds its hour's terms into its running sum, left from
//     state 0 (and, past kLivePass states, the next pass follows after a
//     __syncthreads); then forms its hour's readout and its one forecast (one
//     float64 expm1), into the ninth plane and shared memory.
// The tile's own __syncthreads then hands every forecast to the pipeline: a
// pair thread forms the predicted mode costs of the forecast carried into its
// hour (the previous hour's, from shared memory; at a tile's first hour the
// one it read before the tile's first barrier) between the fold's hand-off
// and the prefixes' wait. No named barrier is used (all 16 are taken), S is a
// run-time count (no register array is sized by it), and each hour's forecast
// and mode costs are formed once. (The first chunk form walked each row's S
// states on one lane of the calendar warp, lanes 16..31, and formed each
// forecast twice: 0.01602 ms at 2048 x 24 on an NVIDIA H100 80GB HBM3 at
// 700 W, against the replay instance's 0.00454, with a 264-byte spill;
// PERF.md.) The FSM warp stays integer-only.

// The multi-tenant gateway's POOLED instances (the template's PL; kUngated
// and kReplay, no live mode): a bucket of tenants stacked into one call, each
// row with its own clock, since tenants join at different gateway hours
// (src/repro/gateway/gateway.py:402-428 vmaps the standalone tick over the
// pool's slots, each slot's t and hours_per_month its own). A row reads its
// first hour t0_row[n] and its hours_per_month hpm_row[n] once, with its other
// operands; its month phase is t0 % hpm, formed where the scalar instances
// read the call's. In the tick form the row's thread holds them; in the chunk
// form each pair thread holds its row's t0 (window base, gate column) and the
// calendar warp's lane its row's phase and hpm, stepping them hour by hour as
// the scalar lane steps the call's. Everything else is the scalar instance's
// code, so a pool whose rows share one clock gives its bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fsm_step.cuh"
#include "live_forecast.cuh"
#include "tier_fold.cuh"

namespace {

constexpr int kTickThreads = 32;    // tick form: one row a thread, one warp a block
constexpr int kTickMaxK = 5;        // tick-form instances K = 1..5 (TICK_MAX_K)
constexpr int kTickMaxKLive = 3;    // the live instance's: K = 1..3 (TICK_MAX_K_LIVE)
constexpr int kTickMaxTiers = 8;    // its tier tables live in registers
constexpr int kRows = 16;           // chunk form: rows a block
constexpr int kSub = 8;             // hours a sub-tile
constexpr int kMaxSubs = 3;         // sub-tiles a tile: 5 named barriers each
constexpr int kPhases = 5;          // lo, fold, pref, trig, state
constexpr int kBarThreads = 5 * 32; // a sub-tile's four pair warps and one chain warp
constexpr int kMaxSmem = 227 * 1024;
constexpr int kLivePass = 16;       // chunk form: the live forecaster's states a pass
// The template's gate mode: reactive/hysteresis, forecast-gated in replay
// mode (predicted-cost planes given), forecast-gated in live mode.
constexpr int kUngated = 0, kReplay = 1, kLive = 2;

// Where the packed result's tail (dcum, dcum_month, prefixes) starts: after
// the 8 planes, 9 in the live instances.
template <int G>
__device__ __forceinline__ int64_t tail_at(int64_t KM) {
  return (G == kLive ? 9 : 8) * KM;
}

// The chunk's operands, as the C entry takes them.
struct ChunkArgs {
  const double* demand;      // (K, M)
  const double* cci_demand;  // (K, M) or null
  const double* pre_v;       // (K, M)
  const double* pre_c;
  const double* capacity;    // (M,)
  const double* L_vpn;
  const double* lease_cci;   // L_cci + V_cci
  const double* c_cci;
  const double* bounds;      // (M, Kt)
  const double* rates;
  const double* theta1;
  const double* theta2;
  const int* win;
  const int* delay;
  const int* commit;
  const int* up_hold;
  const int* down_hold;
  const double* cal_in;      // (2, M) dcum, dcum_month
  const int* fsm_in;         // (4, M)
  const double* pref_in;     // (2, M)
  const double* p_vpn;       // (T_pred, M) predicted mode costs: the kReplay instances
  const double* p_cci;
  const double* margin;      // (M,)
  int renew_in_chunks, t0, phase0, hours_per_month, K, M, Kt, T_pred;
  double* out;               // (8K + 4, M); (9K + 4, M) in the LIVE instances
  int* fsm_out;              // (4, M)
  const float* h_in;         // (M, S) the LIVE instances' forecaster state
  const double* pred_in;     // (M,) the forecast carried into the chunk
  const float* ssm_a;        // (S,) a, 1 - a, w and the bias () of the forecaster
  const float* ssm_oma;
  const float* ssm_w;
  const float* ssm_bias;
  const double* scale;       // (M,)
  const double* coef;        // (M, 4) the cost coefficients [a_vpn, b_vpn, a_cci, b_cci]
  int S;
  float* h_out;              // (M, S)
  const int* t0_row;         // (M,) the PL instances' first hour of each row
  const int* hpm_row;        // (M,) and its hours per month
};

// A row's own clock in the PL instances, read once with its other operands:
// its first hour and hours per month ({0, 1} for a lane with no row). The
// others hold none (NoClock), so their code path is the scalar kernel's as it
// was.
struct RowClock {
  int t0 = 0, hpm = 1;
};
struct NoClock {};

template <bool PL>
using ClockOf = std::conditional_t<PL, RowClock, NoClock>;

template <bool PL>
__device__ __forceinline__ ClockOf<PL> row_clock(const ChunkArgs& a, int n) {
  if constexpr (PL) {
    return {a.t0_row[n], a.hpm_row[n]};
  } else {
    return {};
  }
}

// The chunk's first hour, hours per month and month phase ((t0 + k) %
// hours_per_month at k = 0) of a row holding clock c: the row's own in the
// PL instances; the call's, read where it is used, in the others (whose code
// path is then the scalar kernel's as it was).
template <bool PL>
__device__ __forceinline__ int first_hour(const ChunkArgs& a, const ClockOf<PL>& c) {
  if constexpr (PL) return c.t0;
  else return a.t0;
}
template <bool PL>
__device__ __forceinline__ int month_hours(const ChunkArgs& a, const ClockOf<PL>& c) {
  if constexpr (PL) return c.hpm;
  else return a.hours_per_month;
}
template <bool PL>
__device__ __forceinline__ int month_phase(const ChunkArgs& a, const ClockOf<PL>& c) {
  if constexpr (PL) return c.t0 % c.hpm;
  else return a.phase0;
}

__device__ __forceinline__ fsm::FsmRow fsm_row(const ChunkArgs& a, int n) {
  return {a.theta1[n], a.theta2[n], a.delay[n], a.commit[n], a.up_hold[n], a.down_hold[n],
          a.renew_in_chunks != 0};
}

__device__ __forceinline__ fsm::FsmCarry fsm_carry(const ChunkArgs& a, int n) {
  fsm::FsmCarry c = {a.fsm_in[n], a.fsm_in[a.M + n], a.fsm_in[2 * a.M + n],
                     a.fsm_in[3 * a.M + n], 0};
  c.phase = c.t_state % a.commit[n];
  return c;
}

// The hour of the predicted-cost planes that chunk hour k reads, row-major
// offset of row n whose chunk starts at t0: the JAX runtime's clip(t0 + k, 0,
// T_pred - 1).
__device__ __forceinline__ int64_t gate_at(const ChunkArgs& a, int t0, int k, int n) {
  return (int64_t)min(t0 + k, a.T_pred - 1) * a.M + n;
}

// ---------------------------------------------------------------- tick form

// K hours; tables of at most KT tiers, padded to KT; G: the gate mode; PL:
// one clock per row (the pooled instance)
template <int K, int KT, int G, bool PL>
__global__ void __launch_bounds__(kTickThreads, 8)
stream_chunk_tick_kernel(const ChunkArgs a) {
  const int n = blockIdx.x * kTickThreads + threadIdx.x;
  if (n >= a.M) return;
  const ClockOf<PL> ck = row_clock<PL>(a, n);
  const int M = a.M;
  const int64_t KM = (int64_t)K * M;
  const bool endo = a.cci_demand != nullptr;

  // every load of the row first
  double dv[K], cv[K], bv[K], bc[K];
  [[maybe_unused]] double gv[K], gc[K];   // kReplay: the hours' predicted mode costs
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * M + n;
    dv[k] = a.demand[i];
    cv[k] = endo ? a.cci_demand[i] : 0.0;
    bv[k] = a.pre_v[i];
    bc[k] = a.pre_c[i];
    if constexpr (G == kReplay) {
      gv[k] = a.p_vpn[gate_at(a, first_hour<PL>(a, ck), k, n)];
      gc[k] = a.p_cci[gate_at(a, first_hour<PL>(a, ck), k, n)];
    }
  }
  double tb[KT], tr[KT];                  // past Kt: the last bound, rate 0 (terms +0.0)
  const double* rb = a.bounds + (int64_t)n * a.Kt;
  const double* rr = a.rates + (int64_t)n * a.Kt;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    tb[t] = t < a.Kt ? rb[t] : t > 0 ? tb[t - 1] : 0.0;
    tr[t] = t < a.Kt ? rr[t] : 0.0;
  }
  const double cap = a.capacity[n], lvpn = a.L_vpn[n], lease = a.lease_cci[n], cc = a.c_cci[n];
  const int h = a.win[n];
  const fsm::FsmRow p = fsm_row(a, n);
  [[maybe_unused]] fsm::FsmGate g = {};
  if constexpr (G != kUngated) g = fsm::fsm_gate(p, a.margin[n]);
  [[maybe_unused]] double scale = 0.0, pred0 = 0.0, cf[4] = {0.0, 0.0, 0.0, 0.0};
  if constexpr (G == kLive) {
    scale = a.scale[n];
    pred0 = a.pred_in[n];
#pragma unroll
    for (int q = 0; q < 4; ++q) cf[q] = a.coef[4 * (int64_t)n + q];
  }
  fsm::FsmCarry fc = fsm_carry(a, n);
  double dcum = a.cal_in[n], month = a.cal_in[M + n];
  double pv = a.pref_in[n], pc = a.pref_in[M + n];

  // The hour's steps in phases across the K hours, so that work no chain
  // waits for overlaps the chains (one warp issues in order; written hour by
  // hour, an hour took ~500 cycles): the clips, then the calendar (one add an
  // hour on the chain), the folds and cost planes (independent), the prefix
  // snapshots (one add an hour), the window sums and raw triggers
  // (independent), then the FSM (its chain alone).
  double d[K], dc[K], lo[K], v[K], c[K], sv[K], sc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    d[k] = tier::min_sel(dv[k], cap);
    dc[k] = endo ? tier::min_sel(cv[k], cap) : d[k];
  }
  // kLive: the forecast made after each hour, from the clipped demand alone
  [[maybe_unused]] double pr[K];
  if constexpr (G == kLive) {
    float u[K], acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      u[k] = live::ssm_input(d[k], scale);
      acc[k] = 0.0f;
    }
    for (int s = 0; s < a.S; ++s) {        // state by state, hours in order
      const int64_t j = (int64_t)n * a.S + s;
      const float as = a.ssm_a[s], bs = a.ssm_oma[s], ws = a.ssm_w[s];
      float hs = a.h_in[j];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float t = live::ssm_state(hs, u[k], as, bs, ws);
        acc[k] = s == 0 ? t : __fadd_rn(acc[k], t);
      }
      a.h_out[j] = hs;
    }
    const float b = a.ssm_bias[0];
#pragma unroll
    for (int k = 0; k < K; ++k) pr[k] = live::prediction(live::ssm_readout(u[k], acc[k], b), scale);
  }
  int ph = month_phase<PL>(a, ck);         // (t0 + k) % hours_per_month
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (ph == 0) month = dcum;
    lo[k] = __dsub_rn(dcum, month);
    dcum = __dadd_rn(dcum, d[k]);
    ph = ph + 1 == month_hours<PL>(a, ck) ? 0 : ph + 1;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = __dadd_rn(lvpn, tier::fold_regs(lo[k], d[k], tb, tr));
    c[k] = __dadd_rn(lease, __dmul_rn(cc, dc[k]));
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sv[k] = pv;
    sc[k] = pc;
    pv = __dadd_rn(pv, v[k]);
    pc = __dadd_rn(pc, c[k]);
  }
  bool raw_req[K], raw_rel[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * M + n;
    // the window base: the host's read before t0, else this chunk's snapshot
    const int lw = max(0, first_hour<PL>(a, ck) + k - h) - first_hour<PL>(a, ck);
    double base_v = bv[k], base_c = bc[k];
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      base_v = lw == j ? sv[j] : base_v;
      base_c = lw == j ? sc[j] : base_c;
    }
    const double rv = __dsub_rn(sv[k], base_v);
    const double rc = __dsub_rn(sc[k], base_c);
    fsm::fsm_triggers(p, rv, rc, raw_req[k], raw_rel[k]);
    if constexpr (G == kReplay) fsm::fsm_gated_triggers(g, gv[k], gc[k], raw_req[k], raw_rel[k]);
    if constexpr (G == kLive) {           // the forecast carried into hour k
      double lv, lc;
      live::mode_costs(k == 0 ? pred0 : pr[k - 1], cf, lv, lc);
      fsm::fsm_gated_triggers(g, lv, lc, raw_req[k], raw_rel[k]);
      a.out[8 * KM + i] = pr[k];
    }
    a.out[i] = v[k];
    a.out[KM + i] = c[k];
    a.out[2 * KM + i] = rv;
    a.out[3 * KM + i] = rc;
    a.out[4 * KM + i] = sv[k];
    a.out[5 * KM + i] = sc[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * M + n;
    const int state = fsm::fsm_step_flat(p, fc, raw_req[k], raw_rel[k], p.renew_in_chunks);
    a.out[6 * KM + i] = state == fsm::kOn ? 1.0 : 0.0;
    a.out[7 * KM + i] = (double)state;
  }
  const int64_t e = tail_at<G>(KM) + n;
  a.out[e] = dcum;
  a.out[e + M] = month;
  a.out[e + 2 * M] = pv;
  a.out[e + 3 * M] = pc;
  a.fsm_out[n] = fc.state;
  a.fsm_out[M + n] = fc.t_state;
  a.fsm_out[2 * M + n] = fc.up;
  a.fsm_out[3 * M + n] = fc.down;
}

// --------------------------------------------------------------- chunk form

// Named barriers: the producer arrives, the consumer waits; both are whole
// warps (the __syncwarp reconverges a warp whose lanes took different paths).
__device__ __forceinline__ void bar_arrive(int id) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kBarThreads) : "memory");
}
__device__ __forceinline__ void bar_wait(int id) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kBarThreads) : "memory");
}
enum Phase { kLo, kFold, kPref, kTrig, kState };
__device__ __forceinline__ int bar_id(int sub, Phase p) { return 1 + kPhases * sub + p; }

// One tile of the block's rows, hour-major [hour][row]: the chain lanes (one
// row each) and the pair threads (row fastest) touch consecutive words.
template <int kTile>
struct PipeTile {
  double lo[kTile][kRows];    // month-to-date volume before the hour
  double vpn[kTile][kRows];
  double cci[kTile][kRows];
  double sv[kTile][kRows];    // prefix snapshots: pref before the hour
  double sc[kTile][kRows];
  int trig[kTile][kRows];     // the hour's raw triggers: bit 0 request, bit 1 release
  int state[kTile][kRows];
};

// kLive: the tile's forecasts, behind the tables in dynamic shared memory.
template <int kTile>
struct LiveTile {
  double coef[kRows][4];      // the rows' cost coefficients
  double pred[kTile][kRows];  // the forecast made after each hour
  float us[kTile][kRows];     // each hour's input u
  // a pass's readout terms, [state][hour][row], a state's rows 16 words
  // apart beyond its kTile x kRows (so a warp's 2 x 16 chains hit 32 banks)
  float terms[kLivePass][kTile * kRows + kRows];
};

// A live chain's operands: the state and the state's a, 1 - a and w.
struct LiveChain {
  float h, as, bs, ws;
};

// The chain of row n and state s: its state before the tile (h_in at the
// chunk's first tile, else the h_out this thread stored after the last).
__device__ __forceinline__ LiveChain live_chain(const ChunkArgs& a, int n, int s,
                                                bool first_tile) {
  const int64_t j = (int64_t)n * a.S + s;
  return {(first_tile ? a.h_in : a.h_out)[j], a.ssm_a[s], a.ssm_oma[s], a.ssm_w[s]};
}

// kLive, every thread of the block at the top of a tile, after the pair
// threads stored the tile's inputs: the chains, a pass at a time, and the
// pair thread's (pair: it holds hour kk of row r) fold of its hour's terms
// into acc. `pre` is the thread's first chain's operands, loaded before the
// chunk's first tile. Every thread meets the same __syncthreads.
template <int kTile>
__device__ __forceinline__ void live_chains(const ChunkArgs& a, LiveTile<kTile>& lt, int n0,
                                            int rows, int k0, int len, bool pair, int kk, int r,
                                            float& acc, const LiveChain& pre) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  __syncthreads();                         // the tile's inputs are stored
  for (int s0 = 0; s0 < a.S; s0 += kLivePass) {
    const int np = min(kLivePass, a.S - s0);
    for (int c = tid; c < kRows * np; c += nthreads) {
      const int cr = c % kRows, cs = c / kRows;
      if (cr < rows) {
        const int n = n0 + cr, s = s0 + cs;
        LiveChain ch = s0 == 0 && c == tid && k0 == 0 ? pre : live_chain(a, n, s, k0 == 0);
        float* tp = &lt.terms[cs][cr];
        // the tile's inputs into registers half a tile at a time (a whole
        // tile beside a pair thread's operands outgrew the registers)
        constexpr int kHalf = kTile / 2;
#pragma unroll
        for (int k0h = 0; k0h < kTile; k0h += kHalf) {
          float uv[kHalf];                 // hours past len are read, not used
#pragma unroll
          for (int k = 0; k < kHalf; ++k) uv[k] = lt.us[k0h + k][cr];
#pragma unroll
          for (int k = 0; k < kHalf; ++k)
            if (k0h + k < len)
              tp[(k0h + k) * kRows] = live::ssm_state(ch.h, uv[k], ch.as, ch.bs, ch.ws);
        }
        a.h_out[(int64_t)n * a.S + s] = ch.h;
      }
    }
    __syncthreads();                       // the pass's terms are stored
    if (pair) {
      for (int q = 0; q < np; ++q) {
        const float t = lt.terms[q][kk * kRows + r];
        acc = s0 + q == 0 ? t : __fadd_rn(acc, t);
      }
    }
    if (s0 + kLivePass < a.S) __syncthreads();   // ... and read, before the next pass's
  }
}

// The live chains for a role that holds no pair (the chain warps): kLive
// only, the same barriers as the pair warps meet.
template <int G, int kTile>
__device__ __forceinline__ void live_tile(const ChunkArgs& a, LiveTile<kTile>& lt, int n0,
                                          int rows, int k0, int len, const LiveChain& pre) {
  if constexpr (G == kLive) {
    float acc = 0.0f;
    live_chains<kTile>(a, lt, n0, rows, k0, len, false, 0, 0, acc, pre);
  }
}

template <int S, int G, bool PL>
__global__ void __launch_bounds__(32 * (4 * S + 3), 1)
stream_chunk_pipe_kernel(const ChunkArgs a) {
  constexpr int kTile = kSub * S;
  constexpr int kPairWarps = 4 * S;
  __shared__ PipeTile<kTile> sm;
  extern __shared__ double tables[];       // bounds (kRows, Kt), then rates (kRows, Kt)
  const int M = a.M, K = a.K, Kt = a.Kt;
  const int64_t KM = (int64_t)K * M;
  // kLive: the tile's forecasts behind the tables
  [[maybe_unused]] LiveTile<kTile>& lt =
      *reinterpret_cast<LiveTile<kTile>*>(tables + 2 * kRows * Kt);
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool endo = a.cci_demand != nullptr;
  // kLive: the operands of this thread's first chain (chain tid of the first
  // pass), loaded before the first tile so their round trip overlaps the
  // demand's
  [[maybe_unused]] LiveChain pre = {};
  if constexpr (G == kLive) {
    if (tid < kRows * min(kLivePass, a.S) && tid % kRows < rows)
      pre = live_chain(a, n0 + tid % kRows, tid / kRows, true);
  }

  if (warp < kPairWarps) {
    // ---- pair warps: (hour kk, row r) of every tile; sub-tile j = warp / 4
    const int kk = tid / kRows, r = tid % kRows, j = warp / 4;
    const int n = n0 + r;
    const bool has_row = r < rows;
    double cap = 0.0, lvpn = 0.0, lease = 0.0, cc = 0.0;
    fsm::FsmRow pr = {};                   // the thresholds the window sums meet
    [[maybe_unused]] fsm::FsmGate g = {};  // the forecast gates' thresholds
    [[maybe_unused]] double scale = 0.0;
    [[maybe_unused]] float bias = 0.0f;
    int h = 0;
    ClockOf<PL> ck = {};                   // PL: the row's clock (window base, gate column)
    if (has_row) {
      if constexpr (PL) ck = row_clock<PL>(a, n);
      cap = a.capacity[n];
      lvpn = a.L_vpn[n];
      lease = a.lease_cci[n];
      cc = a.c_cci[n];
      pr.theta1 = a.theta1[n];
      pr.theta2 = a.theta2[n];
      h = a.win[n];
      if constexpr (G != kUngated) g = fsm::fsm_gate(pr, a.margin[n]);
      if constexpr (G == kLive) {
        scale = a.scale[n];
        bias = a.ssm_bias[0];
        if (kk < 4) lt.coef[r][kk] = a.coef[4 * (int64_t)n + kk];   // read after a tile's barrier
      }
    }
    const double* tb = tables + r * Kt;
    const double* tr = tables + (kRows + r) * Kt;
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const bool mine = has_row && kk < K - k0;
      const int64_t i = (int64_t)(k0 + kk) * M + n;
      double dv = 0.0, cv = 0.0, bv = 0.0, bc = 0.0;
      [[maybe_unused]] double gv = 0.0, gc = 0.0;
      if (mine) {
        dv = a.demand[i];
        if (endo) cv = a.cci_demand[i];
        bv = a.pre_v[i];
        bc = a.pre_c[i];
        if constexpr (G == kReplay) {
          gv = a.p_vpn[gate_at(a, first_hour<PL>(a, ck), k0 + kk, n)];
          gc = a.p_cci[gate_at(a, first_hour<PL>(a, ck), k0 + kk, n)];
        }
      }
      if (k0 == 0) {
        for (int o = tid; o < rows * Kt; o += kPairWarps * 32) {
          tables[o] = a.bounds[(int64_t)n0 * Kt + o];
          tables[kRows * Kt + o] = a.rates[(int64_t)n0 * Kt + o];
        }
      }
      // kLive: the forecast carried into the tile (hour 0's thread), the
      // hour's input, the chains and the hour's one forecast
      [[maybe_unused]] double carried = 0.0;
      if constexpr (G == kLive) {
        if (kk == 0 && has_row) carried = k0 == 0 ? a.pred_in[n] : lt.pred[kTile - 1][r];
        float u = 0.0f, acc = 0.0f;
        if (mine) {
          u = live::ssm_input(tier::min_sel(dv, cap), scale);
          lt.us[kk][r] = u;
        }
        live_chains<kTile>(a, lt, n0, rows, k0, min(kTile, K - k0), mine, kk, r, acc, pre);
        if (mine) {
          const double pred = live::prediction(live::ssm_readout(u, acc, bias), scale);
          lt.pred[kk][r] = pred;
          a.out[8 * KM + i] = pred;
        }
      }
      __syncthreads();   // the tables and forecasts; every role done with the last tile
      const int t0 = first_hour<PL>(a, ck);
      const int lw = max(0, t0 + k0 + kk - h) - t0;   // the window base's hour
      if (mine && lw >= 0 && lw < k0) {                    // an earlier tile's snapshot
        bv = a.out[4 * KM + (int64_t)lw * M + n];
        bc = a.out[5 * KM + (int64_t)lw * M + n];
      }
      const double d = tier::min_sel(dv, cap);
      const double dc = endo ? tier::min_sel(cv, cap) : d;

      const double c = __dadd_rn(lease, __dmul_rn(cc, dc));   // needs no lo
      bar_wait(bar_id(j, kLo));
      double v = 0.0;
      if (mine) {
        const double transfer = tier::fold_with_sel(
            sm.lo[kk][r], d, [tb](int t) { return tb[t]; }, [tr](int t) { return tr[t]; }, Kt);
        v = __dadd_rn(lvpn, transfer);
        sm.vpn[kk][r] = v;
        sm.cci[kk][r] = c;
      }
      bar_arrive(bar_id(j, kFold));
      if (mine) {   // global stores after the hand-off: no barrier waits on them
        a.out[i] = v;
        a.out[KM + i] = c;
      }
      if constexpr (G == kLive) {   // the gate costs of the forecast carried into the hour
        if (mine) live::mode_costs(kk == 0 ? carried : lt.pred[kk - 1][r], lt.coef[r], gv, gc);
      }

      bar_wait(bar_id(j, kPref));
      double w[4] = {0.0, 0.0, 0.0, 0.0};   // r_vpn, r_cci, snap_v, snap_c
      if (mine) {
        const bool in_tile = lw >= k0;     // its own tile's snapshots (lw - k0 <= kk)
        const double sv = sm.sv[kk][r], sc = sm.sc[kk][r];
        const double rv = __dsub_rn(sv, in_tile ? sm.sv[lw - k0][r] : bv);
        const double rc = __dsub_rn(sc, in_tile ? sm.sc[lw - k0][r] : bc);
        bool raw_req, raw_rel;
        fsm::fsm_triggers(pr, rv, rc, raw_req, raw_rel);
        if constexpr (G != kUngated) fsm::fsm_gated_triggers(g, gv, gc, raw_req, raw_rel);
        sm.trig[kk][r] = (int)raw_req | (int)raw_rel << 1;
        w[0] = rv;
        w[1] = rc;
        w[2] = sv;
        w[3] = sc;
      }
      bar_arrive(bar_id(j, kTrig));
      if (mine) {
#pragma unroll
        for (int q = 0; q < 4; ++q) a.out[(2 + q) * KM + i] = w[q];
      }

      bar_wait(bar_id(j, kState));
      if (mine) {
        const int s = sm.state[kk][r];
        a.out[6 * KM + i] = s == fsm::kOn ? 1.0 : 0.0;
        a.out[7 * KM + i] = (double)s;
      }
    }
    return;
  }

  // ---- chain warps: lane r walks row n0 + r
  const int role = warp - kPairWarps;      // 0 calendar, 1 prefixes, 2 FSM
  const bool live = lane < rows;
  const int n = n0 + lane;
  if (role == 0) {
    const bool has = lane < rows;
    double cap = 0.0, dcum = 0.0, month = 0.0;
    ClockOf<PL> ck = {};                   // PL: the row's clock
    if (has) {
      if constexpr (PL) ck = row_clock<PL>(a, n);
      cap = a.capacity[n];
      dcum = a.cal_in[n];
      month = a.cal_in[M + n];
    }
    int ph = month_phase<PL>(a, ck);       // (t0 + k) % hours_per_month
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int len = min(kTile, K - k0);
      double dv[kTile];                    // the tile's demand, loads in flight at once
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        dv[k] = has && k < len ? a.demand[(int64_t)(k0 + k) * M + n] : 0.0;
      live_tile<G, kTile>(a, lt, n0, rows, k0, len, pre);
      __syncthreads();
      // one calendar hour; a lane past the block's rows computes on zeros and
      // stores nothing
      auto hour = [&](int k) {
        if (ph == 0) month = dcum;
        const double lo = __dsub_rn(dcum, month);
        if (has) sm.lo[k][lane] = lo;
        dcum = __dadd_rn(dcum, tier::min_sel(dv[k], cap));
        ph = ph + 1 == month_hours<PL>(a, ck) ? 0 : ph + 1;
      };
      // the calendar's hours of sub-tile j
      auto calendar = [&](int j) {
        if (len >= kSub * (j + 1)) {       // a full sub-tile: no branch an hour
#pragma unroll
          for (int k = kSub * j; k < kSub * (j + 1); ++k) hour(k);
        } else {                           // compile-time k: dv stays in registers
#pragma unroll
          for (int k = kSub * j; k < kSub * (j + 1); ++k)
            if (k < len) hour(k);
        }
      };
#pragma unroll
      for (int j = 0; j < S; ++j) {
        calendar(j);
        bar_arrive(bar_id(j, kLo));
      }
    }
    if (has) {
      a.out[tail_at<G>(KM) + n] = dcum;
      a.out[tail_at<G>(KM) + M + n] = month;
    }
  } else if (role == 1) {
    double pv = 0.0, pc = 0.0;
    if (live) {
      pv = a.pref_in[n];
      pc = a.pref_in[M + n];
    }
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int len = min(kTile, K - k0);
      live_tile<G, kTile>(a, lt, n0, rows, k0, len, pre);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < S; ++j) {
        bar_wait(bar_id(j, kFold));
        if (live) {
          auto hour = [&](int k) {
            sm.sv[k][lane] = pv;
            sm.sc[k][lane] = pc;
            pv = __dadd_rn(pv, sm.vpn[k][lane]);
            pc = __dadd_rn(pc, sm.cci[k][lane]);
          };
          if (len >= kSub * (j + 1)) {
#pragma unroll
            for (int k = kSub * j; k < kSub * (j + 1); ++k) hour(k);
          } else {
            for (int k = kSub * j; k < len; ++k) hour(k);
          }
        }
        bar_arrive(bar_id(j, kPref));
      }
    }
    if (live) {
      a.out[tail_at<G>(KM) + 2 * M + n] = pv;
      a.out[tail_at<G>(KM) + 3 * M + n] = pc;
    }
  } else {
    fsm::FsmRow p = {};
    fsm::FsmCarry fc = {};
    if (live) {
      p = fsm_row(a, n);
      fc = fsm_carry(a, n);
    }
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int len = min(kTile, K - k0);
      live_tile<G, kTile>(a, lt, n0, rows, k0, len, pre);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < S; ++j) {
        bar_wait(bar_id(j, kTrig));
        if (live) {
          int t[kSub];                     // the sub-tile's triggers, read in one go
#pragma unroll
          for (int k = 0; k < kSub; ++k) t[k] = sm.trig[kSub * j + k][lane];
          auto hour = [&](int k) {
            sm.state[kSub * j + k][lane] =
                fsm::fsm_step_flat(p, fc, t[k] & 1, t[k] >> 1, p.renew_in_chunks);
          };
          if (len >= kSub * (j + 1)) {
#pragma unroll
            for (int k = 0; k < kSub; ++k) hour(k);
          } else {
#pragma unroll
            for (int k = 0; k < kSub; ++k)
              if (kSub * j + k < len) hour(k);
          }
        }
        bar_arrive(bar_id(j, kState));
      }
    }
    if (live) {
      a.fsm_out[n] = fc.state;
      a.fsm_out[M + n] = fc.t_state;
      a.fsm_out[2 * M + n] = fc.up;
      a.fsm_out[3 * M + n] = fc.down;
    }
  }
}

// The live instance has no tick form past kTickMaxKLive (its chunk form is
// faster there), so none is compiled; nor has it a pooled instance.
template <int K, int G, bool PL>
int launch_tick(const ChunkArgs& a, cudaStream_t stream) {
  if constexpr (G == kLive && (K > kTickMaxKLive || PL)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int blocks = (a.M + kTickThreads - 1) / kTickThreads;
    if (a.Kt <= kTickMaxTiers / 2)
      stream_chunk_tick_kernel<K, kTickMaxTiers / 2, G, PL>
          <<<blocks, kTickThreads, 0, stream>>>(a);
    else
      stream_chunk_tick_kernel<K, kTickMaxTiers, G, PL><<<blocks, kTickThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
}

template <int S, int G, bool PL>
int launch_pipe(const ChunkArgs& a, cudaStream_t stream) {
  if constexpr (G == kLive && PL) return (int)cudaErrorInvalidValue;
  // the tables, then (kLive) the tile's forecasts
  const size_t tables = sizeof(double) * 2 * kRows * (size_t)a.Kt +
                        (G == kLive ? sizeof(LiveTile<kSub * S>) : 0);
  if (sizeof(PipeTile<kSub * S>) + tables > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (sizeof(PipeTile<kSub * S>) + tables > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(stream_chunk_pipe_kernel<S, G, PL>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)tables);
    if (err != cudaSuccess) return (int)err;
  }
  stream_chunk_pipe_kernel<S, G, PL>
      <<<(a.M + kRows - 1) / kRows, 32 * (4 * S + 3), tables, stream>>>(a);
  return (int)cudaGetLastError();
}

// The launch of `form` (the C entry's) in the instance of gate mode G and
// clocks PL.
template <int G, bool PL>
int launch(const ChunkArgs& a, int form, cudaStream_t s) {
  if (form == 0) {
    if (a.K > (G == kLive ? kTickMaxKLive : kTickMaxK) || a.Kt > kTickMaxTiers)
      return (int)cudaErrorInvalidValue;
    switch (a.K) {
      case 1: return launch_tick<1, G, PL>(a, s);
      case 2: return launch_tick<2, G, PL>(a, s);
      case 3: return launch_tick<3, G, PL>(a, s);
      case 4: return launch_tick<4, G, PL>(a, s);
      case 5: return launch_tick<5, G, PL>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (form) {
    case 1: return launch_pipe<1, G, PL>(a, s);
    case 2: return launch_pipe<2, G, PL>(a, s);
    case 3: return launch_pipe<kMaxSubs, G, PL>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The live instances' transcendentals alone, elementwise, for the card's
// check that they give torch's CUDA ops' bits: fn 0 log1p, 1 exp, 2 expm1
// (float64), 3 log1pf (float32).
__global__ void live_math_kernel(const void* x, void* y, int64_t n, int fn) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (fn == 3) {
    static_cast<float*>(y)[i] = log1pf(static_cast<const float*>(x)[i]);
    return;
  }
  const double v = static_cast<const double*>(x)[i];
  static_cast<double*>(y)[i] = fn == 0 ? log1p(v) : fn == 1 ? exp(v) : expm1(v);
}

}  // namespace

extern "C" int stream_chunk_live_math(const void* x, void* y, long long n, int fn,
                                      void* stream) {
  if (n < 0 || fn < 0 || fn > 3) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  live_math_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(x, y, n, fn);
  return (int)cudaGetLastError();
}

// form: 0 the tick form (K <= kTickMaxK, kTickMaxKLive live; Kt <= kTickMaxTiers), 1..3 the chunk
// form with that many 8-hour sub-tiles a tile; kernels/stream_chunk.py::launch_form picks it.
// p_vpn, p_cci (T_pred, M) and margin (M,) select the forecast-gated instance
// in replay mode; h_in (M, S), pred_in (M,), the forecaster's a, 1 - a, w
// (S,) and bias, scale (M,), coef (M, 4) and margin (M,) the live instance
// (out then (9K + 4, M), h_out (M, S)); null p_vpn and h_in the
// reactive/hysteresis one (T_pred and S are then not read). t0_row and
// hpm_row (M,) select the pooled instance (t0 and hours_per_month are then
// not read; no live mode); null, the call's clock.
extern "C" int stream_chunk_f64(const double* demand, const double* cci_demand,
                                const double* pre_v, const double* pre_c,
                                const double* capacity, const double* L_vpn,
                                const double* lease_cci, const double* c_cci,
                                const double* bounds, const double* rates,
                                const double* theta1, const double* theta2, const int* h,
                                const int* D, const int* T_cci, const int* up_hold,
                                const int* down_hold, const double* cal_in,
                                const int* fsm_in, const double* pref_in,
                                const double* p_vpn, const double* p_cci,
                                const double* margin, const float* h_in,
                                const double* pred_in, const float* ssm_a,
                                const float* ssm_oma, const float* ssm_w,
                                const float* ssm_bias, const double* scale,
                                const double* coef, const int* t0_row,
                                const int* hpm_row, int renew_in_chunks, int t0,
                                int hours_per_month, int K, int M, int Kt, int form,
                                int T_pred, int S, double* out, int* fsm_out, float* h_out,
                                void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || K < 1 || Kt < 0 || t0 < 0 || hours_per_month < 1)
    return (int)cudaErrorInvalidValue;
  const bool gated = p_vpn != nullptr, live = h_in != nullptr, pooled = t0_row != nullptr;
  if (gated && (live || p_cci == nullptr || margin == nullptr || T_pred < 1))
    return (int)cudaErrorInvalidValue;
  if (live && (pred_in == nullptr || ssm_a == nullptr || ssm_oma == nullptr ||
               ssm_w == nullptr || ssm_bias == nullptr || scale == nullptr ||
               coef == nullptr || margin == nullptr || h_out == nullptr || S < 1))
    return (int)cudaErrorInvalidValue;
  if (pooled && (live || hpm_row == nullptr)) return (int)cudaErrorInvalidValue;
  const ChunkArgs a = {demand, cci_demand, pre_v, pre_c, capacity, L_vpn, lease_cci, c_cci,
                       bounds, rates, theta1, theta2, h, D, T_cci, up_hold, down_hold,
                       cal_in, fsm_in, pref_in, p_vpn, p_cci, margin, renew_in_chunks, t0,
                       t0 % hours_per_month, hours_per_month, K, M, Kt, T_pred, out, fsm_out,
                       h_in, pred_in, ssm_a, ssm_oma, ssm_w, ssm_bias, scale, coef, S, h_out,
                       t0_row, hpm_row};
  const cudaStream_t s = (cudaStream_t)stream;
  if (pooled) return gated ? launch<kReplay, true>(a, form, s) : launch<kUngated, true>(a, form, s);
  return gated ? launch<kReplay, false>(a, form, s)
               : live ? launch<kLive, false>(a, form, s) : launch<kUngated, false>(a, form, s);
}
