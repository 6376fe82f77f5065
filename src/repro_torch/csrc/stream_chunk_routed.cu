// The streaming runtime's chunk in topology mode: K hours of every pair and
// port, from the packed host block to the packed result, in one launch.
//
// Replaces: the chunk step of the JAX streaming runtime with topology=True,
// src/repro/fleet/runtime.py::_build_step_many (one jitted dispatch for K
// hours): the pair clip and billing calendar (runtime.py:417-437), the tier
// fold (:446-464; the calendar form of the Pallas kernel
// src/repro/kernels/tiered_cost.py::tiered_cost_scan), the leg fold onto the
// shared ports, vmap(segment_sum) over the K hour planes (:465-484), then the
// prefix snapshots, window sums and FSM per port (:501-515, :577). The fleet
// form of the same chunk (one row per link, no fold) is stream_chunk.cu.
//
// In (flat float64 block, the runtime's _pack layout): demand (P, K), the CCI
// demand (P, K) when the chunk prices the CCI counterfactual on its own
// volume, both pair-major, then the host's pre-chunk window reads pre_v, pre_c
// (K, M). Out: the
// packed float64 result, flat: the planes vpn, cci, r_vpn, r_cci, snap_v,
// snap_c, x, state, (K, M) each, then dcum, dcum_month (P each), then
// vpn_pref, cci_pref (M each); and the FSM carry (4, M) int32.
//
// In the plain version's order (kernels/ref.py::stream_chunk_routed_ref):
//   pair p, hour k:  d = minimum(demand, pair_capacity), dc likewise (or d)
//                    calendar, lo = dcum - dcum_month, vpn_pair = L_vpn + fold(lo, d)
//   port m, hour k:  vpn  = sum over m's legs e, in ascending e, from +0.0,
//                           of vpn_pair[leg_pair[e], k] * vpn_w[e]
//                    bill = minimum(sum of dc[leg_pair[e], k] * attach_w[e], port_capacity)
//                    cci  = lease + c_cci * bill    (lease = L_cci + V_cci * n_attach)
//                    snapshot, window sums, FSM hour, prefix adds (stream_chunk.cu's)
// All float64 arithmetic uses _rn intrinsics and the file is compiled with
// -fmad=false, so every output equals the plain version's bit for bit. The leg
// sums are leg_segment_sum.cu's walk: padding legs (row 0, port 0, zero
// weights) are walked in their place, so a NaN in pair 0 reaches port 0
// (NaN * 0 is NaN) and +0.0 + -0.0 stays +0.0, as in the scatter. No atomics,
// no parallel prefix and no split leg sum: each would change bits.
//
// What bounds it on an H100: at 2048 pairs x K = 24 on 128 ports (2048 legs)
// it must move ~0.93 MB (the block in, the result out, tables, legs and
// carries), 0.28 us at 3.35 TB/s, less than the device time of one launch.
// What a chunk cannot avoid is latency: the chains (a pair's calendar, a
// port's leg sum in leg order, its cost prefixes and FSM) are K or E_m
// dependent adds long, and every chain's operands are a device-memory round
// trip away.
//
// History. The first form (one thread a pair; one warp a port, lane k
// walking hour k's legs through three dependent loads a leg) sat at 232x its
// bound (0.0646 ms at K = 24). The second was two kernels on the
// stream: a pair stage (stream_chunk.cu's 16-pair tile) writing a pair-major
// (P, K) scratch, then a port stage, one block a port, staging up to 128 legs
// through `order` and gathering their scratch rows with cp.async. It took
// 0.0091 ms at K = 24 (pair 0.0029, port 0.0062), the live instance 0.0116:
// two launch floors in series, a port stage whose prologue started only when
// every pair block had drained, four dependent round trips (start, order,
// leg_pair, the scratch) before the first add of the leg fold, seven
// block-wide barriers a tile, the cascade FSM step, and each hour's forecast
// formed twice (two float64 expm1) on the path to the FSM.
//
// Two launches a chunk stay slower on the card even with the port stage as a
// programmatic dependent of the pair stage
// (cudaLaunchAttributeProgrammaticStreamSerialization): on an idle card the
// host's second launch falls in the gap between them, inside the chunk's
// span. So one launch.
//
// Two launch forms, chosen on the host once per routing (RoutingPlan.operand,
// index_legs) from its hottest port and port count: the port-block form, for
// few busy ports, described here, and the small-port form (a warp a port,
// several ports a block), for many ports of few legs, described at
// routed_small_kernel below.
//
// Design of the port-block form: one block of 16 warps a port (128 ports on
// 132 SMs). A port block prices its own legs' pairs: a pair on several legs is priced
// identically by each block that holds it, so the bits stay. It walks the
// chunk in tiles of kTile hours and, in each, its run of the port-major leg
// descriptors (RoutingPlan.operand builds leg_pair, vpn_w and attach_w
// gathered through the stable sort by port, once per routing) in tiles of
// kLegTile legs, with a __syncthreads between the steps:
//   stage (thread j, leg j): one round trip for the leg's pair and weights;
//     its pair's capacity, L_vpn and calendar carry are loaded into registers
//     through the next step (past the first hour tile of a port of more than
//     kLegTile legs, the carry comes from the (2, E) scratch this thread
//     wrote, leg_cal);
//   gather (every thread, one (leg, hour) a copy): the legs' hours of demand
//     (and CCI demand) into shared memory rows with cp.async, from the
//     pair-major block (the runtime packs the demand (P, K) in topology
//     mode, so that consecutive threads copy consecutive words), and the
//     legs' tier rows, padded to a multiple of four tiers;
//   clip (every thread, one (leg, hour)): at the pair's capacity;
//   calendar (thread j): the pair's month-to-date volume before each hour,
//     one add an hour on the chain;
//   fold (every thread, one (leg, hour)): tier_fold.cuh's fold_staged4, then
//     the legs' products (vpn_pair * vpn_w, the billed volume * attach_w and,
//     live with CCI demand, the clipped demand * attach_w) in place;
//   leg fold: lane k of warp 0 adds hour k's VPN cost over the legs in
//     ascending order from shared memory, lane k of warp 1 the attached
//     volume (live with CCI demand, the clipped demand beside it), eight rows
//     loaded while the adds of the last eight run, carrying each sum into the
//     next leg tile.
// Then the port half, on two warps that meet at two named barriers:
//   warp 1 prices the CCI plane and arrives on kBarCost; in the live instance
//     it then steps the forecaster (lane s state s over the tile's hours, in
//     passes of kPassStates states for any S;
//     lane k hour k's input, readout and its one forecast, kept in shared
//     memory, which lane k + 1 reads as the forecast carried into its hour),
//     forms the predicted mode costs of each hour's carried forecast and
//     arrives on kBarGate;
//   warp 0 loaded each hour's window base (and, in replay mode, its predicted
//     costs) at the top of the tile; it waits on kBarCost, runs the cost
//     prefixes on lane 0, the window sums and triggers on lane k (live: after
//     kBarGate), the FSM on lane 0 with fsm_step.cuh's fsm_step_flat, and
//     stores the planes, with only __syncwarp between its phases;
//   warp kCalWarp walks the block's slice of the pairs' calendars over the
//     whole chunk (ceil(P / M) pairs, a lane a pair, 32 at a time) and writes
//     each pair's carry (cal_out) exactly once, whatever legs it has.
// What holds it back (PERF.md): a warp's instructions. One warp issues an
// FP64 or integer instruction at most every other cycle, so each step runs at
// its instruction count: the hottest port's block prices its 95 legs' 24
// hours (gather, clip, tier folds) on one SM, and every block walks a 24-hour
// calendar and a 24-hour FSM on one lane.
//
// Gate modes (the template's G). kUngated: reactive/hysteresis. kReplay, the
// forecast-gated policy in replay mode: warp 0's lanes, one an hour, gate their
// raw triggers with fsm_step.cuh's fsm_gated_triggers on the thresholds
// fsm_gate forms once a port, against the port's predicted mode costs at hour
// min(t0 + k, T_pred - 1) of two hour-major (T_pred, M) planes, loaded at the
// top of the hour tile so that they are in flight during the leg fold. kLive,
// the same policy in live mode (src/repro/fleet/runtime.py:541-575): the
// port's SSM demand forecaster steps inside the chunk (live_forecast.cuh) on
// d_row, the port's clipped pair demand folded with the attachment weights
// in leg order, then minimum'd with the port's capacity (runtime.py:485-488).
// Without endogenous demand that is the billed volume warp 1 folds already;
// with it, warp 1 folds the clipped demand beside the bill. The forecasts
// made after each hour are the result's ninth (K, M) plane (the tail moves
// to 9K).

// The multi-tenant gateway's POOLED instances (the template's PL; kUngated and
// kReplay): a bucket of topology tenants stacked into one call, their legs
// block-diagonal (each slot's pairs and ports a range of their own), each
// with its own clock (src/repro/gateway/gateway.py:402-428). A pair's billing
// calendar starts its months at its own phase: the leg threads read their
// pair's first hour and hours per month beside its capacity (stage_leg), the
// calendar warp its lane's pair's. A port's window bases and replay gate
// column follow its port's first hour, which warp 0 reads beside the
// thresholds. The clocks live in PooledArgs, PooledLegCarry and the
// PairClockOf / PortClockOf locals, which only the PL instances hold: the
// others take RoutedArgs and LegCarry and read the call's clock where they
// did, so their code path is the scalar kernel's as it was, and a pool whose
// rows share one clock gives its bits.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fsm_step.cuh"
#include "live_forecast.cuh"
#include "tier_fold.cuh"

namespace {

constexpr int kTile = 32;                     // hours a tile
constexpr int kThreads = 512;                 // a port block's 16 warps
constexpr int kLegTile = 128;                 // legs a leg tile: one a thread of warps 0..3
constexpr int kMaxSmem = 227 * 1024;
constexpr int kPassStates = 32;               // the live forecaster's states a pass: a lane each
// The gate modes: reactive/hysteresis, forecast-gated in replay mode
// (predicted-cost planes given), forecast-gated in live mode.
constexpr int kUngated = 0, kReplay = 1, kLive = 2;
// Named barriers of warps 0 and 1 (0 is __syncthreads): the CCI plane, and
// (live) the predicted mode costs, handed from warp 1 to warp 0.
constexpr int kBarCost = 1, kBarGate = 2;
constexpr int kBarThreads = 64;
// The warp that walks the block's slice of the pairs' calendars, while warps
// 0 and 1 run the port half of the chunk's first hour tile.
constexpr int kCalWarp = 2;

// The launch's operands (null where the instance reads none).
struct RoutedArgs {
  const double* demand;         // (P, K), pair-major
  const double* cci_demand;     // (P, K) or null
  const double* pre_v;          // (K, M)
  const double* pre_c;
  const double* pair_capacity;  // (P,)
  const double* L_vpn;
  const double* bounds;         // (P, Kt)
  const double* rates;
  const double* lease_cci;      // (M,) L_cci + V_cci * n_attach
  const double* c_cci;
  const double* port_capacity;
  const double* theta1;
  const double* theta2;
  const int* win;
  const int* delay;
  const int* commit;
  const int* up_hold;
  const int* down_hold;
  const int* leg_pair;          // (E,) port-major: each port's legs in ascending leg index
  const double* vpn_w;
  const double* attach_w;
  const int* start;             // (M + 1,) each port's run
  const double* cal_in;         // (2, P) dcum, dcum_month
  const int* fsm_in;            // (4, M)
  const double* pref_in;        // (2, M)
  double* leg_cal;              // (2, E) the legs' calendar carries between hour tiles, or null
  const double* p_vpn;          // (T_pred, M): kReplay only
  const double* p_cci;
  const double* margin;         // (M,)
  const float* h_in;            // (M, S): kLive only
  const double* pred_in;        // (M,)
  const float* ssm_a;           // (S,) a, 1 - a, w; bias ()
  const float* ssm_oma;
  const float* ssm_w;
  const float* ssm_bias;
  const double* scale;          // (M,)
  const double* coef;           // (M, 4)
  int renew_in_chunks, t0, phase0, hours_per_month, K, P, M, E, Kt, T_pred, S;
  int stride;                   // doubles a leg's row of a leg plane: min(K, kTile) | 1
  double* out;                  // planes written, snap rows read back
  int* fsm_out;                 // (4, M)
  float* h_out;                 // (M, S)
};

// The PL instances' operands: the call's, and each pair's and port's clock.
struct PooledArgs : RoutedArgs {
  const int* t0_port;           // (M,) each port's first hour
  const int* hpm_pair;          // (P,) each pair's hours per month
  const int* t0_pair;           // (P,) and first hour
};

template <bool PL>
using ArgsOf = std::conditional_t<PL, PooledArgs, RoutedArgs>;

// A pair's own calendar clock (PL): its month phase at the chunk's first hour
// and its hours per month, read once with its other scalars ({0, 1} for a
// lane with no pair). The others hold none (NoClock).
struct PairClock {
  int phase = 0, hpm = 1;
};
struct NoClock {};

template <bool PL>
using PairClockOf = std::conditional_t<PL, PairClock, NoClock>;
// A port's own first hour (PL).
template <bool PL>
using PortClockOf = std::conditional_t<PL, int, NoClock>;

// The first hour of a port holding t0p: its own in the PL instances, the
// call's, read where it is used, in the others.
template <bool PL>
__device__ __forceinline__ int first_hour(const ArgsOf<PL>& a, const PortClockOf<PL>& t0p) {
  if constexpr (PL) return t0p;
  else return a.t0;
}

__device__ __forceinline__ PairClock pair_clock(const PooledArgs& a, int pr) {
  const int hpm = a.hpm_pair[pr];
  return {a.t0_pair[pr] % hpm, hpm};
}

// The port block's static shared memory: the leg tile's weights and L_vpn,
// and one hour tile's per-hour values of the port half.
struct PortSmem {
  double wv[kLegTile];
  double wa[kLegTile];
  double lvpn[kLegTile];
  double pcap[kLegTile];           // the pairs' capacities (the CCI demand's clip)
  int lp[kLegTile];
  double v[kTile];                 // the hour's VPN and CCI costs
  double c[kTile];
  double sv[kTile];                // prefix snapshots: pref before the hour
  double sc[kTile];
  int trig[kTile];                 // raw triggers: bit 0 request, bit 1 release
  int state[kTile];
};

// kLive: the forecaster's scratch behind the rest of the dynamic shared memory.
struct LiveSmem {
  double coef[4];                  // the port's cost coefficients
  double scale;                    // the forecaster's scale for the port
  float bias;                      // the readout's bias
  // slot k + 1: the forecast made after hour k; slot 0: the one carried into
  // the tile
  double pred[kTile + 1];
  double gv[kTile];                // the predicted mode costs of the forecast carried into hour k
  double gc[kTile];
  float u[kTile];                  // the forecaster's inputs
  float terms[kPassStates][kTile + 1];   // a pass's readout terms, a state a row
};

// Doubles of the dynamic shared memory: the leg planes D (clipped demand),
// LO (month-to-date volume, then vpn_pair) and, with CCI demand, C (clipped
// CCI demand), kLegTile rows of `stride` each; then the tables, a leg's Kt4
// bounds and Kt4 rates a row (Kt rounded up to a multiple of 4, padded with
// tiers of bound -inf: tier_fold.cuh's fold_staged4); then 32 rows of the
// block's slice of the calendars; then, live, LiveSmem.
__host__ __device__ inline size_t plane_doubles(int stride) {
  return (size_t)kLegTile * stride;
}
__host__ __device__ inline size_t table_offset(int stride, bool endo) {
  return (endo ? 3 : 2) * plane_doubles(stride);
}
__host__ __device__ inline int tiers4(int Kt) { return (Kt + 3) / 4 * 4; }
__host__ __device__ inline size_t slice_offset(int stride, bool endo, int Kt) {
  return table_offset(stride, endo) + (size_t)kLegTile * 2 * tiers4(Kt);
}
__host__ __device__ inline size_t live_offset(int stride, bool endo, int Kt) {
  return slice_offset(stride, endo, Kt) + (size_t)32 * stride;
}

// kLive, warp 1: a pass of kPassStates states past the first (S > 32), lane
// l walking state s0 + l's chain through the tile from its state in h_out
// (h_in at the chunk's first tile; the lane reads back its own store), lane
// k folding hour k's terms into acc_y in state order.
__device__ __forceinline__ float live_pass(const RoutedArgs& a, LiveSmem& lsm, int m, int k0,
                                           int len, int s0, int lane, float acc_y) {
  __syncwarp();                                     // the last pass's terms are read
  const int s = s0 + lane;
  if (s < a.S) {
    const int64_t j = (int64_t)m * a.S + s;
    float h = (k0 == 0 ? a.h_in : a.h_out)[j];
    const float as = a.ssm_a[s], bs = a.ssm_oma[s], ws = a.ssm_w[s];
    for (int t = 0; t < len; ++t) lsm.terms[lane][t] = live::ssm_state(h, lsm.u[t], as, bs, ws);
    a.h_out[j] = h;
  }
  __syncwarp();
  if (lane < len) {
    const int ns = min(kPassStates, a.S - s0);
    for (int q = 0; q < ns; ++q) acc_y = __fadd_rn(acc_y, lsm.terms[q][lane]);
  }
  return acc_y;
}

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

template <int G>
__device__ __forceinline__ int64_t tail_at(int64_t KM) {
  return (G == kLive ? 9 : 8) * KM;
}

// The carry of a leg's pair through the chunk: its capacity, L_vpn and
// calendar (before the next hour tile).
struct LegCarry {
  double cap, lvpn, dcum, month;
};

// The PL instances' leg carry: also the pair's clock.
struct PooledLegCarry : LegCarry {
  PairClock ck;
};

template <bool PL>
using CarryOf = std::conditional_t<PL, PooledLegCarry, LegCarry>;

// Thread j of a port block's leg tile, before the block gathers the tile: the
// leg's descriptors into shared memory (one round trip), then its pair's
// scalars into registers, in flight through the gather: the calendar carry
// is the pair's own at the chunk's first hour tile, else this thread's store
// of the last. PL: the pair's clock too.
template <bool PL>
__device__ __forceinline__ CarryOf<PL> stage_leg(const ArgsOf<PL>& a, PortSmem& sm, int s0,
                                                 int j, int k0) {
  const int pos = s0 + j;
  const int pr = a.leg_pair[pos];
  sm.lp[j] = pr;
  sm.wv[j] = a.vpn_w[pos];
  sm.wa[j] = a.attach_w[pos];
  LegCarry c = {a.pair_capacity[pr], a.L_vpn[pr], 0.0, 0.0};
  if (k0 == 0) {
    c.dcum = a.cal_in[pr];
    c.month = a.cal_in[a.P + pr];
  } else {
    c.dcum = a.leg_cal[pos];
    c.month = a.leg_cal[a.E + pos];
  }
  if constexpr (PL) {
    return PooledLegCarry{c, pair_clock(a, pr)};
  } else {
    return c;
  }
}

// Every thread, one (row, hour) a copy: the tile's hours of rows 0..nl - 1
// of a pair-major (P, K) plane into shared memory rows of `stride` doubles
// with cp.async, row l pair pair(l)'s; consecutive threads copy consecutive
// words of a pair's run.
template <typename Pair>
__device__ __forceinline__ void gather_plane(const RoutedArgs& a, const double* src, double* dst,
                                             Pair pair, int tid, int nl, int k0, int len) {
  const int dl = kThreads / len, dk = kThreads - dl * len;
  int l = tid / len, k = tid - l * len;
  for (int o = tid; o < nl * len; o += kThreads) {
    __pipeline_memcpy_async(dst + l * a.stride + k, src + (int64_t)pair(l) * a.K + k0 + k,
                            sizeof(double));
    l += dl;
    k += dk;
    if (k >= len) {
      k -= len;
      ++l;
    }
  }
}

// Every thread: the leg tile's hours of demand (and CCI demand), and its
// pairs' tier rows (a (leg, bounds or rates) a thread, Kt4 words each,
// padding tiers of bound -inf), into shared memory with cp.async, every copy
// issued before any is waited on; the caller waits.
__device__ __forceinline__ void gather_legs(const RoutedArgs& a, double* dyn, const int* lp,
                                            int tid, int nl, int k0, int len) {
  const bool endo = a.cci_demand != nullptr;
  const int st = a.stride, Kt = a.Kt, Kt4 = tiers4(Kt);
  const auto pair = [lp](int l) { return lp[l]; };
  gather_plane(a, a.demand, dyn, pair, tid, nl, k0, len);
  if (endo) gather_plane(a, a.cci_demand, dyn + 2 * plane_doubles(st), pair, tid, nl, k0, len);
  if (tid < 2 * nl) {
    const int l = tid >> 1;
    const double* src = (tid & 1 ? a.rates : a.bounds) + (int64_t)lp[l] * Kt;
    double* row = dyn + table_offset(st, endo) + (size_t)l * 2 * Kt4 + (tid & 1) * Kt4;
    for (int t = 0; t < Kt; ++t) __pipeline_memcpy_async(row + t, src + t, sizeof(double));
    for (int t = Kt; t < Kt4; ++t)                 // padding tiers
      row[t] = tid & 1 ? 0.0 : __longlong_as_double(0xfff0000000000000ULL);   // -inf
  }
  __pipeline_commit();
}

// Every thread, one (row, hour) at a time: clip rows 0..nl - 1 of a plane in
// place at their pairs' capacities.
__device__ __forceinline__ void clip_rows(const RoutedArgs& a, double* plane, const double* cap,
                                          int tid, int nl, int len) {
  const int dl = kThreads / len, dk = kThreads - dl * len;
  int l = tid / len, k = tid - l * len;
  for (int o = tid; o < nl * len; o += kThreads) {
    double* x = plane + l * a.stride + k;
    *x = tier::min_sel(*x, cap[l]);
    l += dl;
    k += dk;
    if (k >= len) {
      k -= len;
      ++l;
    }
  }
}

// Thread j: its pair's calendar over the hour tile [k0, k0 + len) from row j
// of the clipped-demand plane, one add an hour on the chain, the month
// restarting at the tile's month starts (the same hours for every row).
// Leaves the month-to-date volume before each hour in row j of LO, and the
// carry in c. PL: on its pair's own clock, else on the call's.
template <bool PL>
__device__ __forceinline__ void row_calendar(const ArgsOf<PL>& a, double* dyn, CarryOf<PL>& c,
                                             int j, int k0, int len) {
  int hpm, ph0;
  if constexpr (PL) {
    hpm = c.ck.hpm;
    ph0 = (c.ck.phase + k0) % hpm;
  } else {
    hpm = a.hours_per_month;
    ph0 = (a.phase0 + k0) % hpm;
  }
  unsigned starts = 0;                      // bit k: hour k0 + k starts a month
  for (int k = ph0 == 0 ? 0 : hpm - ph0; k < len; k += hpm) starts |= 1u << k;
  const double* drow = dyn + (size_t)j * a.stride;
  double* lrow = dyn + plane_doubles(a.stride) + (size_t)j * a.stride;
  double dcum = c.dcum, month = c.month;
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const double d = drow[k];
    month = (starts >> k) & 1u ? dcum : month;
    lrow[k] = __dsub_rn(dcum, month);
    dcum = __dadd_rn(dcum, d);
  }
  c.dcum = dcum;
  c.month = month;
}

// One warp of block b of nblocks: the calendar carries of its slice of the
// pairs, ceil(P / nblocks) of them, 32 at a time (a lane a pair), each over
// every hour tile of the chunk: the warp copies the pairs' runs of the
// pair-major block into its rows of shared memory (a row a copy's worth of
// words at a time), then each lane clips its row and walks its calendar.
// Each pair's carry is written once, into the result's tail.
// PL: each lane's pair on its own clock, else on the call's.
template <int G, bool PL>
__device__ __forceinline__ void calendar_slice(const ArgsOf<PL>& a, double* rows, int b,
                                               int nblocks, int lane) {
  const int S = (a.P + nblocks - 1) / nblocks;
  const int n_end = min(a.P, (b + 1) * S), st = a.stride;
  [[maybe_unused]] const int hpm_call = a.hours_per_month;
  for (int c0 = b * S; c0 < n_end; c0 += 32) {
    const int nc = min(32, n_end - c0), n = c0 + lane;
    double cap = 0.0, dcum = 0.0, month = 0.0;
    PairClockOf<PL> ck = {};
    if (lane < nc) {
      if constexpr (PL) ck = pair_clock(a, n);
      cap = a.pair_capacity[n];
      dcum = a.cal_in[n];
      month = a.cal_in[a.P + n];
    }
    for (int k0 = 0; k0 < a.K; k0 += kTile) {
      const int len = min(kTile, a.K - k0);
      const double* src = a.demand + (int64_t)c0 * a.K + k0 + lane;
      for (int r = 0; r < nc; ++r)
        if (lane < len) __pipeline_memcpy_async(rows + r * st + lane, src + (int64_t)r * a.K, 8);
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
      if (lane < nc) {
        int hpm, ph0;
        if constexpr (PL) {
          hpm = ck.hpm;
          ph0 = (ck.phase + k0) % hpm;
        } else {
          hpm = hpm_call;
          ph0 = (a.phase0 + k0) % hpm;
        }
        unsigned starts = 0;                  // bit k: hour k0 + k starts a month
        for (int k = ph0 == 0 ? 0 : hpm - ph0; k < len; k += hpm) starts |= 1u << k;
        const double* row = rows + lane * st;
#pragma unroll 8
        for (int k = 0; k < len; ++k) {
          const double d = tier::min_sel(row[k], cap);
          month = (starts >> k) & 1u ? dcum : month;
          dcum = __dadd_rn(dcum, d);
        }
      }
      __syncwarp();                             // the rows are copied over again
    }
    if (lane < nc) {
      double* cal_out = a.out + tail_at<G>((int64_t)a.K * a.M);
      cal_out[n] = dcum;
      cal_out[a.P + n] = month;
    }
  }
}

// acc plus col[0], col[st], ..., col[(n - 1) st] in that order, each add on
// the chain: whole groups of eight words loaded while the adds of the last
// group run, then the rest one at a time.
__device__ __forceinline__ double fold_column(const double* col, int st, int n, double acc) {
  const int n8 = n & ~7;
  const int st8 = 8 * st;
  double x[8];
  if (n8 > 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = col[q * st];
  }
  const double* p = col;
  for (int l = 8; l < n8; l += 8) {
    p += st8;
    double y[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) y[q] = p[q * st];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      acc = __dadd_rn(acc, x[q]);
      x[q] = y[q];
    }
  }
  if (n8 > 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc = __dadd_rn(acc, x[q]);
  }
  for (int l = n8; l < n; ++l) acc = __dadd_rn(acc, col[l * st]);
  return acc;
}

template <int G, bool PL>
__global__ void __launch_bounds__(kThreads)
routed_chunk_kernel(const ArgsOf<PL> a) {
  __shared__ PortSmem sm;
  extern __shared__ __align__(16) double dyn[];   // the leg planes, the tables, LiveSmem
  const int m = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (a.M == 0) {                          // no ports: the calendars alone
    if (warp == kCalWarp)
      calendar_slice<G, PL>(a, dyn + slice_offset(a.stride, false, a.Kt), 0, 1, lane);
    return;
  }
  const int M = a.M, K = a.K, st = a.stride;
  const int64_t KM = (int64_t)K * M;
  const bool endo = a.cci_demand != nullptr;
  const int e0 = a.start[m], e1 = a.start[m + 1];
  const double* D = dyn;
  const double* LO = dyn + plane_doubles(st);
  const double* C = endo ? LO + plane_doubles(st) : D;   // the plane the bill folds
  [[maybe_unused]] LiveSmem* lsm =
      reinterpret_cast<LiveSmem*>(dyn + live_offset(st, endo, a.Kt));

  // Warp 0: the window sums, gates, prefixes (lane 0) and FSM (lane 0).
  fsm::FsmRow p = {};
  [[maybe_unused]] fsm::FsmGate g = {};
  int h = 0;
  PortClockOf<PL> t0p = {};                // PL: the port's first hour
  double pv = 0.0, pc = 0.0;
  fsm::FsmCarry fc = {};
  // Warp 1: the CCI plane and, live, the forecaster.
  double lease = 0.0, cc = 0.0, pcap = 0.0;
  [[maybe_unused]] float hs = 0.0f, sa = 0.0f, sb = 0.0f, sw = 0.0f;
  if (warp == 0) {
    p = {a.theta1[m], a.theta2[m], a.delay[m], a.commit[m], a.up_hold[m], a.down_hold[m],
         a.renew_in_chunks != 0};
    h = a.win[m];
    if constexpr (PL) t0p = a.t0_port[m];
    if constexpr (G != kUngated) g = fsm::fsm_gate(p, a.margin[m]);
    if (lane == 0) {
      pv = a.pref_in[m];
      pc = a.pref_in[M + m];
      fc = {a.fsm_in[m], a.fsm_in[M + m], a.fsm_in[2 * M + m], a.fsm_in[3 * M + m], 0};
      fc.phase = fc.t_state % p.T_cci;
    }
  } else if (warp == 1) {
    lease = a.lease_cci[m];
    cc = a.c_cci[m];
    pcap = a.port_capacity[m];
    if constexpr (G == kLive) {
      if (lane < 4) lsm->coef[lane] = a.coef[4 * (int64_t)m + lane];
      if (lane == 0) {
        lsm->scale = a.scale[m];
        lsm->bias = a.ssm_bias[0];
        lsm->pred[0] = a.pred_in[m];        // the forecast carried into the first tile
      }
      if (lane < a.S) {
        sa = a.ssm_a[lane];
        sb = a.ssm_oma[lane];
        sw = a.ssm_w[lane];
        hs = a.h_in[(int64_t)m * a.S + lane];
      }
    }
  }

  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    if (k0 > 0) __syncthreads();   // the last tile's port half is done; its snapshots are visible
    const int k = k0 + lane;                        // lane's hour, warps 0 and 1
    const int64_t i = (int64_t)k * M + m;
    // warp 0: the hour's window base (when older than the tile) and, replay,
    // its predicted costs, in flight through the leg tiles
    int lw = 0;
    double bv = 0.0, bc = 0.0;
    [[maybe_unused]] double gv = 0.0, gc = 0.0;
    if (warp == 0 && lane < len) {
      const int t0 = first_hour<PL>(a, t0p);
      lw = max(0, t0 + k - h);
      if (lw < t0) {                                // before the chunk: the host's read
        bv = a.pre_v[i];
        bc = a.pre_c[i];
      } else if (lw < t0 + k0) {                    // an earlier tile's snapshot
        const int64_t j = (int64_t)(lw - t0) * M + m;
        bv = a.out[4 * KM + j];
        bc = a.out[5 * KM + j];
      }
      if constexpr (G == kReplay) {
        const int64_t j = (int64_t)min(t0 + k, a.T_pred - 1) * M + m;
        gv = a.p_vpn[j];
        gc = a.p_cci[j];
      }
    }

    // The legs, a tile at a time: warp 0's lane k sums hour k's VPN cost,
    // warp 1's its attached volume (and, live with CCI demand, the clipped
    // demand), in ascending leg index from +0.0.
    double acc = 0.0;
    [[maybe_unused]] double acc_d = 0.0;
    for (int s0 = e0; s0 < e1; s0 += kLegTile) {
      const int nl = min(kLegTile, e1 - s0);
      if (s0 > e0) __syncthreads();                 // the last leg tile's sums are done
      CarryOf<PL> lc = {};
      if (tid < nl) lc = stage_leg<PL>(a, sm, s0, tid, k0);
      __syncthreads();
      gather_legs(a, dyn, sm.lp, tid, nl, k0, len);
      if (tid < nl) {
        sm.lvpn[tid] = lc.lvpn;
        sm.pcap[tid] = lc.cap;
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      clip_rows(a, dyn, sm.pcap, tid, nl, len);
      if (endo) clip_rows(a, dyn + 2 * plane_doubles(st), sm.pcap, tid, nl, len);
      __syncthreads();
      if (tid < nl) {
        row_calendar<PL>(a, dyn, lc, tid, k0, len);
        if (k0 + len < K) {                         // read back in the next hour tile
          a.leg_cal[s0 + tid] = lc.dcum;
          a.leg_cal[a.E + s0 + tid] = lc.month;
        }
      }
      __syncthreads();
      // Every thread, one (leg, hour) at a time: the tier fold, then the
      // legs' products, each in place of an operand it alone reads: LO takes
      // vpn_pair * vpn_w, C (or D) the billed volume * attach_w, and, live
      // with CCI demand, D the clipped demand * attach_w.
      {
        const int Kt4 = tiers4(a.Kt), dl = kThreads / len, dk = kThreads - dl * len;
        const double* tabs = dyn + table_offset(st, endo);
        int l = tid / len, kk = tid - l * len;
        for (int o = tid; o < nl * len; o += kThreads) {
          const int e = l * st + kk;
          const double d = D[e];
          const double* row = tabs + (size_t)l * 2 * Kt4;
          const double transfer = Kt4 == 4 ? tier::fold_staged4(LO[e], d, row, 4)
                                           : tier::fold_staged4(LO[e], d, row, Kt4);
          const double wa = sm.wa[l];
          dyn[plane_doubles(st) + e] = __dmul_rn(__dadd_rn(sm.lvpn[l], transfer), sm.wv[l]);
          if (endo) {
            dyn[2 * plane_doubles(st) + e] = __dmul_rn(C[e], wa);
            if (G == kLive) dyn[e] = __dmul_rn(d, wa);
          } else {
            dyn[e] = __dmul_rn(d, wa);
          }
          l += dl;
          kk += dk;
          if (kk >= len) {
            kk -= len;
            ++l;
          }
        }
      }
      __syncthreads();
      // warp 0's lane k: hour k's VPN cost over the legs in ascending order;
      // warp 1's: its attached volume (live with CCI demand, the clipped
      // demand beside it: two independent chains)
      if (warp == 0 && lane < len) {
        acc = fold_column(LO + lane, st, nl, acc);
      } else if (warp == 1 && lane < len) {
        acc = fold_column(C + lane, st, nl, acc);
        if (G == kLive && endo) acc_d = fold_column(D + lane, st, nl, acc_d);
      }
    }

    if (warp == 1) {
      // ---- the CCI plane, then (live) the forecaster and the gates' costs
      [[maybe_unused]] double drow = 0.0;
      if (lane < len) {
        const double bill = tier::min_sel(acc, pcap);
        const double c = __dadd_rn(lease, __dmul_rn(cc, bill));
        sm.c[lane] = c;
        a.out[KM + i] = c;
        drow = endo ? tier::min_sel(acc_d, pcap) : bill;
      }
      bar_arrive(kBarCost);
      if constexpr (G == kLive) {
        if (lane < len) lsm->u[lane] = live::ssm_input(drow, lsm->scale);
        __syncwarp();
        if (lane < a.S) {                           // lane s walks state s's chain
          float* pt = lsm->terms[lane];
#pragma unroll 8
          for (int j = 0; j < len; ++j) pt[j] = live::ssm_state(hs, lsm->u[j], sa, sb, sw);
        }
        __syncwarp();
        float acc_y = 0.0f;
        if (lane < len) {                           // hour k's terms, left from state 0
          acc_y = lsm->terms[0][lane];
          const int ns = min(kPassStates, a.S);
#pragma unroll 4
          for (int s = 1; s < ns; ++s) acc_y = __fadd_rn(acc_y, lsm->terms[s][lane]);
        }
        for (int s0 = kPassStates; s0 < a.S; s0 += kPassStates)   // past one pass of states
          acc_y = live_pass(a, *lsm, m, k0, len, s0, lane, acc_y);
        if (lane < len) {                           // hour k's readout and its one forecast
          const double pred = live::prediction(
              live::ssm_readout(lsm->u[lane], acc_y, lsm->bias), lsm->scale);
          lsm->pred[lane + 1] = pred;
          a.out[8 * KM + i] = pred;
        }
        __syncwarp();
        if (lane < len) {                           // the costs of the forecast carried in
          double lv, lc;
          live::mode_costs(lsm->pred[lane], lsm->coef, lv, lc);
          lsm->gv[lane] = lv;
          lsm->gc[lane] = lc;
        }
        __syncwarp();
        if (lane == 0) lsm->pred[0] = lsm->pred[len];   // carried into the next tile
        bar_arrive(kBarGate);
      }
    } else if (warp == 0) {
      // ---- the VPN plane, prefixes, window sums, gates, FSM
      if (lane < len) {
        sm.v[lane] = acc;
        a.out[i] = acc;
      }
      bar_wait(kBarCost);
      if (lane == 0) {                              // the cost prefixes' snapshots
#pragma unroll 8
        for (int j = 0; j < len; ++j) {
          sm.sv[j] = pv;
          sm.sc[j] = pc;
          pv = __dadd_rn(pv, sm.v[j]);
          pc = __dadd_rn(pc, sm.c[j]);
        }
      }
      __syncwarp();
      bool raw_req = false, raw_rel = false;
      double rv = 0.0, rc = 0.0, sv = 0.0, sc = 0.0;
      if (lane < len) {                             // window sums and raw triggers
        const int t0 = first_hour<PL>(a, t0p);
        const bool in_tile = lw >= t0 + k0;         // a snapshot of its own tile
        const int j = in_tile ? lw - t0 - k0 : lane;
        sv = sm.sv[lane];
        sc = sm.sc[lane];
        rv = __dsub_rn(sv, in_tile ? sm.sv[j] : bv);
        rc = __dsub_rn(sc, in_tile ? sm.sc[j] : bc);
        fsm::fsm_triggers(p, rv, rc, raw_req, raw_rel);
        if constexpr (G == kReplay) fsm::fsm_gated_triggers(g, gv, gc, raw_req, raw_rel);
      }
      if constexpr (G == kLive) {
        bar_wait(kBarGate);
        if (lane < len) fsm::fsm_gated_triggers(g, lsm->gv[lane], lsm->gc[lane], raw_req, raw_rel);
      }
      if (lane < len) {
        sm.trig[lane] = (int)raw_req | (int)raw_rel << 1;
        a.out[2 * KM + i] = rv;
        a.out[3 * KM + i] = rc;
        a.out[4 * KM + i] = sv;
        a.out[5 * KM + i] = sc;
      }
      __syncwarp();
      if (lane == 0) {                              // the FSM, integers only
#pragma unroll 8
        for (int j = 0; j < len; ++j) {
          const int t = sm.trig[j];
          sm.state[j] = fsm::fsm_step_flat(p, fc, t & 1, t >> 1, p.renew_in_chunks);
        }
      }
      __syncwarp();
      if (lane < len) {
        const int s = sm.state[lane];
        a.out[6 * KM + i] = s == fsm::kOn ? 1.0 : 0.0;
        a.out[7 * KM + i] = (double)s;
      }
    } else if (warp == kCalWarp && k0 == 0) {      // the block's slice of the calendars
      calendar_slice<G, PL>(a, dyn + slice_offset(st, endo, a.Kt), m, M, lane);
    }
  }

  const int64_t tail = tail_at<G>(KM) + 2 * (int64_t)a.P;
  if (tid == 0) {
    a.out[tail + m] = pv;
    a.out[tail + M + m] = pc;
    a.fsm_out[m] = fc.state;
    a.fsm_out[M + m] = fc.t_state;
    a.fsm_out[2 * M + m] = fc.up;
    a.fsm_out[3 * M + m] = fc.down;
  }
  if constexpr (G == kLive) {
    if (warp == 1 && lane < a.S) a.h_out[(int64_t)m * a.S + lane] = hs;
  }
}

// The launch in gate mode G and clocks PL: a block a port (one when there is
// none).
template <int G, bool PL>
int launch(const ArgsOf<PL>& a, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_chunk_kernel<G, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  routed_chunk_kernel<G, PL><<<a.M > 0 ? a.M : 1, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// ---- The small-port form ----------------------------------------------------
//
// The gateway's topology buckets are many small ports: 256 slots x 8 ports
// hold 2048 ports of 0-12 legs. The port-block form gives each a block of
// 512 threads, one block an SM, in 16 waves, and each block's time is its
// chains, not its work (a 4-leg port is 96 (leg, hour) cells, walked through
// seven block-wide barriers a tile). This form gives each port one warp and
// puts kSmallPorts ports in a block, so that such a bucket is resident in
// one wave, and runs the chains that are one lane long (the cost prefixes,
// the window sums and triggers, the FSM) for the block's ports at once, a
// lane a port, so that they take one warp's issue slots, not kSmallPorts. A port holds at
// most kSmallLegs legs, one a lane; the host picks this form from the
// routing's hottest port and port count (RoutingPlan.operand, index_legs;
// kernels/stream_chunk.py::routed_form) and passes the hottest port's legs,
// legs_cap, which sizes the warps' planes. Over each hour tile of kTile
// hours, port warp w in its own slice of the dynamic shared memory:
//   rows: lane j < nl is leg j's pair, the next lanes the first of the port's
//     slice of the pairs' calendars (calendar_slice's ceil(P / M) pairs), as
//     many as the planes' `rows` hold; each lane keeps its row's calendar
//     carry in registers for the whole chunk (no leg_cal scratch), and the
//     legs' weights, L_vpn and tier rows (padded to a multiple of four tiers)
//     are staged once a chunk;
//   bases: lane k stages hour k's window base when it is older than the tile
//     (the host's read or an earlier tile's snapshot) and, replay, its gate
//     column min(t0_port + k, T_pred - 1);
//   gather: lane k copies hour k of every row's demand (and, for the legs,
//     CCI demand) into the planes with cp.async, coalesced along hours, and
//     clips it at the row's pair capacity;
//   calendar: lane j walks row j's calendar, one add an hour, leaving the
//     month-to-date volume before each hour in LO;
//   fold: every lane, one (leg, hour) cell at a time, folds the cell's tiers
//     (tier_fold.cuh's fold_staged4) and forms the leg's two products in
//     place, as the port-block form's block does; then lane k adds hour k's
//     VPN costs and billed volumes over the legs in ascending order, each sum
//     from +0.0 (fold_column), and prices hour k's CCI plane.
// Then, after a barrier, warp 0's lane p walks port p's hours: the VPN and
// CCI planes, the prefix snapshot and add, the window sums and triggers
// (gated in replay mode) and fsm_step_flat, and stores the hour's eight
// planes (consecutive ports in consecutive lanes); a second barrier frees
// the tile's shared hour arrays. The slice pairs that do not fit the rows
// are walked last, a lane a pair, straight from device memory; each pair's
// carry is written once, by its slice's port, as in the port-block form.
// The arithmetic is the port-block form's operation for operation (the same
// clips, calendar adds, folds, products, left folds in leg order, prefixes,
// window sums, triggers and FSM steps; padding legs walked in their place),
// so both forms give the plain version's bits. No live instance: the gateway
// refuses live tenants, and a live stream keeps the port-block form.
constexpr int kSmallLegs = 32;                // a port's legs at most: a lane each
constexpr int kSmallPorts = 8;                // port warps a block (a sweep on the H100: 1-8)
constexpr int kHourArrays = 8;                // a port's per-hour arrays of a tile

// One port warp's slice of the dynamic shared memory, in doubles: the hour
// planes D (clipped demand), LO (month-to-date volume) and, with CCI demand,
// C, `rows` rows of `stride` each; the legs' tier rows (Kt4 bounds, Kt4
// rates); their vpn_w, attach_w, L_vpn; the rows' pair capacities; the
// tile's per-hour arrays (the hour's VPN and CCI costs, window bases and
// gate columns, prefix snapshots: kTile each); then the rows' pairs (32 ints).
struct SmallLayout {
  int rows, legs, planes, stride, Kt4;
  __host__ __device__ size_t plane() const { return (size_t)rows * stride; }
  __host__ __device__ size_t tab() const { return planes * plane(); }
  __host__ __device__ size_t wts() const { return tab() + (size_t)legs * 2 * Kt4; }
  __host__ __device__ size_t caps() const { return wts() + 3 * (size_t)legs; }
  __host__ __device__ size_t hours() const { return caps() + rows; }
  __host__ __device__ size_t ints() const { return hours() + kHourArrays * kTile; }
  __host__ __device__ size_t doubles() const { return ints() + 32 / 2; }
};

// A port's per-hour arrays of a tile (SmallLayout::hours).
struct HourArrays {
  double *v, *c, *bv, *bc, *gv, *gc, *sv, *sc;
  __device__ explicit HourArrays(double* p)
      : v(p), c(p + kTile), bv(p + 2 * kTile), bc(p + 3 * kTile), gv(p + 4 * kTile),
        gc(p + 5 * kTile), sv(p + 6 * kTile), sc(p + 7 * kTile) {}
};

// The calendar carries of pairs [c_begin, c_end) of a port's slice that its
// rows did not hold: a lane a pair, 32 at a time, each over every hour tile
// of the chunk straight from the pair-major block; each carry written once.
template <int G, bool PL>
__device__ __forceinline__ void small_slice_rest(const ArgsOf<PL>& a, int c_begin, int c_end,
                                                 int lane) {
  double* cal_out = a.out + tail_at<G>((int64_t)a.K * a.M);
  for (int c0 = c_begin; c0 < c_end; c0 += 32) {
    const int n = c0 + lane;
    if (n >= c_end) break;
    PairClockOf<PL> ck = {};
    if constexpr (PL) ck = pair_clock(a, n);
    const double cap = a.pair_capacity[n];
    double dcum = a.cal_in[n], month = a.cal_in[a.P + n];
    const double* row = a.demand + (int64_t)n * a.K;
    for (int k0 = 0; k0 < a.K; k0 += kTile) {
      const int len = min(kTile, a.K - k0);
      int hpm, ph0;
      if constexpr (PL) {
        hpm = ck.hpm;
        ph0 = (ck.phase + k0) % hpm;
      } else {
        hpm = a.hours_per_month;
        ph0 = (a.phase0 + k0) % hpm;
      }
      unsigned starts = 0;                      // bit k: hour k0 + k starts a month
      for (int k = ph0 == 0 ? 0 : hpm - ph0; k < len; k += hpm) starts |= 1u << k;
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        const double d = tier::min_sel(row[k0 + k], cap);
        month = (starts >> k) & 1u ? dcum : month;
        dcum = __dadd_rn(dcum, d);
      }
    }
    cal_out[n] = dcum;
    cal_out[a.P + n] = month;
  }
}

template <int G, bool PL>
__global__ void __launch_bounds__(32 * kSmallPorts, 2)
routed_small_kernel(const ArgsOf<PL> a, int legs_cap, int rows) {
  extern __shared__ __align__(16) double dyn[];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  constexpr int W = kSmallPorts;
  const int m = blockIdx.x * W + w;                     // warp w's port
  const bool active = m < a.M;
  const int M = a.M, K = a.K, st = a.stride, Kt4 = tiers4(a.Kt);
  const int64_t KM = (int64_t)K * M;
  const bool endo = a.cci_demand != nullptr;
  const SmallLayout lay = {rows, legs_cap, endo ? 3 : 2, st, Kt4};
  double* base = dyn + (size_t)w * lay.doubles();
  double* Dp = base;
  double* LO = base + lay.plane();
  double* Cp = endo ? LO + lay.plane() : Dp;            // the plane the bill folds
  double* tab = base + lay.tab();
  double* wv = base + lay.wts();
  double* wa = wv + legs_cap;
  double* lv = wa + legs_cap;
  double* capr = base + lay.caps();
  const HourArrays hr(base + lay.hours());
  int* rp = reinterpret_cast<int*>(base + lay.ints());  // the rows' pairs

  // warp w: its port's legs and slice of the calendars, and lane j's row
  // (leg j's pair, or a slice pair) with its carry in registers
  int e0 = 0, nl = 0, c0 = 0, c1 = 0;
  int h = 0;
  PortClockOf<PL> t0p = {};
  double lease = 0.0, cc = 0.0, pcap = 0.0;
  if (active) {
    e0 = a.start[m];
    nl = a.start[m + 1] - e0;
    if (nl > legs_cap) __trap();                        // the host's hottest port is wrong
    const int S = (a.P + M - 1) / M;
    c0 = min(a.P, m * S);
    c1 = min(a.P, c0 + S);
    h = a.win[m];
    if constexpr (PL) t0p = a.t0_port[m];
    lease = a.lease_cci[m];
    cc = a.c_cci[m];
    pcap = a.port_capacity[m];
  }
  const int nm = min(c1 - c0, rows - nl), nrows = nl + nm;
  int pr = 0;
  double dcum = 0.0, month = 0.0;
  PairClockOf<PL> ck = {};
  if (lane < nl) {
    const int pos = e0 + lane;
    pr = a.leg_pair[pos];
    wv[lane] = a.vpn_w[pos];
    wa[lane] = a.attach_w[pos];
  } else if (lane < nrows) {
    pr = c0 + lane - nl;
  }
  if (lane < nrows) {
    rp[lane] = pr;
    capr[lane] = a.pair_capacity[pr];
    dcum = a.cal_in[pr];
    month = a.cal_in[a.P + pr];
    if constexpr (PL) ck = pair_clock(a, pr);
    if (lane < nl) lv[lane] = a.L_vpn[pr];
  }
  // warp 0's lane p: port q = blockIdx.x * W + p's FSM, window and carries
  const int q = blockIdx.x * W + lane;
  const bool runs = w == 0 && lane < W && q < M;
  fsm::FsmRow fp = {};
  [[maybe_unused]] fsm::FsmGate g = {};
  fsm::FsmCarry fc = {};
  double pv = 0.0, pc = 0.0;
  int hq = 0;
  PortClockOf<PL> t0q = {};
  if (runs) {
    fp = {a.theta1[q], a.theta2[q], a.delay[q], a.commit[q], a.up_hold[q], a.down_hold[q],
          a.renew_in_chunks != 0};
    hq = a.win[q];
    if constexpr (PL) t0q = a.t0_port[q];
    if constexpr (G != kUngated) g = fsm::fsm_gate(fp, a.margin[q]);
    pv = a.pref_in[q];
    pc = a.pref_in[M + q];
    fc = {a.fsm_in[q], a.fsm_in[M + q], a.fsm_in[2 * M + q], a.fsm_in[3 * M + q], 0};
    fc.phase = fc.t_state % fp.T_cci;
  }
  __syncwarp();
  // the legs' tier rows, once a chunk (committed with the first tile's gather)
  for (int o = lane; o < nl * 2 * Kt4; o += 32) {
    const int l = o / (2 * Kt4), t = o - l * 2 * Kt4;
    const bool rate = t >= Kt4;
    const int qt = rate ? t - Kt4 : t;
    double* dst = tab + (size_t)l * 2 * Kt4 + t;
    if (qt < a.Kt)
      __pipeline_memcpy_async(dst, (rate ? a.rates : a.bounds) + (int64_t)rp[l] * a.Kt + qt,
                              sizeof(double));
    else                                                // padding tiers
      *dst = rate ? 0.0 : __longlong_as_double(0xfff0000000000000ULL);   // -inf
  }

  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    if (active) {
      if (lane < len) {
        // lane k: hour k's window base when older than the tile, and (replay)
        // its predicted costs, then hour k of every row
        const int k = k0 + lane;
        const int64_t i = (int64_t)k * M + m;
        const int t0 = first_hour<PL>(a, t0p);
        const int lw = max(0, t0 + k - h);
        double bv = 0.0, bc = 0.0;
        if (lw < t0) {                                  // before the chunk: the host's read
          bv = a.pre_v[i];
          bc = a.pre_c[i];
        } else if (lw < t0 + k0) {                      // an earlier tile's snapshot
          const int64_t j = (int64_t)(lw - t0) * M + m;
          bv = a.out[4 * KM + j];
          bc = a.out[5 * KM + j];
        }
        hr.bv[lane] = bv;
        hr.bc[lane] = bc;
        if constexpr (G == kReplay) {
          const int64_t j = (int64_t)min(t0 + k, a.T_pred - 1) * M + m;
          hr.gv[lane] = a.p_vpn[j];
          hr.gc[lane] = a.p_cci[j];
        }
        for (int r = 0; r < nrows; ++r) {
          const int64_t src = (int64_t)rp[r] * K + k;
          __pipeline_memcpy_async(Dp + r * st + lane, a.demand + src, sizeof(double));
          if (endo && r < nl)
            __pipeline_memcpy_async(Cp + r * st + lane, a.cci_demand + src, sizeof(double));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      if (lane < len) {                                 // lane k: hour k of every row, clipped
        for (int r = 0; r < nrows; ++r) {
          double* x = Dp + r * st + lane;
          *x = tier::min_sel(*x, capr[r]);
          if (endo && r < nl) {
            double* y = Cp + r * st + lane;
            *y = tier::min_sel(*y, capr[r]);
          }
        }
      }
      __syncwarp();
      if (lane < nrows) {                               // lane j: row j's calendar
        int hpm, ph0;
        if constexpr (PL) {
          hpm = ck.hpm;
          ph0 = (ck.phase + k0) % hpm;
        } else {
          hpm = a.hours_per_month;
          ph0 = (a.phase0 + k0) % hpm;
        }
        unsigned starts = 0;                            // bit k: hour k0 + k starts a month
        for (int kk = ph0 == 0 ? 0 : hpm - ph0; kk < len; kk += hpm) starts |= 1u << kk;
        const double* drow = Dp + lane * st;
        double* lrow = LO + lane * st;
#pragma unroll 8
        for (int kk = 0; kk < len; ++kk) {
          const double d = drow[kk];
          month = (starts >> kk) & 1u ? dcum : month;
          lrow[kk] = __dsub_rn(dcum, month);
          dcum = __dadd_rn(dcum, d);
        }
      }
      __syncwarp();
      {
        // every lane, one (leg, hour) cell at a time: the tier fold, then the
        // legs' products, each in place of an operand it alone reads: LO takes
        // vpn_pair * vpn_w, C (or D) the billed volume * attach_w
        const int dl = 32 / len, dk = 32 - dl * len;
        int j = lane / len, kk = lane - j * len;
        for (int o = lane; o < nl * len; o += 32) {
          const int e = j * st + kk;
          const double d = Dp[e];
          const double* row = tab + (size_t)j * 2 * Kt4;
          const double transfer = Kt4 == 4 ? tier::fold_staged4(LO[e], d, row, 4)
                                           : tier::fold_staged4(LO[e], d, row, Kt4);
          LO[e] = __dmul_rn(__dadd_rn(lv[j], transfer), wv[j]);
          Cp[e] = __dmul_rn(endo ? Cp[e] : d, wa[j]);
          j += dl;
          kk += dk;
          if (kk >= len) {
            kk -= len;
            ++j;
          }
        }
      }
      __syncwarp();
      if (lane < len) {
        // lane k: hour k's VPN cost and billed volume over the legs in
        // ascending order, each from +0.0, and its CCI cost
        hr.v[lane] = fold_column(LO + lane, st, nl, 0.0);
        const double bill = tier::min_sel(fold_column(Cp + lane, st, nl, 0.0), pcap);
        hr.c[lane] = __dadd_rn(lease, __dmul_rn(cc, bill));
      }
    }
    __syncthreads();          // every port's hour costs, bases and gate columns are staged
    if (runs) {
      // lane p: port q's hours in order: planes, prefixes, window sums,
      // triggers and the FSM
      const HourArrays qr(dyn + (size_t)lane * lay.doubles() + lay.hours());
      const int t0 = first_hour<PL>(a, t0q);
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const int64_t i = (int64_t)(k0 + j) * M + q;
        const double v = qr.v[j], c = qr.c[j];
        const double sv = pv, sc = pc;
        qr.sv[j] = sv;
        qr.sc[j] = sc;
        pv = __dadd_rn(pv, v);
        pc = __dadd_rn(pc, c);
        const int lw = max(0, t0 + k0 + j - hq);
        const bool in_tile = lw >= t0 + k0;             // a snapshot of this tile
        const int jb = in_tile ? lw - t0 - k0 : j;
        const double rv = __dsub_rn(sv, in_tile ? qr.sv[jb] : qr.bv[j]);
        const double rc = __dsub_rn(sc, in_tile ? qr.sc[jb] : qr.bc[j]);
        bool raw_req, raw_rel;
        fsm::fsm_triggers(fp, rv, rc, raw_req, raw_rel);
        if constexpr (G == kReplay) fsm::fsm_gated_triggers(g, qr.gv[j], qr.gc[j], raw_req, raw_rel);
        const int s = fsm::fsm_step_flat(fp, fc, raw_req, raw_rel, fp.renew_in_chunks);
        a.out[i] = v;
        a.out[KM + i] = c;
        a.out[2 * KM + i] = rv;
        a.out[3 * KM + i] = rc;
        a.out[4 * KM + i] = sv;
        a.out[5 * KM + i] = sc;
        a.out[6 * KM + i] = s == fsm::kOn ? 1.0 : 0.0;
        a.out[7 * KM + i] = (double)s;
      }
    }
    __syncthreads();          // the tile's hour arrays are read; its snapshots are stored
  }

  if (active) {
    double* cal_out = a.out + tail_at<G>(KM);
    if (lane >= nl && lane < nrows) {                   // the slice pairs the rows held
      cal_out[pr] = dcum;
      cal_out[a.P + pr] = month;
    }
    small_slice_rest<G, PL>(a, c0 + nm, c1, lane);
  }
  if (runs) {
    const int64_t tail = tail_at<G>(KM) + 2 * (int64_t)a.P;
    a.out[tail + q] = pv;
    a.out[tail + M + q] = pc;
    a.fsm_out[q] = fc.state;
    a.fsm_out[M + q] = fc.t_state;
    a.fsm_out[2 * M + q] = fc.up;
    a.fsm_out[3 * M + q] = fc.down;
  }
}

// The small-port form's launch in gate mode G and clocks PL: kSmallPorts port
// warps a block.
template <int G, bool PL>
int launch_small(const ArgsOf<PL>& a, int legs_cap, int rows, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_small_kernel<G, PL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (a.M + kSmallPorts - 1) / kSmallPorts;
  routed_small_kernel<G, PL><<<blocks, 32 * kSmallPorts, smem, s>>>(a, legs_cap, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// leg_cal: 2 E float64, the legs' calendar carries between hour tiles (may be
// null when K <= kTile). out: 8 K M + 2 P + 2 M float64 (9 K M + ... in a live
// call). leg_pair, vpn_w, attach_w: the legs in port-major order (LegIndex's
// leg_pair_pm, vpn_w_pm, attach_w_pm), start (M + 1,) each port's run. All
// pointers contiguous on one device. p_vpn, p_cci (T_pred, M) and margin (M,)
// select the forecast-gated instance in replay mode; h_in (M, S), pred_in
// (M,), the forecaster's a, 1 - a, w (S,) and bias, scale (M,), coef (M, 4)
// and margin (M,) its live instance (h_out (M, S)); null p_vpn and h_in the
// reactive/hysteresis one. t0_port (M,), hpm_pair and t0_pair (P,) select the
// pooled instance (t0 and hours_per_month are then not read; no live mode).
// small_port != 0 selects the small-port form, each port holding at most
// legs_cap legs (the routing's hottest port, at most kSmallLegs; no live mode;
// leg_cal is not read; the host chooses it only where its shared memory
// fits); 0 the port-block form (legs_cap is then not read).
extern "C" int stream_chunk_routed_f64(
    const double* demand, const double* cci_demand, const double* pre_v, const double* pre_c,
    const double* pair_capacity, const double* L_vpn, const double* bounds, const double* rates,
    const double* lease_cci, const double* c_cci, const double* port_capacity,
    const double* theta1, const double* theta2, const int* h, const int* D, const int* T_cci,
    const int* up_hold, const int* down_hold,
    const int* leg_pair, const double* vpn_w, const double* attach_w, const int* start,
    const double* cal_in, const int* fsm_in, const double* pref_in, double* leg_cal,
    const double* p_vpn, const double* p_cci, const double* margin,
    const float* h_in, const double* pred_in, const float* ssm_a, const float* ssm_oma,
    const float* ssm_w, const float* ssm_bias, const double* scale, const double* coef,
    const int* t0_port, const int* hpm_pair, const int* t0_pair,
    int renew_in_chunks, int t0, int hours_per_month, int K, int P, int M, int E, int Kt,
    int T_pred, int S, int legs_cap, int small_port, double* out, int* fsm_out,
    float* h_out, void* stream) {
  if (K < 1 || P < 0 || M < 0 || E < 0 || Kt < 0 || t0 < 0 || hours_per_month < 1)
    return (int)cudaErrorInvalidValue;
  const bool gated = p_vpn != nullptr, live = h_in != nullptr, pooled = t0_port != nullptr;
  if (gated && (live || p_cci == nullptr || margin == nullptr || T_pred < 1))
    return (int)cudaErrorInvalidValue;
  if (live && (pred_in == nullptr || ssm_a == nullptr || ssm_oma == nullptr ||
               ssm_w == nullptr || ssm_bias == nullptr || scale == nullptr ||
               coef == nullptr || margin == nullptr || h_out == nullptr || S < 1))
    return (int)cudaErrorInvalidValue;
  if (pooled && (live || hpm_pair == nullptr || t0_pair == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool small = small_port != 0;
  if (small && (live || M < 1 || legs_cap < 0 || legs_cap > kSmallLegs))
    return (int)cudaErrorInvalidValue;
  if (!small && K > kTile && E > 0 && leg_cal == nullptr) return (int)cudaErrorInvalidValue;
  const int stride = (K < kTile ? K : kTile) | 1;
  const bool endo = cci_demand != nullptr;
  // the small-port form's rows: the legs, then as much of the port's slice of
  // the calendars as a warp holds
  const int slice = M > 0 ? (P + M - 1) / M : 0;
  const int rows = legs_cap + slice < kSmallLegs ? legs_cap + slice : kSmallLegs;
  const size_t smem =
      small ? sizeof(double) * kSmallPorts *
                  SmallLayout{rows, legs_cap, endo ? 3 : 2, stride, tiers4(Kt)}.doubles()
            : sizeof(double) * live_offset(stride, endo, Kt) + (live ? sizeof(LiveSmem) : 0);
  if ((small ? 0 : sizeof(PortSmem)) + smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (M == 0 && P == 0) return (int)cudaSuccess;
  const RoutedArgs a = {
      demand, cci_demand, pre_v, pre_c, pair_capacity, L_vpn, bounds, rates, lease_cci, c_cci,
      port_capacity, theta1, theta2, h, D, T_cci, up_hold, down_hold, leg_pair, vpn_w,
      attach_w, start, cal_in, fsm_in, pref_in, leg_cal, p_vpn, p_cci, margin, h_in, pred_in,
      ssm_a, ssm_oma, ssm_w, ssm_bias, scale, coef, renew_in_chunks, t0, t0 % hours_per_month,
      hours_per_month, K, P, M, E, Kt, T_pred, S, stride, out, fsm_out, h_out};
  cudaStream_t s = (cudaStream_t)stream;
  if (small) {
    if (pooled) {
      const PooledArgs pa = {a, t0_port, hpm_pair, t0_pair};
      return gated ? launch_small<kReplay, true>(pa, legs_cap, rows, smem, s)
                   : launch_small<kUngated, true>(pa, legs_cap, rows, smem, s);
    }
    return gated ? launch_small<kReplay, false>(a, legs_cap, rows, smem, s)
                 : launch_small<kUngated, false>(a, legs_cap, rows, smem, s);
  }
  if (pooled) {
    const PooledArgs pa = {a, t0_port, hpm_pair, t0_pair};
    return gated ? launch<kReplay, true>(pa, smem, s) : launch<kUngated, true>(pa, smem, s);
  }
  return gated ? launch<kReplay, false>(a, smem, s) : live ? launch<kLive, false>(a, smem, s)
                                                          : launch<kUngated, false>(a, smem, s);
}
