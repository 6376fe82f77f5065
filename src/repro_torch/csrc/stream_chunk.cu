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

#include <cuda_runtime.h>
#include <stdint.h>

#include "fsm_step.cuh"
#include "tier_fold.cuh"

namespace {

constexpr int kTickThreads = 32;    // tick form: one row a thread, one warp a block
constexpr int kTickMaxK = 5;        // tick-form instances K = 1..5 (TICK_MAX_K)
constexpr int kTickMaxTiers = 8;    // its tier tables live in registers
constexpr int kRows = 16;           // chunk form: rows a block
constexpr int kSub = 8;             // hours a sub-tile
constexpr int kMaxSubs = 3;         // sub-tiles a tile: 5 named barriers each
constexpr int kPhases = 5;          // lo, fold, pref, trig, state
constexpr int kBarThreads = 5 * 32; // a sub-tile's four pair warps and one chain warp
constexpr int kMaxSmem = 227 * 1024;

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
  int renew_in_chunks, t0, phase0, hours_per_month, K, M, Kt;
  double* out;               // (8K + 4, M)
  int* fsm_out;              // (4, M)
};

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

// ---------------------------------------------------------------- tick form

template <int K, int KT>   // K hours; tables of at most KT tiers, padded to KT
__global__ void __launch_bounds__(kTickThreads, 8)
stream_chunk_tick_kernel(const ChunkArgs a) {
  const int n = blockIdx.x * kTickThreads + threadIdx.x;
  if (n >= a.M) return;
  const int M = a.M;
  const int64_t KM = (int64_t)K * M;
  const bool endo = a.cci_demand != nullptr;

  // every load of the row first
  double dv[K], cv[K], bv[K], bc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * M + n;
    dv[k] = a.demand[i];
    cv[k] = endo ? a.cci_demand[i] : 0.0;
    bv[k] = a.pre_v[i];
    bc[k] = a.pre_c[i];
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
  int ph = a.phase0;                       // (t0 + k) % hours_per_month
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (ph == 0) month = dcum;
    lo[k] = __dsub_rn(dcum, month);
    dcum = __dadd_rn(dcum, d[k]);
    ph = ph + 1 == a.hours_per_month ? 0 : ph + 1;
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
    const int lw = max(0, a.t0 + k - h) - a.t0;
    double base_v = bv[k], base_c = bc[k];
#pragma unroll
    for (int j = 0; j <= k; ++j) {
      base_v = lw == j ? sv[j] : base_v;
      base_c = lw == j ? sc[j] : base_c;
    }
    const double rv = __dsub_rn(sv[k], base_v);
    const double rc = __dsub_rn(sc[k], base_c);
    fsm::fsm_triggers(p, rv, rc, raw_req[k], raw_rel[k]);
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
  const int64_t e = 8 * KM + n;
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

template <int S>
__global__ void __launch_bounds__(32 * (4 * S + 3), 1)
stream_chunk_pipe_kernel(const ChunkArgs a) {
  constexpr int kTile = kSub * S;
  constexpr int kPairWarps = 4 * S;
  __shared__ PipeTile<kTile> sm;
  extern __shared__ double tables[];       // bounds (kRows, Kt), then rates (kRows, Kt)
  const int M = a.M, K = a.K, Kt = a.Kt;
  const int64_t KM = (int64_t)K * M;
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool endo = a.cci_demand != nullptr;

  if (warp < kPairWarps) {
    // ---- pair warps: (hour kk, row r) of every tile; sub-tile j = warp / 4
    const int kk = tid / kRows, r = tid % kRows, j = warp / 4;
    const int n = n0 + r;
    const bool has_row = r < rows;
    double cap = 0.0, lvpn = 0.0, lease = 0.0, cc = 0.0;
    fsm::FsmRow pr = {};                   // the thresholds the window sums meet
    int h = 0;
    if (has_row) {
      cap = a.capacity[n];
      lvpn = a.L_vpn[n];
      lease = a.lease_cci[n];
      cc = a.c_cci[n];
      pr.theta1 = a.theta1[n];
      pr.theta2 = a.theta2[n];
      h = a.win[n];
    }
    const double* tb = tables + r * Kt;
    const double* tr = tables + (kRows + r) * Kt;
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const bool mine = has_row && kk < K - k0;
      const int64_t i = (int64_t)(k0 + kk) * M + n;
      double dv = 0.0, cv = 0.0, bv = 0.0, bc = 0.0;
      if (mine) {
        dv = a.demand[i];
        if (endo) cv = a.cci_demand[i];
        bv = a.pre_v[i];
        bc = a.pre_c[i];
      }
      if (k0 == 0) {
        for (int o = tid; o < rows * Kt; o += kPairWarps * 32) {
          tables[o] = a.bounds[(int64_t)n0 * Kt + o];
          tables[kRows * Kt + o] = a.rates[(int64_t)n0 * Kt + o];
        }
      }
      __syncthreads();   // the tables; every role done with the last tile
      const int lw = max(0, a.t0 + k0 + kk - h) - a.t0;   // the window base's hour
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

      bar_wait(bar_id(j, kPref));
      double w[4] = {0.0, 0.0, 0.0, 0.0};   // r_vpn, r_cci, snap_v, snap_c
      if (mine) {
        const bool in_tile = lw >= k0;     // its own tile's snapshots (lw - k0 <= kk)
        const double sv = sm.sv[kk][r], sc = sm.sc[kk][r];
        const double rv = __dsub_rn(sv, in_tile ? sm.sv[lw - k0][r] : bv);
        const double rc = __dsub_rn(sc, in_tile ? sm.sc[lw - k0][r] : bc);
        bool raw_req, raw_rel;
        fsm::fsm_triggers(pr, rv, rc, raw_req, raw_rel);
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
    double cap = 0.0, dcum = 0.0, month = 0.0;
    if (live) {
      cap = a.capacity[n];
      dcum = a.cal_in[n];
      month = a.cal_in[M + n];
    }
    int ph = a.phase0;                     // (t0 + k) % hours_per_month
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int len = min(kTile, K - k0);
      double dv[kTile];                    // the tile's demand, loads in flight at once
#pragma unroll
      for (int k = 0; k < kTile; ++k)
        dv[k] = live && k < len ? a.demand[(int64_t)(k0 + k) * M + n] : 0.0;
      __syncthreads();
      // one calendar hour; a lane past the block's rows computes on zeros and
      // stores nothing
      auto hour = [&](int k) {
        if (ph == 0) month = dcum;
        const double lo = __dsub_rn(dcum, month);
        if (live) sm.lo[k][lane] = lo;
        dcum = __dadd_rn(dcum, tier::min_sel(dv[k], cap));
        ph = ph + 1 == a.hours_per_month ? 0 : ph + 1;
      };
#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (len >= kSub * (j + 1)) {       // a full sub-tile: no branch an hour
#pragma unroll
          for (int k = kSub * j; k < kSub * (j + 1); ++k) hour(k);
        } else {                           // compile-time k: dv stays in registers
#pragma unroll
          for (int k = kSub * j; k < kSub * (j + 1); ++k)
            if (k < len) hour(k);
        }
        bar_arrive(bar_id(j, kLo));
      }
    }
    if (live) {
      a.out[8 * KM + n] = dcum;
      a.out[8 * KM + M + n] = month;
    }
  } else if (role == 1) {
    double pv = 0.0, pc = 0.0;
    if (live) {
      pv = a.pref_in[n];
      pc = a.pref_in[M + n];
    }
    for (int k0 = 0; k0 < K; k0 += kTile) {
      const int len = min(kTile, K - k0);
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
      a.out[8 * KM + 2 * M + n] = pv;
      a.out[8 * KM + 3 * M + n] = pc;
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

template <int K>
int launch_tick(const ChunkArgs& a, cudaStream_t stream) {
  const int blocks = (a.M + kTickThreads - 1) / kTickThreads;
  if (a.Kt <= kTickMaxTiers / 2)
    stream_chunk_tick_kernel<K, kTickMaxTiers / 2><<<blocks, kTickThreads, 0, stream>>>(a);
  else
    stream_chunk_tick_kernel<K, kTickMaxTiers><<<blocks, kTickThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S>
int launch_pipe(const ChunkArgs& a, cudaStream_t stream) {
  const size_t tables = sizeof(double) * 2 * kRows * (size_t)a.Kt;
  if (sizeof(PipeTile<kSub * S>) + tables > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (sizeof(PipeTile<kSub * S>) + tables > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_chunk_pipe_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tables);
    if (err != cudaSuccess) return (int)err;
  }
  stream_chunk_pipe_kernel<S><<<(a.M + kRows - 1) / kRows, 32 * (4 * S + 3), tables, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// form: 0 the tick form (K <= kTickMaxK, Kt <= kTickMaxTiers), 1..3 the chunk
// form with that many 8-hour sub-tiles a tile; kernels/stream_chunk.py::launch_form picks it.
extern "C" int stream_chunk_f64(const double* demand, const double* cci_demand,
                                const double* pre_v, const double* pre_c,
                                const double* capacity, const double* L_vpn,
                                const double* lease_cci, const double* c_cci,
                                const double* bounds, const double* rates,
                                const double* theta1, const double* theta2, const int* h,
                                const int* D, const int* T_cci, const int* up_hold,
                                const int* down_hold, const double* cal_in,
                                const int* fsm_in, const double* pref_in,
                                int renew_in_chunks, int t0, int hours_per_month, int K,
                                int M, int Kt, int form, double* out, int* fsm_out,
                                void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || K < 1 || Kt < 0 || t0 < 0 || hours_per_month < 1)
    return (int)cudaErrorInvalidValue;
  const ChunkArgs a = {demand, cci_demand, pre_v, pre_c, capacity, L_vpn, lease_cci, c_cci,
                       bounds, rates, theta1, theta2, h, D, T_cci, up_hold, down_hold,
                       cal_in, fsm_in, pref_in, renew_in_chunks, t0, t0 % hours_per_month,
                       hours_per_month, K, M, Kt, out, fsm_out};
  const cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    if (K > kTickMaxK || Kt > kTickMaxTiers) return (int)cudaErrorInvalidValue;
    switch (K) {
      case 1: return launch_tick<1>(a, s);
      case 2: return launch_tick<2>(a, s);
      case 3: return launch_tick<3>(a, s);
      case 4: return launch_tick<4>(a, s);
      case 5: return launch_tick<5>(a, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (form) {
    case 1: return launch_pipe<1>(a, s);
    case 2: return launch_pipe<2>(a, s);
    case 3: return launch_pipe<kMaxSubs>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
