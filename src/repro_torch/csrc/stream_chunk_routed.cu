// The streaming runtime's chunk in topology mode: K hours of every pair and
// port, from the packed host block to the packed result, in one C entry.
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
// In (flat float64 block, the runtime's _pack layout): demand (K, P), the CCI
// demand (K, P) when the chunk prices the CCI counterfactual on its own
// volume, then the host's pre-chunk window reads pre_v, pre_c (K, M). Out: the
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
// (NaN * 0 is NaN) and +0.0 + -0.0 stays +0.0, as in the scatter.
//
// What bounds it on an H100: at 2048 pairs x K = 24 on 128 ports (2048 legs)
// it must move ~0.93 MB (the block in, the result out, tables, legs and
// carries), 0.28 us at 3.35 TB/s, less than the device time of two launches.
// What a chunk cannot avoid is latency: the chains (a pair's calendar, a
// port's leg sum in leg order, its cost prefixes and FSM) are K or E_m
// dependent adds long, and every chain's operands are a device-memory round
// trip away. The aim is stream_chunk.cu's: one round trip per tile, not per
// link of a chain.
//
// Why the first form (one thread a pair; one warp a port, lane k walking hour
// k's legs) sat at 232x its bound (0.0646 ms at K = 24, 0.0349 at K = 1):
//   pair stage: 16 blocks of 128 threads on 132 SMs, each thread walking its
//     24 hours with the tier fold's (bound, rate) rows read from device memory
//     inside the loop: about 1 us an hour;
//   port stage: each leg was three dependent loads (order[j] -> leg_pair[e]
//     -> the scratch value), one leg after another, so the hottest port (95
//     legs) paid ~285 round trips, on lane 0 alone at K = 1; and the scratch
//     was hour-major (K, P), so one leg's warp load touched K separate rows.
//
// Design: two kernels on the caller's stream (the fold needs every pair
// priced first), and a pair-major (P, K) scratch between them.
//   pair stage, stream_chunk.cu's (hour, row) tile: a block owns kRows = 16
//     pairs (2048 pairs are 128 blocks) and walks the chunk in tiles of kTile =
//     32 hours, any K, one thread per (hour, pair). Each thread issues its
//     demand and CCI demand loads at once (an hour's 16 pairs are 128
//     contiguous bytes) and clips them; the first tile also copies the block's
//     (bound, rate) rows into shared memory. Warp 0, lane r on pair r, runs the
//     calendar prefix, the only chain; then every thread runs its own tier fold
//     (tier::fold_with over the shared tables, tier::fold's arithmetic). The
//     tile's two planes are transposed in shared memory and stored pair-major,
//     so a pair's K hours are contiguous for the port stage's gathers.
//   port stage: one block of 4 warps per port (128 ports on 132 SMs). It walks
//     the port's run of the port-major leg index (a stable sort of leg_port on
//     the host, ascending leg index within a port) in tiles of kLegTile = 128
//     legs, any number of tiles. Stage: thread j loads leg j's order, then its
//     pair and two weights into shared memory, so a tile's index chains are
//     in flight together and cost two round trips, not two a leg. Gather: the
//     block copies the tile's (legs x hours) values of both planes into
//     shared memory with cp.async, each leg's hours one contiguous run of the
//     pair-major scratch, every copy issued before any is waited on (at K = 1
//     the threads cover legs, so the gather stays parallel); one round trip.
//     Fold: lane k of warp 0 (VPN) and of warp 1 (the attached volume) adds
//     hour k over the tile's legs in ascending order from shared memory,
//     carrying its sum into the next tile. The hottest port (95 legs) thus
//     costs one tile: three round trips and 95 dependent shared-memory adds
//     on each fold lane. Warp 3 meanwhile loads the hours' window bases.
//     Then, as stream_chunk.cu: lane 0 of warp 0 runs the cost prefixes into
//     the snapshots, warp 0's lanes form each hour's window sums and
//     triggers, and lane 0 of warp 1 runs the FSM (fsm_step.cuh) alone,
//     integers only, so no chain waits on off-chain work.
//
// The forecast-gated policy in replay mode is the port stage's gated instance (kReplay)
// (the pair stage does not change): warp 0's lanes, one an hour, gate their
// raw triggers with fsm_step.cuh's fsm_gated_triggers on the thresholds
// fsm_gate forms once a port, against the port's predicted mode costs at hour
// min(t0 + k, T_pred - 1) of two hour-major (T_pred, M) planes. Each lane
// loads its hour's two values at the top of the hour tile, so the loads (K x
// M elements a chunk, strided by M across the lanes) are in flight during
// the leg fold. The predictions are per port and do not depend on the
// routing, so reroute() leaves them as they are.
//
// The same policy in live mode (src/repro/fleet/runtime.py:541-575) is the
// port stage's LIVE instance (gate mode G = kLive; kUngated and kReplay are
// the two above): the port's SSM demand forecaster steps inside the chunk
// (live_forecast.cuh) on d_row, the port's clipped pair demand folded with
// the attachment weights, in leg order, then minimum'd with the port's
// capacity (runtime.py:485-488). Without endogenous demand that is the
// billed volume warp 1 folds already; with it, d_row folds the VPN-path
// demand, not the CCI demand the bill folds, so the pair stage writes a third
// pair-major scratch plane, the clipped demand (its VPN_D instance), the port
// stage gathers it beside the other two and warp 2's lanes fold it. Each hour
// tile, after the cost planes: warp 2 forms each hour's input u (lane k, hour
// k), then lane s walks state s's chain over the tile's hours, writing its
// readout terms, then lane k folds hour k's terms left from state 0 into the
// readout y, while lane 0 of warp 0 runs the cost prefixes. Warp 0's lanes,
// one an hour, then form the forecasts before and after their hour from y
// (slot 0 of the readouts holds the previous tile's last hour; the chunk's
// first hour reads the carried pred_in), the predicted costs and the gates,
// and store the forecast plane (the result's ninth (K, M) plane; the tail
// moves to 9K). Lane 0 of warp 1 runs the FSM as before.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fsm_step.cuh"
#include "live_forecast.cuh"
#include "tier_fold.cuh"

namespace {

constexpr int kRows = 16;                     // pairs a block of the pair stage
constexpr int kTile = 32;                     // hours a tile
constexpr int kPairThreads = kTile * kRows;   // one (hour, pair) a thread
constexpr int kPortThreads = 128;             // one port a block, 4 warps
constexpr int kLegTile = kPortThreads;        // legs a tile of the port stage: one a thread
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxState = 16;                 // the live forecaster's states (MAX_STATE)
// The port stage's gate mode: reactive/hysteresis, forecast-gated in replay
// mode (predicted-cost planes given), forecast-gated in live mode.
constexpr int kUngated = 0, kReplay = 1, kLive = 2;
// kLive: the port stage's per-tile forecaster scratch behind the gathered
// values: d_row (kTile doubles), the readouts y (kTile + 1 floats), the
// inputs u (kTile), the readout terms (kMaxState rows of kTile + 1).
constexpr size_t kLiveSmem =
    sizeof(double) * kTile + sizeof(float) * ((kTile + 1) + kTile + kMaxState * (kTile + 1));

// torch.minimum: NaN if either side is NaN (fmin drops it), else the smaller.
__device__ __forceinline__ double minimum(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : (b < a ? b : a);
}

// One tile of the pair stage's 16 pairs: hour-major [hour][pair] for the
// calendar lanes and the (hour, pair) threads, and the two scratch planes
// pair-major [pair][hour] (one double of padding a row) for the stores.
struct PairTile {
  double d[kTile][kRows];          // clipped demand
  double lo[kTile][kRows];         // month-to-date volume before the hour
  double v[kRows][kTile + 1];      // vpn_pair
  double dc[kRows][kTile + 1];     // clipped CCI demand
};

// VPN_D: also store the clipped demand pair-major (the live forecast's input
// with endogenous demand).
template <bool VPN_D>
__global__ void __launch_bounds__(kPairThreads)
routed_pair_kernel(const double* __restrict__ demand,      // (K, P)
                   const double* __restrict__ cci_demand,  // (K, P) or null
                   const double* __restrict__ capacity,    // (P,)
                   const double* __restrict__ L_vpn,
                   const double* __restrict__ bounds,      // (P, Kt)
                   const double* __restrict__ rates,
                   const double* __restrict__ cal_in,      // (2, P) dcum, dcum_month
                   int phase0, int hours_per_month, int K, int P, int Kt,
                   double* __restrict__ vpn_pair,          // (P, K) scratch
                   double* __restrict__ d_cci,             // (P, K) scratch
                   double* __restrict__ cal_out,           // (2, P) in the result
                   double* __restrict__ d_vpn) {           // (P, K) scratch: VPN_D only
  __shared__ PairTile sm;
  extern __shared__ double tables[];       // bounds (kRows, Kt), then rates (kRows, Kt)
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, P - n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kk = tid / kRows;              // this thread's hour in every tile
  const int r = tid % kRows;               // and its pair
  const int n = n0 + r;
  const bool has_row = r < rows;
  double cap = 0.0, lvpn = 0.0;
  if (has_row) {
    cap = capacity[n];
    lvpn = L_vpn[n];
  }
  // Warp 0's lanes: the calendar of pair n0 + lane.
  const bool chain = warp == 0 && lane < rows;
  const int cn = n0 + lane;
  double dcum = 0.0, month = 0.0;
  if (chain) {
    dcum = cal_in[cn];
    month = cal_in[P + cn];
  }
  int ph = phase0;                         // (t0 + k) % hours_per_month
  const double* tb = tables + r * Kt;      // this thread's pair's table
  const double* tr = tables + (kRows + r) * Kt;

  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    const bool mine = has_row && kk < len;

    // (0) stage: the loads first, then the tables (first tile), then the stores
    double dv = 0.0, cv = 0.0;
    if (mine) {
      const int64_t i = (int64_t)(k0 + kk) * P + n;
      dv = demand[i];
      if (cci_demand != nullptr) cv = cci_demand[i];
    }
    if (k0 == 0) {
      for (int o = tid; o < rows * Kt; o += kPairThreads) {
        tables[o] = bounds[(int64_t)n0 * Kt + o];
        tables[kRows * Kt + o] = rates[(int64_t)n0 * Kt + o];
      }
    }
    if (mine) {
      const double d = minimum(dv, cap);
      sm.d[kk][r] = d;
      sm.dc[r][kk] = cci_demand != nullptr ? minimum(cv, cap) : d;
    }
    __syncthreads();

    // (a) the billing calendar, one add an hour on the chain
    if (chain) {
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        if (ph == 0) month = dcum;
        sm.lo[k][lane] = __dsub_rn(dcum, month);
        dcum = __dadd_rn(dcum, sm.d[k][lane]);
        ph = ph + 1 == hours_per_month ? 0 : ph + 1;
      }
    }
    __syncthreads();

    // (b) every (hour, pair): its tier fold
    if (mine) {
      const double transfer = tier::fold_with(
          sm.lo[kk][r], sm.d[kk][r], [tb](int t) { return tb[t]; },
          [tr](int t) { return tr[t]; }, Kt);
      sm.v[r][kk] = __dadd_rn(lvpn, transfer);
    }
    __syncthreads();

    // (c) the tile's planes, pair-major: each pair's hours one contiguous run
    for (int o = tid; o < rows * len; o += kPairThreads) {
      const int rr = o / len, k = o - rr * len;
      const int64_t a = (int64_t)(n0 + rr) * K + k0 + k;
      vpn_pair[a] = sm.v[rr][k];
      d_cci[a] = sm.dc[rr][k];
      if constexpr (VPN_D) d_vpn[a] = sm.d[k][rr];
    }
    __syncthreads();   // the next tile reuses sm
  }

  if (chain) {
    cal_out[cn] = dcum;
    cal_out[P + cn] = month;
  }
}

// The port stage's shared memory: one tile of the port's legs (staged: pair,
// VPN share, attachment weight) and one hour tile's per-hour values. The
// gathered (legs x hours) values of the two planes are dynamic shared memory.
struct PortSmem {
  double wv[kLegTile];
  double wa[kLegTile];
  int lp[kLegTile];
  double v[kTile];                 // the hour's VPN and CCI costs
  double c[kTile];
  double bv[kTile];                // window bases older than the hour tile
  double bc[kTile];
  double sv[kTile];                // prefix snapshots: pref before the hour
  double sc[kTile];
  int trig[kTile];                 // raw triggers: bit 0 request, bit 1 release
  int state[kTile];
};

template <int G>
__global__ void __launch_bounds__(kPortThreads)
routed_port_kernel(const double* __restrict__ vpn_pair,    // (P, K) scratch
                   const double* __restrict__ d_cci,       // (P, K) scratch
                   const double* __restrict__ pre_v,       // (K, M)
                   const double* __restrict__ pre_c,
                   const double* __restrict__ lease_cci,   // (M,) L_cci + V_cci * n_attach
                   const double* __restrict__ c_cci,
                   const double* __restrict__ port_capacity,
                   const double* __restrict__ theta1,
                   const double* __restrict__ theta2,
                   const int* __restrict__ win,
                   const int* __restrict__ delay,
                   const int* __restrict__ commit,
                   const int* __restrict__ up_hold,
                   const int* __restrict__ down_hold,
                   const int* __restrict__ leg_pair,       // (E,)
                   const double* __restrict__ vpn_w,
                   const double* __restrict__ attach_w,
                   const int* __restrict__ order,          // (E,) legs in port-major order
                   const int* __restrict__ start,          // (M + 1,)
                   const int* __restrict__ fsm_in,         // (4, M)
                   const double* __restrict__ pref_in,     // (2, M)
                   const double* __restrict__ p_vpn,       // (T_pred, M): kReplay only
                   const double* __restrict__ p_cci,
                   const double* __restrict__ margin,      // (M,)
                   int renew_in_chunks, int t0, int K, int M, int T_pred,
                   double* out,                            // planes written, snap rows read back
                   double* __restrict__ pref_out,          // (2, M) in the result
                   int* __restrict__ fsm_out,              // (4, M)
                   const float* __restrict__ h_in,         // (M, S): kLive only
                   const double* __restrict__ pred_in,     // (M,)
                   const float* __restrict__ ssm_a,        // (S,) a, 1 - a, w; bias ()
                   const float* __restrict__ ssm_oma,
                   const float* __restrict__ ssm_w,
                   const float* __restrict__ ssm_bias,
                   const double* __restrict__ scale,       // (M,)
                   const double* __restrict__ coef,        // (M, 4)
                   int S,
                   float* __restrict__ h_out,              // (M, S)
                   const double* __restrict__ d_vpn) {     // (P, K) clipped demand, or null
  __shared__ PortSmem sm;
  extern __shared__ double gathered[];     // (kLegTile, len) vpn_pair values, then the CCI demands
  const int m = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t KM = (int64_t)K * M;
  const int e0 = start[m], e1 = start[m + 1];
  const fsm::FsmRow p = {theta1[m], theta2[m], delay[m], commit[m], up_hold[m],
                         down_hold[m], renew_in_chunks != 0};
  const int h = win[m];
  [[maybe_unused]] fsm::FsmGate g = {};   // warp 0's gate thresholds
  if (G != kUngated && warp == 0) g = fsm::fsm_gate(p, margin[m]);
  // kLive: warp 0 forms the forecasts and gates, warp 2 steps the forecaster
  // (lane s state s) and, with endogenous demand, folds d_row
  const bool vpn_fold = G == kLive && d_vpn != nullptr;
  [[maybe_unused]] double scale_m = 0.0, pred0 = 0.0, cf[4] = {0.0, 0.0, 0.0, 0.0};
  [[maybe_unused]] double pcap2 = 0.0;
  [[maybe_unused]] float hs = 0.0f, sa = 0.0f, sb = 0.0f, sw = 0.0f, bias = 0.0f;
  [[maybe_unused]] double* drow = nullptr;
  [[maybe_unused]] float *ys = nullptr, *us = nullptr, *ps = nullptr;
  if constexpr (G == kLive) {
    double* lb = gathered + (vpn_fold ? 3 : 2) * kLegTile * (K < kTile ? K : kTile);
    drow = lb;
    ys = reinterpret_cast<float*>(lb + kTile);
    us = ys + kTile + 1;
    ps = us + kTile;
    if (warp == 0 || warp == 2) scale_m = scale[m];
    if (warp == 0) {
      pred0 = pred_in[m];
#pragma unroll
      for (int q = 0; q < 4; ++q) cf[q] = coef[4 * (int64_t)m + q];
    } else if (warp == 2) {
      bias = ssm_bias[0];
      pcap2 = port_capacity[m];
      if (lane < S) {
        sa = ssm_a[lane];
        sb = ssm_oma[lane];
        sw = ssm_w[lane];
        hs = h_in[(int64_t)m * S + lane];
      }
    }
  }
  // Warp 1 prices the CCI plane; lane 0 of warp 0 carries the cost prefixes,
  // lane 0 of warp 1 the FSM.
  double lease = 0.0, cc = 0.0, pcap = 0.0;
  if (warp == 1) {
    lease = lease_cci[m];
    cc = c_cci[m];
    pcap = port_capacity[m];
  }
  double pv = 0.0, pc = 0.0;
  fsm::FsmCarry fc = {};
  if (tid == 0) {
    pv = pref_in[m];
    pc = pref_in[M + m];
  } else if (tid == 32) {
    fc = {fsm_in[m], fsm_in[M + m], fsm_in[2 * M + m], fsm_in[3 * M + m], 0};
    fc.phase = fc.t_state % p.T_cci;
  }

  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    const int k = k0 + lane;                        // lane's hour, for warps 0, 1 and 3
    const int64_t i = (int64_t)k * M + m;
    const int lw = max(0, t0 + k - h);              // the hour's window starts here
    [[maybe_unused]] double gv = 0.0, gc = 0.0;     // kReplay: the hour's predicted costs
    if (G == kReplay && warp == 0 && lane < len) {
      const int64_t j = (int64_t)min(t0 + k, T_pred - 1) * M + m;
      gv = p_vpn[j];
      gc = p_cci[j];
    }
    if (warp == 3 && lane < len) {                  // the window base, when older than the tile
      double bv = 0.0, bc = 0.0;
      if (lw < t0) {                                // before the chunk: the host's read
        bv = pre_v[i];
        bc = pre_c[i];
      } else if (lw < t0 + k0) {                    // an earlier tile's snapshot
        const int64_t j = (int64_t)(lw - t0) * M + m;
        bv = out[4 * KM + j];
        bc = out[5 * KM + j];
      }
      sm.bv[lane] = bv;
      sm.bc[lane] = bc;
    }

    // The leg fold: warp 0's lane k sums hour k's VPN, warp 1's its attached
    // volume, in ascending leg index from +0.0, a tile of legs at a time.
    double acc = 0.0;
    for (int s0 = e0; s0 < e1; s0 += kLegTile) {
      const int nl = min(kLegTile, e1 - s0);
      if (tid < nl) {                               // stage: one leg's index chain a thread
        const int e = order[s0 + tid];
        sm.lp[tid] = leg_pair[e];
        sm.wv[tid] = vpn_w[e];
        sm.wa[tid] = attach_w[e];
      }
      __syncthreads();
      // gather: each leg's len hours are one contiguous run of the pair-major
      // scratch; every copy is issued before any is waited on
      double* gv = gathered;
      double* gc = gathered + nl * len;
      [[maybe_unused]] double* gd = gathered + 2 * nl * len;   // vpn_fold: the clipped demand
      for (int o = tid; o < nl * len; o += kPortThreads) {
        const int l = o / len;
        const int64_t a = (int64_t)sm.lp[l] * K + k0 + (o - l * len);
        __pipeline_memcpy_async(gv + o, vpn_pair + a, sizeof(double));
        __pipeline_memcpy_async(gc + o, d_cci + a, sizeof(double));
        if constexpr (G == kLive) {
          if (vpn_fold) __pipeline_memcpy_async(gd + o, d_vpn + a, sizeof(double));
        }
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      if (warp == 0 && lane < len) {
#pragma unroll 4
        for (int l = 0; l < nl; ++l)
          acc = __dadd_rn(acc, __dmul_rn(gv[l * len + lane], sm.wv[l]));
      } else if (warp == 1 && lane < len) {
#pragma unroll 4
        for (int l = 0; l < nl; ++l)
          acc = __dadd_rn(acc, __dmul_rn(gc[l * len + lane], sm.wa[l]));
      } else if constexpr (G == kLive) {
        if (vpn_fold && warp == 2 && lane < len) {
#pragma unroll 4
          for (int l = 0; l < nl; ++l)
            acc = __dadd_rn(acc, __dmul_rn(gd[l * len + lane], sm.wa[l]));
        }
      }
      __syncthreads();   // the next tile restages and regathers
    }

    // The cost planes.
    if (warp == 0 && lane < len) {
      sm.v[lane] = acc;
      out[i] = acc;
    } else if (warp == 1 && lane < len) {
      const double c = __dadd_rn(lease, __dmul_rn(cc, minimum(acc, pcap)));
      sm.c[lane] = c;
      out[KM + i] = c;
      if constexpr (G == kLive) {
        if (!vpn_fold) drow[lane] = minimum(acc, pcap);   // d_row is the billed volume
      }
    }
    if constexpr (G == kLive) {
      if (vpn_fold && warp == 2 && lane < len) drow[lane] = minimum(acc, pcap2);
    }
    __syncthreads();

    if (tid == 0) {                                 // the cost prefixes' snapshots
#pragma unroll 8
      for (int j = 0; j < len; ++j) {
        sm.sv[j] = pv;
        sm.sc[j] = pc;
        pv = __dadd_rn(pv, sm.v[j]);
        pc = __dadd_rn(pc, sm.c[j]);
      }
    }
    if constexpr (G == kLive) {                     // the forecaster over the tile's hours
      if (warp == 2) {
        if (lane == 0 && k0 > 0) ys[0] = ys[kTile];   // the previous tile's last hour
        if (lane < len) us[lane] = live::ssm_input(drow[lane], scale_m);
        __syncwarp();
        if (lane < S) {
          float* pt = ps + lane * (kTile + 1);
          for (int j = 0; j < len; ++j) pt[j] = live::ssm_state(hs, us[j], sa, sb, sw);
        }
        __syncwarp();
        if (lane < len) {
          float acc_y = ps[lane];
          for (int s = 1; s < S; ++s) acc_y = __fadd_rn(acc_y, ps[s * (kTile + 1) + lane]);
          ys[lane + 1] = live::ssm_readout(us[lane], acc_y, bias);
        }
      }
    }
    __syncthreads();

    if (warp == 0 && lane < len) {                  // window sums and raw triggers
      const bool in_tile = lw >= t0 + k0;           // a snapshot of its own tile
      const int j = in_tile ? lw - t0 - k0 : lane;
      const double sv = sm.sv[lane], sc = sm.sc[lane];
      const double rv = __dsub_rn(sv, in_tile ? sm.sv[j] : sm.bv[lane]);
      const double rc = __dsub_rn(sc, in_tile ? sm.sc[j] : sm.bc[lane]);
      bool raw_req, raw_rel;
      fsm::fsm_triggers(p, rv, rc, raw_req, raw_rel);
      if constexpr (G == kReplay) fsm::fsm_gated_triggers(g, gv, gc, raw_req, raw_rel);
      if constexpr (G == kLive) {                   // the forecast carried into the hour
        const double before = k == 0 ? pred0 : live::prediction(ys[lane], scale_m);
        out[8 * KM + i] = live::prediction(ys[lane + 1], scale_m);
        double lv, lc;
        live::mode_costs(before, cf, lv, lc);
        fsm::fsm_gated_triggers(g, lv, lc, raw_req, raw_rel);
      }
      sm.trig[lane] = (int)raw_req | (int)raw_rel << 1;
      out[2 * KM + i] = rv;
      out[3 * KM + i] = rc;
      out[4 * KM + i] = sv;
      out[5 * KM + i] = sc;
    }
    __syncthreads();

    if (tid == 32) {                                // the FSM, integers only
#pragma unroll 8
      for (int j = 0; j < len; ++j) {
        const int t = sm.trig[j];
        sm.state[j] = fsm::fsm_step(p, fc, t & 1, t >> 1, p.renew_in_chunks);
      }
    }
    __syncthreads();

    if (warp == 0 && lane < len) {
      const int s = sm.state[lane];
      out[6 * KM + i] = s == fsm::kOn ? 1.0 : 0.0;
      out[7 * KM + i] = (double)s;
    }
    __syncthreads();   // the next hour tile reads these snapshots and reuses sm
  }

  if (tid == 0) {
    pref_out[m] = pv;
    pref_out[M + m] = pc;
  } else if (tid == 32) {
    fsm_out[m] = fc.state;
    fsm_out[M + m] = fc.t_state;
    fsm_out[2 * M + m] = fc.up;
    fsm_out[3 * M + m] = fc.down;
  }
  if constexpr (G == kLive) {
    if (warp == 2 && lane < S) h_out[(int64_t)m * S + lane] = hs;
  }
}

// The live instance's operands of the port stage (null in the others).
struct LiveArgs {
  const float* h_in;
  const double* pred_in;
  const float* ssm_a;
  const float* ssm_oma;
  const float* ssm_w;
  const float* ssm_bias;
  const double* scale;
  const double* coef;
  int S;
  float* h_out;
  const double* d_vpn;
};

// The port stage's launch in gate mode G.
template <int G>
int launch_port(const double* vpn_pair, const double* d_cci, const double* pre_v,
                const double* pre_c, const double* lease_cci, const double* c_cci,
                const double* port_capacity, const double* theta1, const double* theta2,
                const int* h, const int* D, const int* T_cci, const int* up_hold,
                const int* down_hold, const int* leg_pair, const double* vpn_w,
                const double* attach_w, const int* order, const int* start, const int* fsm_in,
                const double* pref_in, const double* p_vpn, const double* p_cci,
                const double* margin, int renew_in_chunks, int t0, int K, int M, int T_pred,
                double* out, double* pref_out, int* fsm_out, const LiveArgs& lv, size_t gathered,
                cudaStream_t s) {
  if (sizeof(PortSmem) + gathered > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        routed_port_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gathered);
    if (err != cudaSuccess) return (int)err;
  }
  routed_port_kernel<G><<<M, kPortThreads, gathered, s>>>(
      vpn_pair, d_cci, pre_v, pre_c, lease_cci, c_cci, port_capacity, theta1, theta2, h, D,
      T_cci, up_hold, down_hold, leg_pair, vpn_w, attach_w, order, start, fsm_in, pref_in,
      p_vpn, p_cci, margin, renew_in_chunks, t0, K, M, T_pred, out, pref_out, fsm_out,
      lv.h_in, lv.pred_in, lv.ssm_a, lv.ssm_oma, lv.ssm_w, lv.ssm_bias, lv.scale, lv.coef, lv.S,
      lv.h_out, lv.d_vpn);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: 2 P K float64 (vpn_pair, then the clipped CCI demand, pair-major;
// a live call with endogenous demand 3 P K, the clipped demand third).
// out: 8 K M + 2 P + 2 M float64 (9 K M + ... in a live call). All pointers
// contiguous on one device. p_vpn, p_cci (T_pred, M) and margin (M,) select
// the port stage's forecast-gated instance in replay mode; h_in (M, S),
// pred_in (M,), the forecaster's a, 1 - a, w (S,) and bias, scale (M,), coef
// (M, 4) and margin (M,) its live instance (h_out (M, S)); null p_vpn and
// h_in the reactive/hysteresis one.
extern "C" int stream_chunk_routed_f64(
    const double* demand, const double* cci_demand, const double* pre_v, const double* pre_c,
    const double* pair_capacity, const double* L_vpn, const double* bounds, const double* rates,
    const double* lease_cci, const double* c_cci, const double* port_capacity,
    const double* theta1, const double* theta2, const int* h, const int* D, const int* T_cci,
    const int* up_hold, const int* down_hold,
    const int* leg_pair, const double* vpn_w, const double* attach_w, const int* order,
    const int* start,
    const double* cal_in, const int* fsm_in, const double* pref_in, double* scratch,
    const double* p_vpn, const double* p_cci, const double* margin,
    const float* h_in, const double* pred_in, const float* ssm_a, const float* ssm_oma,
    const float* ssm_w, const float* ssm_bias, const double* scale, const double* coef,
    int renew_in_chunks, int t0, int hours_per_month, int K, int P, int M, int E, int Kt,
    int T_pred, int S, double* out, int* fsm_out, float* h_out, void* stream) {
  if (K < 1 || P < 0 || M < 0 || E < 0 || Kt < 0 || t0 < 0 || hours_per_month < 1)
    return (int)cudaErrorInvalidValue;
  const bool gated = p_vpn != nullptr, live = h_in != nullptr;
  if (gated && (live || p_cci == nullptr || margin == nullptr || T_pred < 1))
    return (int)cudaErrorInvalidValue;
  if (live && (pred_in == nullptr || ssm_a == nullptr || ssm_oma == nullptr ||
               ssm_w == nullptr || ssm_bias == nullptr || scale == nullptr ||
               coef == nullptr || margin == nullptr || h_out == nullptr || S < 1 ||
               S > kMaxState))
    return (int)cudaErrorInvalidValue;
  const size_t tables = sizeof(double) * 2 * kRows * (size_t)Kt;
  if (sizeof(PairTile) + tables > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vpn_d = live && cci_demand != nullptr;   // d_row folds the clipped demand
  const size_t gathered = sizeof(double) * (vpn_d ? 3 : 2) * kLegTile *
                          (size_t)(K < kTile ? K : kTile) + (live ? kLiveSmem : 0);
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t KP = (int64_t)K * P, KM = (int64_t)K * M;
  const int64_t tail = (live ? 9 : 8) * KM;
  double* vpn_pair = scratch;
  double* d_cci = scratch + KP;
  double* d_vpn = vpn_d ? scratch + 2 * KP : nullptr;
  if (P > 0) {
    const auto pair = vpn_d ? routed_pair_kernel<true> : routed_pair_kernel<false>;
    if (sizeof(PairTile) + tables > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          pair, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tables);
      if (err != cudaSuccess) return (int)err;
    }
    pair<<<(P + kRows - 1) / kRows, kPairThreads, tables, s>>>(
        demand, cci_demand, pair_capacity, L_vpn, bounds, rates, cal_in,
        t0 % hours_per_month, hours_per_month, K, P, Kt, vpn_pair, d_cci, out + tail, d_vpn);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (M > 0) {
    const LiveArgs lv = {h_in, pred_in, ssm_a, ssm_oma, ssm_w, ssm_bias, scale, coef, S, h_out,
                         d_vpn};
    const auto port = gated ? launch_port<kReplay>
                            : live ? launch_port<kLive> : launch_port<kUngated>;
    const int err = port(vpn_pair, d_cci, pre_v, pre_c, lease_cci, c_cci, port_capacity, theta1,
                         theta2, h, D, T_cci, up_hold, down_hold, leg_pair, vpn_w, attach_w,
                         order, start, fsm_in, pref_in, p_vpn, p_cci, margin, renew_in_chunks,
                         t0, K, M, T_pred, out, out + tail + 2 * P, fsm_out, lv, gathered, s);
    if (err != (int)cudaSuccess) return err;
  }
  return (int)cudaGetLastError();
}
