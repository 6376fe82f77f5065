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
//                           of vpn_pair[k, leg_pair[e]] * vpn_w[e]
//                    bill = minimum(sum of dc[k, leg_pair[e]] * attach_w[e], port_capacity)
//                    cci  = lease + c_cci * bill    (lease = L_cci + V_cci * n_attach)
//                    snapshot, window sums, FSM hour, prefix adds (stream_chunk.cu's)
// All float64 arithmetic uses _rn intrinsics and the file is compiled with
// -fmad=false, so every output equals the plain version's bit for bit. The leg
// sums are leg_segment_sum.cu's walk: padding legs (row 0, port 0, zero
// weights) are walked in their place, so a NaN in pair 0 reaches port 0
// (NaN * 0 is NaN) and +0.0 + -0.0 stays +0.0, as in the scatter.
//
// Design: two kernels on the caller's stream, a simple first form.
//   pair stage: one thread per pair walks the K hours (the calendar is a
//     chain of one add an hour; the fold is off the chain) and writes the two
//     hour-major (K, P) scratch planes the port stage reads, vpn_pair and dc,
//     and the (2, P) calendar carry into the result.
//   port stage: one warp per port walks the chunk in tiles of 32 hours, lane
//     k on hour k of the tile. Each lane walks the port's run of the
//     port-major leg index for its hour (the legs of a routing, sorted by port
//     on the host, ascending leg index within a port); lane 0 then runs the
//     cost prefixes into the snapshots, every lane forms its hour's window
//     sums and raw triggers, and lane 0 runs the FSM over the tile
//     (fsm_step.cuh), as stream_chunk.cu's chain warps do.
//
// What bounds it on an H100: at 2048 pairs x K = 24 on 128 ports it must move
// ~0.8 MB (the block in, the result out, tables and carries; the scratch
// planes are the design's, another 1.6 MB written and read), well under a
// microsecond at 3.35 TB/s. It sits far from that: a pair is a chain of K
// hours, and a port lane walks its legs one dependent add at a time, each
// leg's row a separate load (hot ports hold ~50 legs), on only M warps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fsm_step.cuh"
#include "tier_fold.cuh"

namespace {

constexpr int kPairThreads = 128;
constexpr int kWarps = 4;               // ports a block of the port stage
constexpr int kTile = 32;               // hours a tile: one lane each

// torch.minimum: NaN if either side is NaN (fmin drops it), else the smaller.
__device__ __forceinline__ double minimum(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : (b < a ? b : a);
}

__global__ void __launch_bounds__(kPairThreads)
routed_pair_kernel(const double* __restrict__ demand,      // (K, P)
                   const double* __restrict__ cci_demand,  // (K, P) or null
                   const double* __restrict__ capacity,    // (P,)
                   const double* __restrict__ L_vpn,
                   const double* __restrict__ bounds,      // (P, Kt)
                   const double* __restrict__ rates,
                   const double* __restrict__ cal_in,      // (2, P) dcum, dcum_month
                   int phase0, int hours_per_month, int K, int P, int Kt,
                   double* __restrict__ vpn_pair,          // (K, P) scratch
                   double* __restrict__ d_cci,             // (K, P) scratch
                   double* __restrict__ cal_out) {         // (2, P) in the result
  const int p = blockIdx.x * kPairThreads + threadIdx.x;
  if (p >= P) return;
  const double cap = capacity[p];
  const double lvpn = L_vpn[p];
  const double* tb = bounds + (int64_t)p * Kt;
  const double* tr = rates + (int64_t)p * Kt;
  double dcum = cal_in[p];
  double month = cal_in[P + p];
  int ph = phase0;                                  // (t0 + k) % hours_per_month
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * P + p;
    const double d = minimum(demand[i], cap);
    d_cci[i] = cci_demand != nullptr ? minimum(cci_demand[i], cap) : d;
    if (ph == 0) month = dcum;
    const double lo = __dsub_rn(dcum, month);
    dcum = __dadd_rn(dcum, d);
    ph = ph + 1 == hours_per_month ? 0 : ph + 1;
    vpn_pair[i] = __dadd_rn(lvpn, tier::fold(lo, d, tb, tr, Kt));
  }
  cal_out[p] = dcum;
  cal_out[P + p] = month;
}

// One warp's tile of its port, hour-indexed by lane.
struct WarpTile {
  double v[kTile];       // the hour's VPN and CCI costs
  double c[kTile];
  double sv[kTile];      // prefix snapshots: pref before the hour
  double sc[kTile];
  int trig[kTile];       // raw triggers: bit 0 request, bit 1 release
  int state[kTile];
};

__global__ void __launch_bounds__(kWarps * 32)
routed_port_kernel(const double* __restrict__ vpn_pair,    // (K, P) scratch
                   const double* __restrict__ d_cci,       // (K, P) scratch
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
                   int renew_in_chunks, int t0, int K, int P, int M,
                   double* out,                            // planes written, snap rows read back
                   double* __restrict__ pref_out,          // (2, M) in the result
                   int* __restrict__ fsm_out) {            // (4, M)
  __shared__ WarpTile tiles[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= M) return;                               // the whole warp
  WarpTile& sm = tiles[warp];
  const int64_t KM = (int64_t)K * M;

  const double lease = lease_cci[m], cc = c_cci[m], pcap = port_capacity[m];
  const fsm::FsmRow p = {theta1[m], theta2[m], delay[m], commit[m], up_hold[m],
                         down_hold[m], renew_in_chunks != 0};
  const int h = win[m];
  const int e0 = start[m], e1 = start[m + 1];
  // Lane 0's chains: the cost prefixes and the FSM carry.
  double pv = 0.0, pc = 0.0;
  fsm::FsmCarry fc = {};
  if (lane == 0) {
    pv = pref_in[m];
    pc = pref_in[M + m];
    fc = {fsm_in[m], fsm_in[M + m], fsm_in[2 * M + m], fsm_in[3 * M + m], 0};
    fc.phase = fc.t_state % p.T_cci;
  }

  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    const bool mine = lane < len;
    const int k = k0 + lane;
    const int64_t i = (int64_t)k * M + m;
    const int lw = max(0, t0 + k - h);              // the window's first hour
    double bv = 0.0, bc = 0.0;                       // its base, when older than the tile
    if (mine) {
      // The hour's leg fold, in ascending leg index, from +0.0.
      const int64_t row = (int64_t)k * P;
      double av = 0.0, ad = 0.0;
#pragma unroll 4
      for (int j = e0; j < e1; ++j) {
        const int e = order[j];
        const int64_t s = row + leg_pair[e];
        av = __dadd_rn(av, __dmul_rn(vpn_pair[s], vpn_w[e]));
        ad = __dadd_rn(ad, __dmul_rn(d_cci[s], attach_w[e]));
      }
      const double c = __dadd_rn(lease, __dmul_rn(cc, minimum(ad, pcap)));
      sm.v[lane] = av;
      sm.c[lane] = c;
      out[i] = av;
      out[KM + i] = c;
      if (lw < t0) {                                 // before the chunk: the host's read
        bv = pre_v[i];
        bc = pre_c[i];
      } else if (lw < t0 + k0) {                     // an earlier tile's snapshot
        const int64_t j = (int64_t)(lw - t0) * M + m;
        bv = out[4 * KM + j];
        bc = out[5 * KM + j];
      }
    }
    __syncwarp();

    if (lane == 0) {                                 // the cost prefixes' snapshots
      for (int j = 0; j < len; ++j) {
        sm.sv[j] = pv;
        sm.sc[j] = pc;
        pv = __dadd_rn(pv, sm.v[j]);
        pc = __dadd_rn(pc, sm.c[j]);
      }
    }
    __syncwarp();

    if (mine) {                                      // window sums and raw triggers
      const bool in_tile = lw >= t0 + k0;
      const int j = in_tile ? lw - t0 - k0 : lane;
      const double sv = sm.sv[lane], sc = sm.sc[lane];
      const double rv = __dsub_rn(sv, in_tile ? sm.sv[j] : bv);
      const double rc = __dsub_rn(sc, in_tile ? sm.sc[j] : bc);
      bool raw_req, raw_rel;
      fsm::fsm_triggers(p, rv, rc, raw_req, raw_rel);
      sm.trig[lane] = (int)raw_req | (int)raw_rel << 1;
      out[2 * KM + i] = rv;
      out[3 * KM + i] = rc;
      out[4 * KM + i] = sv;
      out[5 * KM + i] = sc;
    }
    __syncwarp();

    if (lane == 0) {                                 // the FSM, integers only
      for (int j = 0; j < len; ++j) {
        const int t = sm.trig[j];
        sm.state[j] = fsm::fsm_step(p, fc, t & 1, t >> 1, p.renew_in_chunks);
      }
    }
    __syncwarp();

    if (mine) {
      const int s = sm.state[lane];
      out[6 * KM + i] = s == fsm::kOn ? 1.0 : 0.0;
      out[7 * KM + i] = (double)s;
    }
    __syncwarp();   // the next tile reads these snapshots and reuses sm
  }

  if (lane == 0) {
    pref_out[m] = pv;
    pref_out[M + m] = pc;
    fsm_out[m] = fc.state;
    fsm_out[M + m] = fc.t_state;
    fsm_out[2 * M + m] = fc.up;
    fsm_out[3 * M + m] = fc.down;
  }
}

}  // namespace

// scratch: 2 K P float64 (vpn_pair, then the clipped CCI demand). out: 8 K M +
// 2 P + 2 M float64. All pointers contiguous on one device.
extern "C" int stream_chunk_routed_f64(
    const double* demand, const double* cci_demand, const double* pre_v, const double* pre_c,
    const double* pair_capacity, const double* L_vpn, const double* bounds, const double* rates,
    const double* lease_cci, const double* c_cci, const double* port_capacity,
    const double* theta1, const double* theta2, const int* h, const int* D, const int* T_cci,
    const int* up_hold, const int* down_hold,
    const int* leg_pair, const double* vpn_w, const double* attach_w, const int* order,
    const int* start,
    const double* cal_in, const int* fsm_in, const double* pref_in, double* scratch,
    int renew_in_chunks, int t0, int hours_per_month, int K, int P, int M, int E, int Kt,
    double* out, int* fsm_out, void* stream) {
  if (K < 1 || P < 0 || M < 0 || E < 0 || Kt < 0 || t0 < 0 || hours_per_month < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t KP = (int64_t)K * P, KM = (int64_t)K * M;
  double* vpn_pair = scratch;
  double* d_cci = scratch + KP;
  if (P > 0) {
    routed_pair_kernel<<<(P + kPairThreads - 1) / kPairThreads, kPairThreads, 0, s>>>(
        demand, cci_demand, pair_capacity, L_vpn, bounds, rates, cal_in,
        t0 % hours_per_month, hours_per_month, K, P, Kt, vpn_pair, d_cci, out + 8 * KM);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (M > 0) {
    routed_port_kernel<<<(M + kWarps - 1) / kWarps, kWarps * 32, 0, s>>>(
        vpn_pair, d_cci, pre_v, pre_c, lease_cci, c_cci, port_capacity, theta1, theta2, h, D,
        T_cci, up_hold, down_hold, leg_pair, vpn_w, attach_w, order, start, fsm_in, pref_in,
        renew_in_chunks, t0, K, P, M, out, out + 8 * KM + 2 * P, fsm_out);
  }
  return (int)cudaGetLastError();
}
