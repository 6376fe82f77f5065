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
//   d = minimum(demand, capacity)  (NaN if either is NaN, as torch.minimum)
//   if ((t0 + k) % hours_per_month == 0) dcum_month = dcum
//   lo = dcum - dcum_month;  dcum = dcum + d
//   vpn = L_vpn + fold(lo, d);  cci = lease + c_cci * d_cci  (product, then sum)
//   snap = pref;  r = pref - pref[max(0, t0 + k - h)];  FSM hour;  pref += cost
// All float64 arithmetic uses _rn intrinsics and the file is compiled with
// -fmad=false, so every output equals the plain version's bit for bit. The
// fold is tier_fold.cuh's (tier::fold_with, the arithmetic of the tier::fold
// that tiered_cost_scan.cu runs) and the FSM hour fsm_step.cuh's triggers and
// step (fsm_scan.cu's). A NaN hi = lo + d makes every tier segment NaN and so
// every term 0, in the plain version and in the fold alike (its min/max keep
// NaN): the hour's transfer is +0.0.
//
// What bounds it on an H100: at the runtime's chunk (2048 rows, K = 24) it
// moves ~4.8 MB (the 1.2-MB block in, the 3.2-MB result out, tables and
// carries), ~1.4 us at 3.35 TB/s. But each row is a dependent chain of K hours
// (the calendar prefix, the cost prefixes, the FSM carry), one thread each,
// so as long as every hour's data is at hand a chunk takes K steps of that
// chain, ~60-80 cycles an hour. The kernels it replaces let each hour's load
// wait a device-memory round trip inside the chain.
//
// Design. A block owns kRows = 16 rows (2048 rows are 128 blocks on 132 SMs)
// and walks the chunk in tiles of kTile = 32 hours, any K; each of its
// kTile * kRows threads owns one (hour, row) pair of every tile. Per tile:
//   (0) every thread loads its pair's inputs, all loads in flight at once (an
//       hour's 16 rows are 128 contiguous bytes): the demand and CCI demand,
//       clipped into shared memory, and the window base when it is older than
//       the tile, from pre_v / pre_c (before t0) or from this chunk's snap rows
//       already in the packed result (an earlier tile, behind a
//       __syncthreads). The first tile also copies the block's (bound, rate)
//       tables into shared memory, once. So a tile pays one memory latency;
//   (a) warp 0, lane r on row r, runs the calendar prefix, one add an hour;
//   (b) every thread runs its pair's tier fold (tier::fold_with over the
//       shared tables, the arithmetic of tier::fold) and the vpn / cci planes:
//       independent given lo, so the fold leaves the chain;
//   (c1) warp 0 runs the cost prefixes into the snapshots, one add an hour;
//   (c2) every thread forms its pair's window sums (a base inside the tile
//       from the tile's own snapshots) and raw triggers (fsm::fsm_triggers),
//       and stores the window sums and snapshots;
//   (c3) warp 1 runs the FSM over the triggers (fsm::fsm_step; integers
//       only, as fsm_scan.cu's FSM warp);
//   (d) every thread stores x and state, as float64.
// Only (a), (c1) and (c3) are chains, and each carries one thing: a float64
// prefix or the integer FSM. A warp issues in order, so one warp walking the
// prefixes, window sums, triggers and FSM of an hour together waits, every
// hour, on the window sums' shared-memory reads and float64 latencies, which
// no later hour needs; timed on the card, that design was the slower one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fsm_step.cuh"
#include "tier_fold.cuh"

namespace {

constexpr int kRows = 16;                  // rows a block; lane r of warps 0 and 1 walks row n0 + r
constexpr int kTile = 32;                  // hours a tile
constexpr int kThreads = kTile * kRows;    // one (hour, row) pair a thread
constexpr int kMaxSmem = 227 * 1024;

// One tile of the block's rows, hour-major [hour][row]: the chain lanes (one
// row each) and the pair threads (row fastest) touch consecutive words.
struct Tile {
  double d[kTile][kRows];     // clipped demand
  double dc[kTile][kRows];    // clipped CCI demand
  double bv[kTile][kRows];    // window bases older than the tile
  double bc[kTile][kRows];
  double lo[kTile][kRows];    // month-to-date volume before the hour
  double vpn[kTile][kRows];
  double cci[kTile][kRows];
  double sv[kTile][kRows];    // prefix snapshots: pref before the hour
  double sc[kTile][kRows];
  int trig[kTile][kRows];     // the hour's raw triggers: bit 0 request, bit 1 release
  int state[kTile][kRows];
};

// torch.minimum: NaN if either side is NaN (fmin drops it), else the smaller.
__device__ __forceinline__ double minimum(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : (b < a ? b : a);
}

__global__ void __launch_bounds__(kThreads)
stream_chunk_kernel(const double* __restrict__ demand,      // (K, M)
                    const double* __restrict__ cci_demand,  // (K, M) or null
                    const double* __restrict__ pre_v,       // (K, M)
                    const double* __restrict__ pre_c,
                    const double* __restrict__ capacity,    // (M,)
                    const double* __restrict__ L_vpn,
                    const double* __restrict__ lease_cci,   // L_cci + V_cci
                    const double* __restrict__ c_cci,
                    const double* __restrict__ bounds,      // (M, Kt)
                    const double* __restrict__ rates,
                    const double* __restrict__ theta1,
                    const double* __restrict__ theta2,
                    const int* __restrict__ win,
                    const int* __restrict__ delay,
                    const int* __restrict__ commit,
                    const int* __restrict__ up_hold,
                    const int* __restrict__ down_hold,
                    const double* __restrict__ cal_in,      // (2, M) dcum, dcum_month
                    const int* __restrict__ fsm_in,         // (4, M)
                    const double* __restrict__ pref_in,     // (2, M)
                    int renew_in_chunks, int t0, int phase0, int hours_per_month,
                    int K, int M, int Kt,
                    double* out,                            // (8K + 4, M): written, snap rows read back
                    int* __restrict__ fsm_out) {            // (4, M)
  __shared__ Tile sm;
  extern __shared__ double tables[];       // bounds (kRows, Kt), then rates (kRows, Kt)
  const int n0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - n0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kk = tid / kRows;              // this thread's hour in every tile
  const int r = tid % kRows;               // and its row
  const int n = n0 + r;
  const bool has_row = r < rows;
  const int64_t KM = (int64_t)K * M;

  // Per-row operands, loaded once: the pair threads' ...
  double cap = 0.0, lvpn = 0.0, lease = 0.0, cc = 0.0;
  fsm::FsmRow pr = {};                     // the thresholds the window sums meet
  int h = 0;
  if (has_row) {
    cap = capacity[n];
    lvpn = L_vpn[n];
    lease = lease_cci[n];
    cc = c_cci[n];
    pr.theta1 = theta1[n];
    pr.theta2 = theta2[n];
    h = win[n];
  }
  // ... and the chain lanes': warp 0 the calendar and the cost prefixes,
  // warp 1 the FSM carry.
  const bool chain = warp < 2 && lane < rows;
  const int cn = n0 + lane;
  fsm::FsmRow p = {};
  fsm::FsmCarry fc = {};
  double dcum = 0.0, month = 0.0, pv = 0.0, pc = 0.0;
  int ph = phase0;                         // (t0 + k) % hours_per_month
  if (chain) {
    p = {theta1[cn], theta2[cn], delay[cn], commit[cn], up_hold[cn], down_hold[cn],
         renew_in_chunks != 0};
    if (warp == 0) {
      dcum = cal_in[cn];
      month = cal_in[M + cn];
      pv = pref_in[cn];
      pc = pref_in[M + cn];
    } else {
      fc = {fsm_in[cn], fsm_in[M + cn], fsm_in[2 * M + cn], fsm_in[3 * M + cn], 0};
    }
  }
  const double* tb = tables + r * Kt;                 // this thread's row's table
  const double* tr = tables + (kRows + r) * Kt;

  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int len = min(kTile, K - k0);
    const bool mine = has_row && kk < len;
    const int64_t i = (int64_t)(k0 + kk) * M + n;

    // (0) stage: every load first, then the tables (first tile), then the stores
    double dv = 0.0, cv = 0.0, bv = 0.0, bc = 0.0;
    if (mine) {
      dv = demand[i];
      if (cci_demand != nullptr) cv = cci_demand[i];
      bv = pre_v[i];
      bc = pre_c[i];
    }
    if (k0 == 0) {
      for (int o = tid; o < rows * Kt; o += kThreads) {
        tables[o] = bounds[(int64_t)n0 * Kt + o];
        tables[kRows * Kt + o] = rates[(int64_t)n0 * Kt + o];
      }
    }
    if (mine) {
      const int lw = max(0, t0 + k0 + kk - h);
      if (lw >= t0 && lw < t0 + k0) {                 // an earlier tile's snapshot
        const int64_t j = (int64_t)(lw - t0) * M + n;
        bv = out[4 * KM + j];
        bc = out[5 * KM + j];
      }
      const double d = minimum(dv, cap);
      sm.d[kk][r] = d;
      sm.dc[kk][r] = cci_demand != nullptr ? minimum(cv, cap) : d;
      sm.bv[kk][r] = bv;
      sm.bc[kk][r] = bc;
    }
    __syncthreads();

    // (a) the billing calendar
    if (chain && warp == 0) {
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        if (ph == 0) month = dcum;
        sm.lo[k][lane] = __dsub_rn(dcum, month);
        dcum = __dadd_rn(dcum, sm.d[k][lane]);
        ph = ph + 1 == hours_per_month ? 0 : ph + 1;
      }
    }
    __syncthreads();

    // (b) the tier fold and the cost planes
    if (mine) {
      const double lo = sm.lo[kk][r], d = sm.d[kk][r];
      const double transfer = tier::fold_with(lo, d, [tb](int t) { return tb[t]; },
                                              [tr](int t) { return tr[t]; }, Kt);
      const double v = __dadd_rn(lvpn, transfer);
      const double c = __dadd_rn(lease, __dmul_rn(cc, sm.dc[kk][r]));
      sm.vpn[kk][r] = v;
      sm.cci[kk][r] = c;
      out[i] = v;
      out[KM + i] = c;
    }
    __syncthreads();

    // (c1) the cost prefixes' snapshots: one add an hour on the chain
    if (chain && warp == 0) {
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        sm.sv[k][lane] = pv;
        sm.sc[k][lane] = pc;
        pv = __dadd_rn(pv, sm.vpn[k][lane]);
        pc = __dadd_rn(pc, sm.cci[k][lane]);
      }
    }
    __syncthreads();

    // (c2) every pair: the window sums, the raw triggers, and the stores of
    // the window sums and snapshots
    if (mine) {
      const int lw = max(0, t0 + k0 + kk - h);
      const bool in_tile = lw >= t0 + k0;   // its own snapshots (lw - t0 - k0 <= kk)
      const int j = in_tile ? lw - t0 - k0 : kk;
      const double sv = sm.sv[kk][r], sc = sm.sc[kk][r];
      const double rv = __dsub_rn(sv, in_tile ? sm.sv[j][r] : sm.bv[kk][r]);
      const double rc = __dsub_rn(sc, in_tile ? sm.sc[j][r] : sm.bc[kk][r]);
      bool raw_req, raw_rel;
      fsm::fsm_triggers(pr, rv, rc, raw_req, raw_rel);
      sm.trig[kk][r] = (int)raw_req | (int)raw_rel << 1;
      out[2 * KM + i] = rv;
      out[3 * KM + i] = rc;
      out[4 * KM + i] = sv;
      out[5 * KM + i] = sc;
    }
    __syncthreads();

    // (c3) the FSM, integers only
    if (chain && warp == 1) {
      if (k0 == 0) fc.phase = fc.t_state % p.T_cci;
#pragma unroll 8
      for (int k = 0; k < len; ++k) {
        const int t = sm.trig[k][lane];
        sm.state[k][lane] = fsm::fsm_step(p, fc, t & 1, t >> 1, p.renew_in_chunks);
      }
    }
    __syncthreads();

    // (d) x and state, as float64
    if (mine) {
      const int s = sm.state[kk][r];
      out[6 * KM + i] = s == fsm::kOn ? 1.0 : 0.0;
      out[7 * KM + i] = (double)s;
    }
    __syncthreads();   // the next tile reads these snapshots and reuses sm
  }

  if (chain && warp == 0) {
    const int64_t e = 8 * KM + cn;
    out[e] = dcum;
    out[e + M] = month;
    out[e + 2 * M] = pv;
    out[e + 3 * M] = pc;
  } else if (chain) {
    fsm_out[cn] = fc.state;
    fsm_out[M + cn] = fc.t_state;
    fsm_out[2 * M + cn] = fc.up;
    fsm_out[3 * M + cn] = fc.down;
  }
}

}  // namespace

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
                                int M, int Kt, double* out, int* fsm_out, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  if (M < 0 || K < 1 || Kt < 0 || t0 < 0 || hours_per_month < 1)
    return (int)cudaErrorInvalidValue;
  const size_t tables = sizeof(double) * 2 * kRows * (size_t)Kt;
  if (sizeof(Tile) + tables > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (sizeof(Tile) + tables > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tables);
    if (err != cudaSuccess) return (int)err;
  }
  stream_chunk_kernel<<<(M + kRows - 1) / kRows, kThreads, tables, (cudaStream_t)stream>>>(
      demand, cci_demand, pre_v, pre_c, capacity, L_vpn, lease_cci, c_cci, bounds, rates,
      theta1, theta2, h, D, T_cci, up_hold, down_hold, cal_in, fsm_in, pref_in,
      renew_in_chunks, t0, t0 % hours_per_month, hours_per_month, K, M, Kt, out, fsm_out);
  return (int)cudaGetLastError();
}
