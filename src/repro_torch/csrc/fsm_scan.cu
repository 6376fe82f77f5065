// ToggleCCI FSM scan over a fleet: window sums, OFF->WAITING->ON cascade and
// the toggle cost, for N rows of T hours each, in one launch.
//
// Replaces: the jax.lax.scan of src/repro/fleet/policy.py::policy_scan
// (vmapped over rows by src/repro/fleet/engine.py::_run_policies), with the
// window sums of src/repro/core/togglecci.py::window_sums and the step of
// policy.py::_fsm_cascade / ReactivePolicy.step / HysteresisPolicy.step. The
// JAX package has no Pallas kernel for it; on the GPU an eager loop over T
// would launch ~10^5 small kernels per plan.
//
// What bounds it on an H100. Each element reads vpn and cci (2 x 8 B) and
// writes x and state (2 x 4 B): 24 B per element, 26.9 MB at 128 x 8760 and
// 430 MB at 2048 x 8760 (0.13 ms at 3.35 TB/s), and ~11 float64 operations.
// But each row is one dependent chain of T hours (the prefixes, the FSM carry,
// the toggle cost), and the rows are few: 2048 on the main path, one thread
// each. So the kernel is bound by the latency of one hour's step on one
// thread, times T, as long as the data is at hand when the step needs it.
//
// Design. A block owns kRows = 16 rows, so that 2048 rows take 128 of the 132
// SMs, one block each (the chains run in SIMT, so a block takes as long for 8
// rows as for 16: fewer rows a block only spread small fleets over more SMs,
// and timed no faster; a fleet past 132 x 16 rows runs in waves). Each row's
// chain is cut into three dependent chains that share no value within a tile
// of kTile hours, and each runs in a warp of its own, lane r on row r, one
// tile behind the other: at step j, warp 0 forms tile j's float64 prefixes,
// window sums and raw triggers (one bit per hour, shifted into two 64-bit
// masks), warp 1 runs the FSM over tile j - 1's masks (integers only; its
// decisions go into two more masks), warp 2 adds tile j - 2's toggle cost in
// hour order. Two copy warps stage tile j + kAhead from device memory with
// cp.async and write tile j - 2's x and state back from the decision masks,
// lanes over hours. Four streams are staged per tile: vpn and cci at hours
// [t0, t0 + kTile), and the lagged vpn and cci at each row's own offset
// t0 - h - 1 (from L2: the lead stream read them h + 1 hours earlier, 2048
// x 337 x 16 B = 11 MB at the scenario's widest window; +0.0 before hour 0). A
// segment of a row is contiguous, so the copies are coalesced; they are 8
// bytes each, which any row start (T x 8 B apart, any T, any view) allows, and
// hours past T are never copied. Rows of shared memory are padded to kTile + 1
// words so that the chain lanes (one row each) hit distinct banks. One
// __syncthreads per step hands the tiles on.
//
// The gated instance (GATED = true) runs ForecastGatedPolicy: it replaces the
// same lax.scan under src/repro/fleet/policy.py::ForecastGatedPolicy.step
// (:290-305). Two more lead streams, the predicted mode costs p_vpn and p_cci
// (N, T) float64, are staged beside the lagged ones (kLag slots, no lagged
// copy), and the sums warp turns each hour's raw triggers into the gated ones
// (fsm_step.cuh::fsm_gated_triggers, with each row's margin formed into its
// four thresholds once); the FSM warp, the cost warp and their masks are the
// reactive instance's, with hold counts of 1. It reads 40 B an element (717.6
// MB at 2048 x 8760, 0.214 ms at 3.35 TB/s) and its sums warp runs four more
// products and compares an hour.
//
// What bounds it now: the instructions the FSM warp and the sums warp run,
// hour after hour, on every row at once (PERF.md has the time an hour). The
// loops are unrolled by 8, not by the tile: fully unrolled, the four warps'
// loops do not fit the SM's instruction cache, and with every SM fetching
// code from L2 the kernel slowed down as more SMs ran it.
//
// Exactness: the sums warp keeps two float64 running prefixes of vpn (and two
// of cci) in registers: pref[t] = v[0] + ... + v[t-1], added in order, and the
// same sum lagging h hours behind, pref[max(0, t-h)], which adds v[t-h-1]
// once t > h. A prefix summed in order is the same number whenever it is
// formed, so the lagging one equals pref[t-h] bit for bit without a scratch
// plane, and the window sums r[t] = pref[t] - pref[max(0, t-h)] equal the
// plain version's, which subtracts two entries of a sequential cumsum (the
// CPU's torch.cumsum). Every add and product uses __dadd_rn / __dmul_rn and
// the file is compiled with -fmad=false. total_cost sums (x ? cci : vpn) in
// hour order.
//
// fsm_chunk, the second kernel here, is the streaming runtime's FSM: K hours
// from a carry (state, t_state, up, down and the two float64 prefixes) in,
// the carry out. It replaces the jax.lax.scan of
// src/repro/fleet/runtime.py::_build_step_many (runtime.py:577) together with
// that chunk's prefix-snapshot scan and window gather (runtime.py:501-515).
// Its planes are hour-major (K, M), so unlike fsm_scan its loads and stores
// are coalesced. Bound on an H100: it reads four (K, M) float64 planes and
// writes four float64 and two int32 planes, 0.15 MB per hour at M = 2048;
// at the runtime's K = 24 that is 3.5 MB, ~1.1 us at 3.35 TB/s. What holds it
// back is not the launch (PERF.md times it on the device, launch excluded):
// one thread per row in one-warp blocks walks its K hours and loads each hour's
// planes when it needs them, and snap_v/snap_c, written and read back in the
// same loop, keep every load behind the previous hour's stores, so each hour
// waits a device-memory round trip. The
// hour step (fsm_triggers, fsm_step, from fsm_step.cuh) is the one fsm_scan
// and stream_chunk.cu take, so all three decide alike. The streaming runtime
// now runs stream_chunk, which fuses this kernel with the calendar pricing;
// fsm_chunk stays as its same-run yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fsm_step.cuh"

namespace {

using fsm::FsmCarry;
using fsm::FsmGate;
using fsm::FsmRow;
using fsm::fsm_gate;
using fsm::fsm_gated_triggers;
using fsm::fsm_hour;
using fsm::fsm_step;
using fsm::fsm_triggers;
using fsm::kOn;
using fsm::kWaiting;
using fsm::kOff;

constexpr int kRows = 16;                 // rows a block, one lane each
constexpr int kTile = 64;                 // hours per staged tile: one bit each in a mask
constexpr int kAhead = 2;                 // tiles in flight ahead of the sums warp
constexpr int kLead = kAhead + 3;         // tiles of vpn/cci in the ring: j - 2 .. j + kAhead
constexpr int kLag = kAhead + 1;          // tiles of lagged vpn/cci: j .. j + kAhead
constexpr int kPad = kTile + 1;           // row stride in shared memory (words)
constexpr int kCopyWarps = 2;
constexpr int kScanThreads = 32 * (3 + kCopyWarps);   // sums, FSM, cost, copies

// The rings of one fsm_scan block. Tile t's vpn/cci sit in lead
// slot t % kLead, its lagged vpn/cci (hours t0 - h - 1 + i, +0.0 before hour
// 0) in lag slot t % kLag, its trigger and decision masks (bit i = hour
// t0 + i) in mask slot t % 2.
struct ScanTiles {
  double v[kLead][kRows][kPad], c[kLead][kRows][kPad];
  double vl[kLag][kRows][kPad], cl[kLag][kRows][kPad];
  uint64_t req[2][kRows], rel[2][kRows], on[2][kRows], wait[2][kRows];
  int64_t base[kRows];                      // row r's first element
  int lag[kRows];                           // h + 1
};

// The gated instance's predicted mode costs of tile t, in slot t % kLag
// (after the ScanTiles in shared memory).
struct GateTiles {
  double pv[kLag][kRows][kPad], pc[kLag][kRows][kPad];
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy warp cw: stage tile j (a no-op past the last tile) for rows cw,
// cw + kCopyWarps, ..., lanes over hours. A lagged slot before hour 0 gets +0.0:
// adding it leaves a prefix that starts at +0.0 (and so is never -0.0) as it
// is. The gated instance also stages the tile's predicted costs.
template <bool GATED>
__device__ __forceinline__ void stage_tile(ScanTiles& sm, GateTiles* gt, int j,
                                           const double* vpn, const double* cci,
                                           const double* p_vpn, const double* p_cci, int rows,
                                           int T, int cw, int lane) {
  const int t0 = j * kTile;
  if (t0 >= T) return;
  const int len = min(kTile, T - t0);
  const int bl = j % kLead, bg = j % kLag;
  for (int r = cw; r < rows; r += kCopyWarps) {
    const double* vr = vpn + sm.base[r];
    const double* cr = cci + sm.base[r];
    const int64_t k0 = (int64_t)t0 - sm.lag[r];
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < len) {
        cp_async8(&sm.v[bl][r][i], vr + t0 + i);
        cp_async8(&sm.c[bl][r][i], cr + t0 + i);
        if (k0 + i >= 0) {
          cp_async8(&sm.vl[bg][r][i], vr + (k0 + i));
          cp_async8(&sm.cl[bg][r][i], cr + (k0 + i));
        } else {
          sm.vl[bg][r][i] = 0.0;
          sm.cl[bg][r][i] = 0.0;
        }
        if (GATED) {
          cp_async8(&gt->pv[bg][r][i], p_vpn + sm.base[r] + t0 + i);
          cp_async8(&gt->pc[bg][r][i], p_cci + sm.base[r] + t0 + i);
        }
      }
    }
  }
}

// The sums warp, one hour of a row: the lagged and leading prefixes, the
// window sums, and the hour's raw triggers (gated, in the gated instance, by
// the hour's predicted costs PV[i], PC[i]), shifted into two masks from the
// top (after a whole tile, bit i is hour t0 + i).
struct Sums {
  double pv = 0.0, pc = 0.0;    // pref[t]: sum of hours [0, t)
  double lv = 0.0, lc = 0.0;    // pref[max(0, t - h)]
  template <bool GATED>
  __device__ __forceinline__ void hour(const FsmRow& p, const FsmGate& g, const double* V,
                                       const double* C, const double* VL, const double* CL,
                                       const double* PV, const double* PC, int i,
                                       uint64_t& req, uint64_t& rel) {
    lv = __dadd_rn(lv, VL[i]);
    lc = __dadd_rn(lc, CL[i]);
    bool raw_req, raw_rel;
    fsm_triggers(p, __dsub_rn(pv, lv), __dsub_rn(pc, lc), raw_req, raw_rel);
    if (GATED) fsm_gated_triggers(g, PV[i], PC[i], raw_req, raw_rel);
    req = req >> 1 | (uint64_t)raw_req << 63;
    rel = rel >> 1 | (uint64_t)raw_rel << 63;
    pv = __dadd_rn(pv, V[i]);
    pc = __dadd_rn(pc, C[i]);
  }
};

// A mask of len < kTile hours shifted in from the top, moved down to bit 0.
__device__ __forceinline__ uint64_t settle(uint64_t m, int len) {
  return len < kTile ? m >> (kTile - len) : m;
}

// The FSM warp, one hour of a row: the step from the hour's trigger bits
// (bit 0 of the masks, shifted out), and the decision shifted into two masks.
template <bool RENEW>
__device__ __forceinline__ void decide_hour(const FsmRow& p, FsmCarry& fc, uint64_t& req,
                                            uint64_t& rel, uint64_t& on, uint64_t& wait) {
  const int s = fsm_step(p, fc, req & 1, rel & 1, RENEW);
  req >>= 1;
  rel >>= 1;
  on = on >> 1 | (uint64_t)(s == kOn) << 63;
  wait = wait >> 1 | (uint64_t)(s == kWaiting) << 63;
}

// Copy warp cw: write tile t's x and state for rows cw, cw + kCopyWarps,
// ..., from the decision masks, lanes over hours.
__device__ __forceinline__ void store_tile(const ScanTiles& sm, int t, int* x_out,
                                           int* state_out, int rows, int T, int cw,
                                           int lane) {
  const int t0 = t * kTile, len = min(kTile, T - t0);
  for (int r = cw; r < rows; r += kCopyWarps) {
    const uint64_t on = sm.on[t % 2][r], wait = sm.wait[t % 2][r];
    int* xr = x_out + sm.base[r] + t0;
    int* sr = state_out + sm.base[r] + t0;
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < len) {
        const int is_on = (int)((on >> i) & 1);
        xr[i] = is_on;
        sr[i] = is_on ? kOn : (int)((wait >> i) & 1);
      }
    }
  }
}

// Each row is walked by three warps one tile apart, lane r on row n0 + r:
// at step j, warp 0 sums tile j, warp 1 decides tile j - 1 and warp 2 adds
// tile j - 2's toggle cost in hour order, while the copy warps stage tile
// j + kAhead and write tile j - 2's x and state. One __syncthreads per step
// hands the tiles on. p_vpn, p_cci and margin are read by the gated instance
// only.
template <bool RENEW, bool GATED>
__global__ void __launch_bounds__(kScanThreads)
fsm_scan_kernel(const double* __restrict__ vpn, const double* __restrict__ cci,
                const double* __restrict__ p_vpn, const double* __restrict__ p_cci,
                const double* __restrict__ margin,
                const double* __restrict__ theta1, const double* __restrict__ theta2,
                const int* __restrict__ win, const int* __restrict__ delay,
                const int* __restrict__ commit, const int* __restrict__ up_hold,
                const int* __restrict__ down_hold, int N, int T,
                int* __restrict__ x_out, int* __restrict__ state_out,
                double* __restrict__ total_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanTiles& sm = *reinterpret_cast<ScanTiles*>(smem_raw);
  GateTiles* gt = GATED ? reinterpret_cast<GateTiles*>(smem_raw + sizeof(ScanTiles)) : nullptr;
  const int64_t n0 = (int64_t)blockIdx.x * kRows;
  const int rows = (int)min((int64_t)kRows, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (T + kTile - 1) / kTile;
  if ((int)threadIdx.x < rows) {
    sm.base[threadIdx.x] = (n0 + threadIdx.x) * (int64_t)T;
    sm.lag[threadIdx.x] = win[n0 + threadIdx.x] + 1;
  }
  __syncthreads();
  if (warp >= 3) {
    for (int j = 0; j < kAhead; ++j) {
      stage_tile<GATED>(sm, gt, j, vpn, cci, p_vpn, p_cci, rows, T, warp - 3, lane);
      cp_async_commit();
    }
  }
  const bool mine = lane < rows;                 // lane r walks row n0 + r
  const int64_t n = n0 + lane;
  FsmRow p = {};
  if (mine && warp < 2)
    p = {theta1[n], theta2[n], delay[n], commit[n], up_hold[n], down_hold[n], RENEW};
  FsmGate g = {};
  if (GATED && mine && warp == 0) g = fsm_gate(p, margin[n]);
  Sums sums;
  FsmCarry fc = {kOff, 0, 0, 0, 0};
  double total = 0.0;

  for (int j = 0; j <= n_tiles + 1; ++j) {
    if (warp >= 3) cp_async_wait<kAhead - 1>();  // tile j has landed
    __syncthreads();
    if (warp == 0) {
      if (mine && j < n_tiles) {
        const int len = min(kTile, T - j * kTile);
        const double *V = sm.v[j % kLead][lane], *C = sm.c[j % kLead][lane];
        const double *VL = sm.vl[j % kLag][lane], *CL = sm.cl[j % kLag][lane];
        const double* PV = GATED ? gt->pv[j % kLag][lane] : nullptr;
        const double* PC = GATED ? gt->pc[j % kLag][lane] : nullptr;
        uint64_t req = 0, rel = 0;
#pragma unroll 8
        for (int i = 0; i < len; ++i)
          sums.hour<GATED>(p, g, V, C, VL, CL, PV, PC, i, req, rel);
        sm.req[j % 2][lane] = settle(req, len);
        sm.rel[j % 2][lane] = settle(rel, len);
      }
    } else if (warp == 1) {
      const int t = j - 1;
      if (mine && t >= 0 && t < n_tiles) {
        const int len = min(kTile, T - t * kTile);
        uint64_t req = sm.req[t % 2][lane], rel = sm.rel[t % 2][lane], on = 0, wait = 0;
#pragma unroll 8
        for (int i = 0; i < len; ++i) decide_hour<RENEW>(p, fc, req, rel, on, wait);
        sm.on[t % 2][lane] = settle(on, len);
        sm.wait[t % 2][lane] = settle(wait, len);
      }
    } else if (warp == 2) {
      const int t = j - 2;
      if (mine && t >= 0) {
        const int len = min(kTile, T - t * kTile);
        uint64_t on = sm.on[t % 2][lane];
        const double *V = sm.v[t % kLead][lane], *C = sm.c[t % kLead][lane];
#pragma unroll 8
        for (int i = 0; i < len; ++i, on >>= 1) total = __dadd_rn(total, on & 1 ? C[i] : V[i]);
      }
    } else {
      stage_tile<GATED>(sm, gt, j + kAhead, vpn, cci, p_vpn, p_cci, rows, T, warp - 3, lane);
      cp_async_commit();
      if (j >= 2) store_tile(sm, j - 2, x_out, state_out, rows, T, warp - 3, lane);
    }
  }
  if (mine && warp == 2) total_out[n] = total;
}

// K hours of the FSM from a carry, for the streaming runtime's chunk. Planes
// are hour-major (K, M): a warp's 32 loads of one hour are contiguous.
// Window reads older than the chunk (lo = max(0, t0 + k - h) < t0) come from
// the host's prefix ring, pre_v/pre_c; younger ones from the prefix snapshots
// this thread wrote earlier in the chunk (snap[k] = pref before hour t0 + k,
// the exclusive-prefix convention of the runtime's rings).
__global__ void fsm_chunk_kernel(const double* __restrict__ vpn,
                                 const double* __restrict__ cci,
                                 const double* __restrict__ pre_v,
                                 const double* __restrict__ pre_c,
                                 const double* __restrict__ theta1,
                                 const double* __restrict__ theta2,
                                 const int* __restrict__ win,
                                 const int* __restrict__ delay,
                                 const int* __restrict__ commit,
                                 const int* __restrict__ up_hold,
                                 const int* __restrict__ down_hold,
                                 int renew_in_chunks, int t0, int K, int M,
                                 const int* __restrict__ carry_in,     // (4, M)
                                 const double* __restrict__ pref_in,   // (2, M)
                                 int* __restrict__ x_out,
                                 int* __restrict__ state_out,
                                 double* __restrict__ rv_out,
                                 double* __restrict__ rc_out,
                                 double* snap_v,                       // written, then read
                                 double* snap_c,
                                 int* __restrict__ carry_out,
                                 double* __restrict__ pref_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const FsmRow p = {theta1[m], theta2[m], delay[m], commit[m], up_hold[m],
                    down_hold[m], renew_in_chunks != 0};
  const int h = win[m];
  FsmCarry fc = {carry_in[m], carry_in[M + m], carry_in[2 * M + m],
                 carry_in[3 * M + m], carry_in[M + m] % p.T_cci};
  double pv = pref_in[m], pc = pref_in[M + m];
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * M + m;
    snap_v[i] = pv;
    snap_c[i] = pc;
    const int lo = max(0, t0 + k - h);
    double bv, bc;
    if (lo >= t0) {
      const int64_t j = (int64_t)(lo - t0) * M + m;  // lo - t0 <= k: written
      bv = snap_v[j];
      bc = snap_c[j];
    } else {
      bv = pre_v[i];
      bc = pre_c[i];
    }
    const double r_vpn = __dsub_rn(pv, bv);
    const double r_cci = __dsub_rn(pc, bc);
    rv_out[i] = r_vpn;
    rc_out[i] = r_cci;
    const int s = fsm_hour(p, fc, r_vpn, r_cci);
    x_out[i] = s == kOn ? 1 : 0;
    state_out[i] = s;
    pv = __dadd_rn(pv, vpn[i]);
    pc = __dadd_rn(pc, cci[i]);
  }
  carry_out[m] = fc.state;
  carry_out[M + m] = fc.t_state;
  carry_out[2 * M + m] = fc.up;
  carry_out[3 * M + m] = fc.down;
  pref_out[m] = pv;
  pref_out[M + m] = pc;
}

template <bool RENEW, bool GATED>
int launch_scan(const double* vpn, const double* cci, const double* p_vpn,
                const double* p_cci, const double* margin, const double* theta1,
                const double* theta2, const int* h, const int* D, const int* T_cci,
                const int* up_hold, const int* down_hold, int N, int T, int* x, int* state,
                double* total, cudaStream_t stream) {
  const int smem = (int)(sizeof(ScanTiles) + (GATED ? sizeof(GateTiles) : 0));
  cudaError_t err = cudaFuncSetAttribute(fsm_scan_kernel<RENEW, GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fsm_scan_kernel<RENEW, GATED><<<(N + kRows - 1) / kRows, kScanThreads, smem, stream>>>(
      vpn, cci, p_vpn, p_cci, margin, theta1, theta2, h, D, T_cci, up_hold, down_hold, N, T,
      x, state, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fsm_scan_f64(const double* vpn, const double* cci,
                            const double* theta1, const double* theta2,
                            const int* h, const int* D, const int* T_cci,
                            const int* up_hold, const int* down_hold,
                            int renew_in_chunks, int N, int T,
                            int* x, int* state, double* total, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const auto launch = renew_in_chunks ? launch_scan<true, false> : launch_scan<false, false>;
  return launch(vpn, cci, nullptr, nullptr, nullptr, theta1, theta2, h, D, T_cci, up_hold,
                down_hold, N, T, x, state, total, (cudaStream_t)stream);
}

// The gated instance: ForecastGatedPolicy over (N, T) cost planes and its
// (N, T) predicted mode costs, with per-row margins.
extern "C" int fsm_scan_gated_f64(const double* vpn, const double* cci,
                                  const double* p_vpn, const double* p_cci,
                                  const double* margin, const double* theta1,
                                  const double* theta2, const int* h, const int* D,
                                  const int* T_cci, const int* up_hold, const int* down_hold,
                                  int renew_in_chunks, int N, int T,
                                  int* x, int* state, double* total, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const auto launch = renew_in_chunks ? launch_scan<true, true> : launch_scan<false, true>;
  return launch(vpn, cci, p_vpn, p_cci, margin, theta1, theta2, h, D, T_cci, up_hold,
                down_hold, N, T, x, state, total, (cudaStream_t)stream);
}

extern "C" int fsm_chunk_f64(const double* vpn, const double* cci,
                             const double* pre_v, const double* pre_c,
                             const double* theta1, const double* theta2,
                             const int* h, const int* D, const int* T_cci,
                             const int* up_hold, const int* down_hold,
                             int renew_in_chunks, int t0, int K, int M,
                             const int* carry_in, const double* pref_in,
                             int* x, int* state, double* r_vpn, double* r_cci,
                             double* snap_v, double* snap_c, int* carry_out,
                             double* pref_out, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  const int threads = 32;
  const int blocks = (M + threads - 1) / threads;
  fsm_chunk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold, down_hold,
      renew_in_chunks, t0, K, M, carry_in, pref_in, x, state, r_vpn, r_cci,
      snap_v, snap_c, carry_out, pref_out);
  return (int)cudaGetLastError();
}
