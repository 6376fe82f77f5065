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
// What bounds it on an H100: device-memory bytes in principle. Each element
// reads vpn and cci (2 x 8 B) and writes x and state (2 x 4 B): 24 B per
// element, 26.9 MB at 128 x 8760 and 430 MB at 2048 x 8760, and ~10 float64
// operations. In practice this first kernel is bound by latency: each row is
// one thread walking its T hours in order, so only N threads are in flight
// (2048 at most on the main path, a small fraction of the 132 SMs' capacity)
// and a warp's 32 loads of one hour touch 32 rows T x 8 B apart, which is not
// coalesced. Rows one thread each keeps every row's arithmetic sequential and
// exact; a layout that coalesces (hour-major planes, or a warp per row with a
// shuffle scan) is left to a later change.
//
// Exactness: the thread keeps two float64 running prefixes of vpn (and two of
// cci) in registers: pref[t] = v[0] + ... + v[t-1], added in order, and the
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
// at the runtime's K = 24 that is 3.5 MB, ~1.1 us at 3.35 TB/s, so a chunk is
// bound by the launch and the K-step dependent chain, not by bytes. The
// hour step (fsm_hour) is the one fsm_scan takes, so both kernels decide alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOff = 0;
constexpr int kWaiting = 1;
constexpr int kOn = 2;

// One row's policy parameters (hold counts of 1 make the hysteresis rule the
// reactive one).
struct FsmRow {
  double theta1, theta2;
  int D, T_cci, up_hold, down_hold;
  bool renew_in_chunks;
};

// One row's FSM carry: state, hours in state, consecutive trigger hours.
struct FsmCarry {
  int state, t_state, up, down;
};

// One hour of the policy step: triggers from the window sums, the hold
// counts, then the cascade of _fsm_cascade (request, provisioning done,
// release). Returns the state that serves the hour; t_state then counts it.
__device__ __forceinline__ int fsm_hour(const FsmRow& p, FsmCarry& c,
                                        double r_vpn, double r_cci) {
  const bool raw_req = r_cci < __dmul_rn(p.theta1, r_vpn);
  const bool raw_rel = r_cci > __dmul_rn(p.theta2, r_vpn);
  c.up = raw_req ? c.up + 1 : 0;
  c.down = raw_rel ? c.down + 1 : 0;
  const bool req = raw_req && c.up >= p.up_hold;
  const bool rel = raw_rel && c.down >= p.down_hold;

  if (c.state == kOff && req) { c.state = kWaiting; c.t_state = 0; }
  if (c.state == kWaiting && c.t_state >= p.D) { c.state = kOn; c.t_state = 0; }
  const bool past_commit = c.t_state >= p.T_cci;
  const bool check = p.renew_in_chunks ? (past_commit && (c.t_state % p.T_cci) == 0)
                                       : past_commit;
  if (c.state == kOn && check && rel) { c.state = kOff; c.t_state = 0; }
  const int s = c.state;
  c.t_state += 1;
  return s;
}

__global__ void fsm_scan_kernel(const double* __restrict__ vpn,
                                const double* __restrict__ cci,
                                const double* __restrict__ theta1,
                                const double* __restrict__ theta2,
                                const int* __restrict__ win,
                                const int* __restrict__ delay,
                                const int* __restrict__ commit,
                                const int* __restrict__ up_hold,
                                const int* __restrict__ down_hold,
                                int renew_in_chunks, int N, int T,
                                int* __restrict__ x_out,
                                int* __restrict__ state_out,
                                double* __restrict__ total_out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const FsmRow p = {theta1[n], theta2[n], delay[n], commit[n], up_hold[n],
                    down_hold[n], renew_in_chunks != 0};
  const int h = win[n];
  const double* v = vpn + (int64_t)n * T;
  const double* c = cci + (int64_t)n * T;
  int* xo = x_out + (int64_t)n * T;
  int* so = state_out + (int64_t)n * T;

  double pv = 0.0, pc = 0.0;    // pref[t]: sum of hours [0, t)
  double lv = 0.0, lc = 0.0;    // pref[max(0, t - h)]
  double total = 0.0;
  FsmCarry fc = {kOff, 0, 0, 0};
  for (int t = 0; t < T; ++t) {
    const int k = t - h - 1;
    if (k >= 0) {
      lv = __dadd_rn(lv, v[k]);
      lc = __dadd_rn(lc, c[k]);
    }
    const double r_vpn = __dsub_rn(pv, lv);
    const double r_cci = __dsub_rn(pc, lc);

    const int s = fsm_hour(p, fc, r_vpn, r_cci);

    const double vt = v[t], ct = c[t];
    xo[t] = s == kOn ? 1 : 0;
    so[t] = s;
    total = __dadd_rn(total, s == kOn ? ct : vt);
    pv = __dadd_rn(pv, vt);
    pc = __dadd_rn(pc, ct);
  }
  total_out[n] = total;
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
                 carry_in[3 * M + m]};
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

}  // namespace

extern "C" int fsm_scan_f64(const double* vpn, const double* cci,
                            const double* theta1, const double* theta2,
                            const int* h, const int* D, const int* T_cci,
                            const int* up_hold, const int* down_hold,
                            int renew_in_chunks, int N, int T,
                            int* x, int* state, double* total, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  // 32 threads a block spreads the rows over as many SMs (and L1 caches) as
  // there are warps.
  const int threads = 32;
  const int blocks = (N + threads - 1) / threads;
  fsm_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      vpn, cci, theta1, theta2, h, D, T_cci, up_hold, down_hold,
      renew_in_chunks, N, T, x, state, total);
  return (int)cudaGetLastError();
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
