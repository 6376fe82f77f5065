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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOff = 0;
constexpr int kWaiting = 1;
constexpr int kOn = 2;

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
  const double th1 = theta1[n], th2 = theta2[n];
  const int h = win[n], D = delay[n], T_cci = commit[n];
  const int uh = up_hold[n], dh = down_hold[n];
  const double* v = vpn + (int64_t)n * T;
  const double* c = cci + (int64_t)n * T;
  int* xo = x_out + (int64_t)n * T;
  int* so = state_out + (int64_t)n * T;

  double pv = 0.0, pc = 0.0;    // pref[t]: sum of hours [0, t)
  double lv = 0.0, lc = 0.0;    // pref[max(0, t - h)]
  double total = 0.0;
  int state = kOff, t_state = 0, up = 0, down = 0;
  for (int t = 0; t < T; ++t) {
    const int k = t - h - 1;
    if (k >= 0) {
      lv = __dadd_rn(lv, v[k]);
      lc = __dadd_rn(lc, c[k]);
    }
    const double r_vpn = __dsub_rn(pv, lv);
    const double r_cci = __dsub_rn(pc, lc);

    // Policy triggers: hold counts of 1 make this the reactive rule.
    const bool raw_req = r_cci < __dmul_rn(th1, r_vpn);
    const bool raw_rel = r_cci > __dmul_rn(th2, r_vpn);
    up = raw_req ? up + 1 : 0;
    down = raw_rel ? down + 1 : 0;
    const bool req = raw_req && up >= uh;
    const bool rel = raw_rel && down >= dh;

    // The cascade of _fsm_cascade: request, provisioning done, release.
    if (state == kOff && req) { state = kWaiting; t_state = 0; }
    if (state == kWaiting && t_state >= D) { state = kOn; t_state = 0; }
    const bool past_commit = t_state >= T_cci;
    const bool check = renew_in_chunks ? (past_commit && (t_state % T_cci) == 0)
                                       : past_commit;
    if (state == kOn && check && rel) { state = kOff; t_state = 0; }

    const double vt = v[t], ct = c[t];
    xo[t] = state == kOn ? 1 : 0;
    so[t] = state;
    total = __dadd_rn(total, state == kOn ? ct : vt);
    pv = __dadd_rn(pv, vt);
    pc = __dadd_rn(pc, ct);
    t_state += 1;
  }
  total_out[n] = total;
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
