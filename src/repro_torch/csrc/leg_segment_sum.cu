// Leg-ordered segment sum: demand rows folded onto ports, leg by leg in order.
//
// Replaces: jax.ops.segment_sum in the topology planner's route stage
// (src/repro/fleet/engine.py:170, _route_stage), which XLA runs as a
// scatter-add in update order. On CUDA neither index_add_ nor scatter_add_
// has a fixed order (both add with atomics), so the port walks each port's
// legs itself:
//
//   out[s][m, t] = sum, in ascending leg index e, over the legs with
//                  leg_port[e] == m, of src[s][leg_pair[e], t] * w[s][e]
//
// The sum starts at +0.0; each product is __dmul_rn and each add __dadd_rn
// (the source also builds with -fmad=false), so every bit equals the plain
// version's loop out[lm[e]] += src[lp[e]] * w[e] and the sequential scatter.
//
// Layout: one thread per (port, hour), threads of a block consecutive in t,
// so a warp's load of one leg's row is 32 consecutive doubles and its store
// 32 more. Each thread walks its port's run of a port-major index built once
// per routing on the host (a stable sort of leg_port, so within a port the
// legs keep ascending e; start holds each run's offsets). Padding legs (zero
// weights on row 0, port 0) are walked in their place: NaN * 0 is NaN and
// +0.0 + -0.0 is +0.0, as in the scatter.
//
// One launch folds one or two planes over the same legs (the route stage's
// VPN plane with vpn_w and its demand plane with attach_w), sharing the
// index loads.
//
// What bounds it on an H100: device-memory bytes. Each source element is read
// once a leg and each output written once: at 2048 one-hop pairs x 8760 hours
// on 128 ports, both planes, 287 MB read and 18 MB written, 0.091 ms at
// 3.35 TB/s. The index loads are the same address across a warp (one L1
// broadcast). A port with many legs makes its threads long; the grid is
// ceil(T / 128) x M blocks, many waves, so the long ports share the card with
// the short ones. Loads of successive legs are independent (only the adds
// chain), so the unrolled loop keeps several in flight per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int kPlanes>
__global__ void leg_segment_sum_kernel(const double* __restrict__ src0,
                                       const double* __restrict__ src1,
                                       const double* __restrict__ w0,
                                       const double* __restrict__ w1,
                                       const int* __restrict__ leg_pair,  // (E,)
                                       const int* __restrict__ order,     // (E,) port-major
                                       const int* __restrict__ start,     // (M + 1,)
                                       int T,
                                       double* __restrict__ out0,
                                       double* __restrict__ out1) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int m = blockIdx.y;
  if (t >= T) return;
  const int k0 = start[m];
  const int k1 = start[m + 1];
  double a0 = 0.0;
  double a1 = 0.0;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int e = order[k];
    const int64_t i = (int64_t)leg_pair[e] * T + t;
    a0 = __dadd_rn(a0, __dmul_rn(src0[i], w0[e]));
    if (kPlanes == 2) a1 = __dadd_rn(a1, __dmul_rn(src1[i], w1[e]));
  }
  const int64_t o = (int64_t)m * T + t;
  out0[o] = a0;
  if (kPlanes == 2) out1[o] = a1;
}

}  // namespace

// src0/src1 (P, T), w0/w1 (E,), out0/out1 (M, T), all float64 and contiguous;
// src1, w1 and out1 are read only when n_planes == 2.
extern "C" int leg_segment_sum_f64(const double* src0, const double* src1,
                                   const double* w0, const double* w1, int n_planes,
                                   const int* leg_pair, const int* order,
                                   const int* start, int T, int M,
                                   double* out0, double* out1, void* stream) {
  if (n_planes != 1 && n_planes != 2) return (int)cudaErrorInvalidValue;
  if (T == 0 || M == 0) return (int)cudaSuccess;
  if (M > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((T + kThreads - 1) / kThreads, M);
  cudaStream_t s = (cudaStream_t)stream;
  if (n_planes == 2) {
    leg_segment_sum_kernel<2><<<grid, kThreads, 0, s>>>(
        src0, src1, w0, w1, leg_pair, order, start, T, out0, out1);
  } else {
    leg_segment_sum_kernel<1><<<grid, kThreads, 0, s>>>(
        src0, src0, w0, w0, leg_pair, order, start, T, out0, out0);
  }
  return (int)cudaGetLastError();
}
