// Tiered Eq. (2) VPN transfer cost per (link, hour) for N heterogeneous links.
//
// Replaces: src/repro/kernels/tiered_cost.py::tiered_cost_batched (the Pallas
// TPU kernel _tiered_batched_kernel), and, in float64, the XLA function
// src/repro/core/costmodel.py::tiered_marginal_cost_tables that the JAX fleet
// engine prices with by default.
//
//   out[n, t] = sum_k rate[n, k] * clip(min(cum + d, b_k) - max(cum, b_{k-1}), 0)
//
// What bounds it on an H100: device-memory bytes. Each element reads
// month_cum and demand and writes one cost: (2 reads + 1 write) x 8 B in
// float64 = 24 B per element, 26.9 MB at 128 x 8760 and 430 MB at 2048 x 8760
// (the (N, K) tier tables add 2 x N x K x 8 B). The arithmetic is ~7 flops per
// tier, about 1 flop per byte, far below the card's ridge point.
//
// Design: one thread per (n, t) element over the flattened row-major (N, T)
// plane, so neighbouring threads of a warp touch neighbouring hours of one
// row and every load and store is coalesced along T. The row's K tier entries
// are read through the read-only cache (the same few bytes for the ~T threads
// of that row). The fold over k is a left fold from zero, each product
// rounded before it is added (__dmul_rn / __dadd_rn, and the file is compiled
// with -fmad=false as well), so the float64 result equals the plain PyTorch
// version (repro_torch.core.costmodel.tiered_marginal_cost_tables) bit for bit.
// The within-month prefix month_cum is computed outside, as in the JAX package.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double min_(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }

template <typename F>
__global__ void tiered_cost_batched_kernel(const F* __restrict__ month_cum,
                                           const F* __restrict__ demand,
                                           const F* __restrict__ bounds,
                                           const F* __restrict__ rates,
                                           int64_t total, int T, int K,
                                           F* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / T;
  const F lo = month_cum[i];
  const F hi = add_rn(lo, demand[i]);
  const F* b = bounds + n * K;
  const F* r = rates + n * K;
  F acc = F(0);
  F prev = F(0);
  for (int k = 0; k < K; ++k) {
    const F bk = __ldg(b + k);
    const F seg = sub_rn(min_(hi, bk), max_(lo, prev));
    // seg > 0 guard: the plain version's where(seg > 0, seg * rate, 0).
    const F term = seg > F(0) ? mul_rn(seg, __ldg(r + k)) : F(0);
    acc = add_rn(acc, term);
    prev = bk;
  }
  out[i] = acc;
}

template <typename F>
int launch(const F* month_cum, const F* demand, const F* bounds, const F* rates,
           int N, int T, int K, F* out, cudaStream_t stream) {
  const int64_t total = (int64_t)N * T;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  tiered_cost_batched_kernel<F><<<(unsigned)blocks, threads, 0, stream>>>(
      month_cum, demand, bounds, rates, total, T, K, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tiered_cost_batched_f64(const double* month_cum, const double* demand,
                                       const double* bounds, const double* rates,
                                       int N, int T, int K, double* out, void* stream) {
  return launch<double>(month_cum, demand, bounds, rates, N, T, K, out,
                        (cudaStream_t)stream);
}

extern "C" int tiered_cost_batched_f32(const float* month_cum, const float* demand,
                                       const float* bounds, const float* rates,
                                       int N, int T, int K, float* out, void* stream) {
  return launch<float>(month_cum, demand, bounds, rates, N, T, K, out,
                       (cudaStream_t)stream);
}
