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

#include "occupancy.cuh"
#include "tier_fold.cuh"

namespace {

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
  out[i] = tier::fold(month_cum[i], demand[i], bounds + n * K, rates + n * K, K);
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

// The static-table entry: one (T, P) float32 plane priced against ONE tier
// table of at most kMaxTiers tiers, passed by value (kernel parameter space,
// read by every thread at no memory cost), as the Pallas kernel
// _tiered_kernel compiles its table in as constants.
//
// Replaces: src/repro/kernels/tiered_cost.py::tiered_cost (the Pallas TPU
// kernel _tiered_kernel, reached through repro.kernels.ops.tiered_cost).
// Bound: bytes, as above (two float32 reads and one write: 12 B per element;
// 215 MB at 8760 x 2048, 64 us at 3.35 TB/s). The fold is the Pallas
// kernel's left fold, total = total + clip(seg, 0) * rate, each step rounded
// (_rn intrinsics, -fmad=false), so the result equals the plain version
// repro_torch.kernels.ref.tiered_cost bit for bit. Its min, max and clip keep
// a NaN (tier::min_/max_), as jnp.clip and the plain version's clamp_min do,
// so an hour whose month_cum or demand is NaN comes out NaN, as in the Pallas
// kernel. On finite input a clip may return a zero of the other sign than
// fmaxf did; it is added to a sum that starts at +0, which no such zero
// changes.
//
// Design: the plane is flat (T * P elements; the fold is elementwise). Each
// thread loads four elements of month_cum and of demand with one float4 load
// each and stores four costs with one, neighbouring threads on neighbouring
// 16-byte vectors. The grid strides over the plane and is sized by occupancy,
// to kStaticWaves times the blocks the card holds at once: with one wave the
// threads that take one vector more set the time, and two vectors in flight a
// thread did not make up for it (timed on the card, four waves of one vector
// a step ran fastest). A total that is not a multiple of 4 leaves a scalar
// tail; a pointer that is not 16-byte aligned sends the whole plane through
// the scalar loop.
constexpr int kMaxTiers = 8;

struct TierTable {           // by value from the wrapper (a ctypes.Structure)
  int K;
  float bounds[kMaxTiers];   // an infinite bound arrives as 1e30
  float rates[kMaxTiers];
};

namespace {

constexpr int kStaticThreads = 256;
constexpr int kStaticWaves = 4;           // the grid: up to 4 x the blocks the card holds

__device__ __forceinline__ float static_fold(float lo, float d, const TierTable& tab) {
  const float hi = tier::add_rn(lo, d);
  float acc = 0.f;
  float prev = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxTiers; ++k) {      // unrolled: the table stays in registers
    if (k < tab.K) {
      const float seg = tier::max_(
          tier::sub_rn(tier::min_(hi, tab.bounds[k]), tier::max_(lo, prev)), 0.f);
      acc = tier::add_rn(acc, tier::mul_rn(seg, tab.rates[k]));
      prev = tab.bounds[k];
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kStaticThreads)
tiered_cost_static_kernel(const float* __restrict__ month_cum,
                          const float* __restrict__ demand, long long total, int vec,
                          const __grid_constant__ TierTable tab, float* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long scalar_from = 0;
  if (vec) {
    const long long nv = total / 4;
    const float4* c4 = reinterpret_cast<const float4*>(month_cum);
    const float4* d4 = reinterpret_cast<const float4*>(demand);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long v = tid; v < nv; v += stride) {
      const float4 c = __ldg(c4 + v), d = __ldg(d4 + v);
      o4[v] = make_float4(static_fold(c.x, d.x, tab), static_fold(c.y, d.y, tab),
                          static_fold(c.z, d.z, tab), static_fold(c.w, d.w, tab));
    }
    scalar_from = 4 * nv;
  }
  for (long long i = scalar_from + tid; i < total; i += stride)
    out[i] = static_fold(month_cum[i], demand[i], tab);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int tiered_cost_static_f32(const float* month_cum, const float* demand,
                                      long long total, TierTable tab, float* out,
                                      void* stream) {
  if (total == 0) return (int)cudaSuccess;
  if (total < 0 || tab.K < 0 || tab.K > kMaxTiers) return (int)cudaErrorInvalidValue;
  static const long long full =
      kStaticWaves * full_grid(tiered_cost_static_kernel, kStaticThreads);
  const int vec = aligned16(month_cum) && aligned16(demand) && aligned16(out);
  const long long work = vec ? (total + 3) / 4 : total;
  const long long need = (work + kStaticThreads - 1) / kStaticThreads;
  const unsigned grid = (unsigned)(need < full ? need : full);
  tiered_cost_static_kernel<<<grid, kStaticThreads, 0, (cudaStream_t)stream>>>(
      month_cum, demand, total, vec, tab, out);
  return (int)cudaGetLastError();
}

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
