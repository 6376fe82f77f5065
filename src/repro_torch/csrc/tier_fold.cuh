// The tier fold of the paper's Eq. (2), shared by the tiered-pricing kernels
// (tiered_cost.cu, tiered_cost_scan.cu, stream_chunk.cu).
//
//   cost = sum_k rate[k] * clip(min(lo + d, b_k) - max(lo, b_{k-1}), 0)
//
// A left fold from zero over the K tiers, each product rounded before it is
// added (_rn intrinsics; the sources are also compiled with -fmad=false), with
// the seg > 0 guard of the plain version's where(seg > 0, seg * rate, 0). In
// float64 the result equals repro_torch.core.costmodel.tiered_marginal_cost_tables
// bit for bit.
//
// NaN: min_ and max_ keep a NaN, as torch.minimum/maximum and jnp.minimum/maximum
// do (fmin/fmax drop it). A NaN lo or d makes hi NaN, so every segment is NaN,
// fails seg > 0 and adds +0.0: the hour is priced +0.0, as the plain version
// and the JAX function price it. On other input the float64 forms are
// fmin/fmax; the float32 ones may differ from fminf/fmaxf at most in the sign
// of the zero they return for a +0 and a -0, and a zero segment fails seg > 0
// whatever its sign, so the fold keeps every bit it had.
#pragma once

#include <cuda_runtime.h>

namespace tier {

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
// NaN if either operand is NaN, else fmin/fmax. float32 has the PTX .NaN
// modifier; float64 has none, so it selects.
__device__ __forceinline__ double min_(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : fmin(a, b);
}
__device__ __forceinline__ double max_(double a, double b) {
  return isnan(a) ? a : isnan(b) ? b : fmax(a, b);
}
__device__ __forceinline__ float min_(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Cost of adding volume d to a month that already holds lo, against one
// row's K (bound, rate) pairs, bound(k) and rate(k): the one definition of the
// fold's arithmetic, whatever memory the table lies in.
template <typename F, typename Bound, typename Rate>
__device__ __forceinline__ F fold_with(F lo, F d, Bound bound, Rate rate, int K) {
  const F hi = add_rn(lo, d);
  F acc = F(0);
  F prev = F(0);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {   // unrolled: only the adds into acc form a chain
    const F bk = bound(k);
    const F seg = sub_rn(min_(hi, bk), max_(lo, prev));
    const F term = seg > F(0) ? mul_rn(seg, rate(k)) : F(0);
    acc = add_rn(acc, term);
    prev = bk;
  }
  return acc;
}

// The fold against a table in device memory, read through the read-only cache.
template <typename F>
__device__ __forceinline__ F fold(F lo, F d, const F* __restrict__ b,
                                  const F* __restrict__ r, int K) {
  return fold_with(lo, d, [b](int k) { return __ldg(b + k); },
                   [r](int k) { return __ldg(r + k); }, K);
}

}  // namespace tier
