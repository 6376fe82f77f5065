// The tier fold of the paper's Eq. (2), shared by the tiered-pricing kernels
// (tiered_cost.cu, tiered_cost_scan.cu, stream_chunk.cu, stream_chunk_routed.cu).
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
//
// min_sel and max_sel are the same functions with the float64 forms as a
// compare and select in PTX (setp/selp), with no branch: as C ternaries the
// compiler makes each of them a branch region, and an hour's fold in one
// thread a string of them. The kernels in which one thread walks a chain of
// folds take them (stream_chunk.cu; tiered_cost_scan.cu's month-to-date
// kernel), through fold_with_sel and fold_regs. For a +0 and a -0 they too may
// return the other zero, which cannot reach a bit of the fold: a zero segment
// fails seg > 0 whatever its sign, and a zero minus (or from) a nonzero
// operand is that operand's negation (or the operand) either way.
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

// NaN if either operand is NaN (a first), else the smaller (larger); a when
// they compare equal. float64 compares and selects in PTX; float32 is min_/max_.
__device__ __forceinline__ double min_sel(double a, double b) {
  double r;
  asm("{\n\t.reg .pred pa, pb, pl;\n\t.reg .f64 t;\n\t"
      "setp.nan.f64 pa, %1, %1;\n\tsetp.nan.f64 pb, %2, %2;\n\t"
      "setp.lt.f64 pl, %2, %1;\n\tselp.f64 t, %2, %1, pl;\n\t"
      "selp.f64 t, %2, t, pb;\n\tselp.f64 %0, %1, t, pa;\n\t}"
      : "=d"(r) : "d"(a), "d"(b));
  return r;
}
__device__ __forceinline__ double max_sel(double a, double b) {
  double r;
  asm("{\n\t.reg .pred pa, pb, pl;\n\t.reg .f64 t;\n\t"
      "setp.nan.f64 pa, %1, %1;\n\tsetp.nan.f64 pb, %2, %2;\n\t"
      "setp.gt.f64 pl, %2, %1;\n\tselp.f64 t, %2, %1, pl;\n\t"
      "selp.f64 t, %2, t, pb;\n\tselp.f64 %0, %1, t, pa;\n\t}"
      : "=d"(r) : "d"(a), "d"(b));
  return r;
}
__device__ __forceinline__ float min_sel(float a, float b) { return min_(a, b); }
__device__ __forceinline__ float max_sel(float a, float b) { return max_(a, b); }

// Cost of adding volume d to a month that already holds lo, against one
// row's K (bound, rate) pairs, bound(k) and rate(k): the one definition of the
// fold's arithmetic, whatever memory the table lies in (fold_term below is
// its term with min_sel/max_sel).
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

// One tier's term of fold_with with min_sel/max_sel: the part of [lo, hi)
// between the previous bound and this one, times the tier's rate; +0.0
// unless that part is > 0.
template <typename F>
__device__ __forceinline__ F fold_term(F lo, F hi, F prev, F bound, F rate) {
  const F seg = sub_rn(min_sel(hi, bound), max_sel(lo, prev));
  return seg > F(0) ? mul_rn(seg, rate) : F(0);
}

// fold_with's terms and adds in its order, each term from fold_term.
template <typename F, typename Bound, typename Rate>
__device__ __forceinline__ F fold_with_sel(F lo, F d, Bound bound, Rate rate, int K) {
  const F hi = add_rn(lo, d);
  F acc = F(0);
  F prev = F(0);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const F bk = bound(k);
    acc = add_rn(acc, fold_term(lo, hi, prev, bk, rate(k)));
    prev = bk;
  }
  return acc;
}

// The fold against a table held in registers, KMAX tiers: fold_term's terms
// and fold_with's adds over compile-time indices (a run-time index
// would put the arrays in local memory), with no branch. A table of fewer
// tiers is padded with its last bound (0 for an empty table) and rate 0: a
// padded tier's segment is min(hi, b) - max(lo, b) <= 0 (or NaN), so its term
// is +0.0, and acc + 0.0 is acc (acc is never -0.0: it starts at +0.0, and a
// sum is -0.0 only when both addends are).
template <int KMAX, typename F>
__device__ __forceinline__ F fold_regs(F lo, F d, const F (&bound)[KMAX],
                                       const F (&rate)[KMAX]) {
  const F hi = add_rn(lo, d);
  F acc = F(0);
  F prev = F(0);
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    acc = add_rn(acc, fold_term(lo, hi, prev, bound[k], rate[k]));
    prev = bound[k];
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
