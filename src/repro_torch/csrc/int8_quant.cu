// Per-row symmetric int8 quantization and dequantization of gradients.
//
// Replaces: src/repro/kernels/int8_quant.py::int8_quantize (the Pallas TPU
// kernel _quant_kernel) and ::int8_dequantize (_dequant_kernel). The port's
// compressed gradient sync (repro_torch/dist/collectives.py) sends every leaf
// through them: one quantize and two dequantize launches per leaf and step.
//
//   quantize:   amax  = max_j |x[r, j]|                       (float32)
//               scale = max(amax, 1e-30) / 127                (guard 0: the Pallas kernel)
//                     = max(amax / 127, 1e-30)                (guard 1: repro/dist/collectives.py)
//               q     = clamp(rint(x / scale), -127, 127)     (int8, half to even)
//
// Both guards use IEEE division. They differ only on rows whose |max| lies
// in (0, 1.27e-28) (and on zero rows' scale). With guard 1, |x / scale|
// never rounds past 127, so the clip changes nothing and q equals the JAX
// collectives' unclipped round.
//   dequantize: out   = (float)q * scale, cast to float32 or bfloat16
//
// Non-finite rows give what JAX gives: the row |max| and the guard's max
// propagate NaN, so a row holding NaN gets scale NaN and one holding +-inf
// scale inf; a quotient x / scale that is NaN (NaN / s, inf / inf, 0 / NaN)
// becomes q = 0, as XLA's float-to-int convert gives, and no other clip
// applies to it.
//
// What bounds it on an H100: device-memory bytes. Quantize reads x once (4 or
// 2 B) and writes q (1 B) and one scale per row; dequantize reads q and the
// scales and writes 4 or 2 B. About 5 B per float32 value either way, a few
// operations per value: far below the card's ridge point. The full-width
// TinyLlama-1.1B gradient (1.1e9 values) is 5.5 GB per pass, 1.64 ms at
// 3.35 TB/s.
//
// Design of quantize (a bandwidth design). A team of threads owns a row: a
// warp for rows of up to 256 16-byte vectors (d <= 1024 in float32, 2048 in
// bfloat16: the k/v rows of 256; eight rows to a block of 256 threads), a
// block of 256 threads up to 1024 vectors (the rows of 2048), a block of 512
// past that (the gate/up rows of 5632 and the LM head's rows of 32000).
// A warp per row of 2048 float32 needs 85 registers a thread, which holds
// only 24 rows per SM in flight and runs the 5632-row leaf in two uneven
// waves; a block of 256 threads holds each row in 8 registers. On the vector
// path each thread loads its slice of the row with 16-byte loads (float4, or
// 8 bfloat16), neighbouring threads on neighbouring addresses, and keeps it
// in registers (VPL loads a thread, up to 16), so the row is read from device
// memory exactly once; the team reduces |max| with shuffles (and, for a
// block, one shared-memory step), every thread computes the scale, quantizes
// from its registers and stores its int8 values packed, 4 (float32) or 8
// (bfloat16) to one 32- or 64-bit store. The grid is sized by occupancy and
// strides over the rows, so the 32000-row embedding and the 2048-row leaves
// alike fill the card with no block per row. Rows that are not 16-byte
// aligned, a d that is not a multiple of the vector width, q not aligned to
// the packed store, or a row wider than 512 x 16 vectors take the scalar
// branch of the same kernel: 2- or 4-byte loads, the row read a second time
// (from L2) to quantize. The division is a true IEEE division and
// rint rounds half to even, as jnp.round does; the file is built without
// --use_fast_math (so -prec-div=true holds) and the result is bit-equal to
// the plain PyTorch version in both guards.
//
// Design of dequantize (a bandwidth design: 1 B read and 4 or 2 B written a
// value, nothing to compute). The leaf is one flat plane of 16-value vectors;
// when d is a multiple of 16 no vector crosses a row, and the vector takes
// the scale of its row (v / (d / 16)). Each thread loads a vector with one
// 16-byte load, a warp 32 neighbouring vectors (512 B), and the warp stores
// them as four float4 (float32) or two 16-byte vectors of 8 bfloat16 a
// thread. A thread storing its own vector's 64 B would leave every store of
// the warp strided 64 B apart, and on the card that ran slower than one block
// per row; so the lanes trade the vectors' words with shuffles first, and
// each store of the warp covers 512 contiguous bytes. The grid strides over
// the chunks and is sized by occupancy, as quantize's, but to kDequantWaves
// times the blocks the card holds at once: a leaf's chunks are seldom a
// multiple of the resident warps, and with one wave the warps that take one
// chunk more set the leaf's time (timed on the card, four waves ran faster
// than one, and as fast as one chunk a warp). So a one-row leaf and the
// 32000-row embedding alike fill the card, with no block per row. Any other
// d, or q or out not 16-byte aligned, takes the scalar branch of the same
// kernel: one value a thread, its row by division.
// The product is one rounding, (float)q * scale, then the cast, as in the
// plain version, so both output types are bit-equal to it (and to
// torch.mul(q, scale) in float32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int kDequantThreads = 256;     // dequantize's block
constexpr int kDequantWaves = 4;         // dequantize's grid: up to 4 x the blocks the card holds
constexpr int kWarpRowsPerBlock = 8;     // quantize, a warp per row
constexpr int kMaxVpl = 16;              // 16-byte loads a thread on the vector path

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// max that returns NaN when either operand is NaN (fmaxf drops it).
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// rint(v / s) clipped to [-127, 127]; a NaN quotient is 0.
__device__ __forceinline__ int quant1(float v, float s) {
  const float r = rintf(v / s);
  return r != r ? 0 : (int)fminf(fmaxf(r, -127.f), 127.f);
}

// Unpack 16 bytes of x into float32 values, and pack E int8 values.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  using Packed = uint32_t;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static Packed pack(const int* q) {
    return (uint32_t)(q[0] & 0xff) | (uint32_t)(q[1] & 0xff) << 8 |
           (uint32_t)(q[2] & 0xff) << 16 | (uint32_t)(q[3] & 0xff) << 24;
  }
};
template <> struct Vec<bf16> {
  static constexpr int kN = 8;
  using Packed = uint2;
  // A bf16 is the top half of a float32: widen by a shift, no conversion.
  __device__ __forceinline__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  __device__ __forceinline__ static Packed pack(const int* q) {
    return make_uint2(Vec<float>::pack(q), Vec<float>::pack(q + 4));
  }
};

// The |max| over a team of TPR threads (a warp, or the whole block of up to
// 512); every thread of the team gets it. red is 2 x 16 floats of shared
// memory, used by block teams only, alternating between rows.
template <int TPR>
__device__ __forceinline__ float team_max(float m, float* red, int parity) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (TPR > 32) {
    float* part = red + 16 * parity;
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) m = max_nan(m, part[w]);
  }
  return m;
}

__device__ __forceinline__ float row_scale(float amax, int guard) {
  return guard ? max_nan(amax / 127.0f, 1e-30f) : max_nan(amax, 1e-30f) / 127.0f;
}

// vec: the vector path (see the top).
template <typename T, int TPR, int VPL>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kWarpRowsPerBlock : TPR)
int8_quantize_kernel(const T* __restrict__ x, long long rows, int d, int guard, int vec,
                     int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float red[32];
  constexpr int E = Vec<T>::kN;
  constexpr int kTeams = TPR == 32 ? kWarpRowsPerBlock : 1;
  const int t = threadIdx.x % TPR;
  const int nv = vec ? d / E : 0;
  const long long step = (long long)gridDim.x * kTeams;
  int parity = 0;
  for (long long r = (long long)blockIdx.x * kTeams + threadIdx.x / TPR; r < rows;
       r += step, parity ^= 1) {
    const T* xr = x + r * d;
    int8_t* qr = q + r * d;
    float amax = 0.f;
    if (vec) {
      uint4 v[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = t + TPR * i;
        v[i] = c < nv ? reinterpret_cast<const uint4*>(xr)[c] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        float f[E];
        Vec<T>::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) amax = max_nan(amax, fabsf(f[e]));
      }
      const float s = row_scale(team_max<TPR>(amax, red, parity), guard);
      if (t == 0) scale[r] = s;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = t + TPR * i;
        if (c < nv) {
          float f[E];
          int qi[E];
          Vec<T>::unpack(v[i], f);
#pragma unroll
          for (int e = 0; e < E; ++e) qi[e] = quant1(f[e], s);
          reinterpret_cast<typename Vec<T>::Packed*>(qr)[c] = Vec<T>::pack(qi);
        }
      }
    } else {
      for (int j = t; j < d; j += TPR) amax = max_nan(amax, fabsf(to_f32(xr[j])));
      const float s = row_scale(team_max<TPR>(amax, red, parity), guard);
      if (t == 0) scale[r] = s;
      for (int j = t; j < d; j += TPR) qr[j] = (int8_t)quant1(to_f32(xr[j]), s);
    }
  }
}

// A word's 4 int8 values times s, as one 16-byte store (float32), and two
// words' 8 values as one 16-byte store (bfloat16).
__device__ __forceinline__ float dq1(uint32_t w, int byte, float s) {
  return __fmul_rn((float)(int8_t)(w >> (8 * byte)), s);
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store16(float* o, const uint32_t* w, float s) {
  *reinterpret_cast<float4*>(o) = make_float4(dq1(w[0], 0, s), dq1(w[0], 1, s),
                                              dq1(w[0], 2, s), dq1(w[0], 3, s));
}
__device__ __forceinline__ void store16(bf16* o, const uint32_t* w, float s) {
  *reinterpret_cast<uint4*>(o) = make_uint4(
      bf16x2(dq1(w[0], 0, s), dq1(w[0], 1, s)), bf16x2(dq1(w[0], 2, s), dq1(w[0], 3, s)),
      bf16x2(dq1(w[1], 0, s), dq1(w[1], 1, s)), bf16x2(dq1(w[1], 2, s), dq1(w[1], 3, s)));
}
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// vec: the vector path (see the top); a warp owns a chunk of 32 vectors a step.
template <typename T>
__global__ void __launch_bounds__(kDequantThreads)
int8_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       long long rows, int d, int vec, T* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec) {
    constexpr int E = Vec<T>::kN;               // values a 16-byte store holds
    constexpr int W = E / 4;                    // int8 words they come from
    const int lane = threadIdx.x % 32;
    const int vpr = d / 16;                     // vectors a row
    const long long nv = rows * vpr;
    const uint4* q16 = reinterpret_cast<const uint4*>(q);
    for (long long c = tid / 32; c * 32 < nv; c += stride / 32) {   // warp-uniform
      const long long v = c * 32 + lane;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      float s = 0.f;
      if (v < nv) {
        u = __ldg(q16 + v);
        s = __ldg(scale + v / vpr);
      }
      // Store m of the chunk (lane + 32 j) holds words m * W .. of vector
      // m * W / 4, which lane m * W / 4 loaded: fetch them with shuffles, so
      // that each store of the warp covers 512 contiguous bytes.
#pragma unroll
      for (int j = 0; j < 16 / E; ++j) {
        const int m = 32 * j + lane;
        const int src = m * W / 4;
        const uint4 us = make_uint4(__shfl_sync(0xffffffffu, u.x, src),
                                    __shfl_sync(0xffffffffu, u.y, src),
                                    __shfl_sync(0xffffffffu, u.z, src),
                                    __shfl_sync(0xffffffffu, u.w, src));
        const float ss = __shfl_sync(0xffffffffu, s, src);
        uint32_t w[W];
#pragma unroll
        for (int i = 0; i < W; ++i) w[i] = word(us, (m * W + i) % 4);
        if (c * 32 + src < nv) store16(out + (c * 32 * 16 + (long long)m * E), w, ss);
      }
    }
  } else {
    const long long n = rows * d;
    for (long long i = tid; i < n; i += stride)
      out[i] = from_f32<T>(__fmul_rn((float)q[i], __ldg(scale + i / d)));
  }
}

bool aligned(const void* p, unsigned bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

template <typename T, int TPR, int VPL>
int launch_quantize(const T* x, long long rows, int d, int guard, int vec, int8_t* q,
                    float* scale, cudaStream_t stream) {
  constexpr int kThreads = TPR == 32 ? 32 * kWarpRowsPerBlock : TPR;
  constexpr int kTeams = kThreads / TPR;
  auto kernel = int8_quantize_kernel<T, TPR, VPL>;
  static const long long full = full_grid(kernel, kThreads);
  const long long need = (rows + kTeams - 1) / kTeams;
  const unsigned grid = (unsigned)(need < full ? need : full);
  kernel<<<grid, kThreads, 0, stream>>>(x, rows, d, guard, vec, q, scale);
  return (int)cudaGetLastError();
}

// Team sizes and the most 16-byte loads a thread holds with each (see the top).
template <typename T, int TPR, int MAXV>
int launch_tpr(const T* x, long long rows, int d, int guard, int vec, int vpl, int8_t* q,
               float* scale, cudaStream_t stream) {
  if constexpr (MAXV >= 16) {
    if (vpl > 8) return launch_quantize<T, TPR, 16>(x, rows, d, guard, vec, q, scale, stream);
  }
  if constexpr (MAXV >= 8) {
    if (vpl > 4) return launch_quantize<T, TPR, 8>(x, rows, d, guard, vec, q, scale, stream);
  }
  switch (vpl) {
    case 1: return launch_quantize<T, TPR, 1>(x, rows, d, guard, vec, q, scale, stream);
    case 2: return launch_quantize<T, TPR, 2>(x, rows, d, guard, vec, q, scale, stream);
    default: return launch_quantize<T, TPR, 4>(x, rows, d, guard, vec, q, scale, stream);
  }
}

template <typename T>
int quantize(const T* x, long long rows, int d, int guard, int8_t* q, float* scale,
             cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows < 0 || d < 1 || (guard != 0 && guard != 1)) return (int)cudaErrorInvalidValue;
  constexpr int E = Vec<T>::kN;
  const int nv = d / E;
  const int tpr = nv <= 32 * 8 ? 32 : nv <= 256 * 4 ? 256 : 512;
  const int max_vpl = tpr == 32 ? 8 : tpr == 256 ? 4 : kMaxVpl;
  int vpl = 1;
  while (vpl < max_vpl && tpr * vpl < nv) vpl *= 2;
  const int vec = d % E == 0 && tpr * vpl >= nv && aligned(x, 16) && aligned(q, E);
  if (!vec) vpl = 1;
  if (tpr == 32) return launch_tpr<T, 32, 8>(x, rows, d, guard, vec, vpl, q, scale, stream);
  if (tpr == 256) return launch_tpr<T, 256, 4>(x, rows, d, guard, vec, vpl, q, scale, stream);
  return launch_tpr<T, 512, kMaxVpl>(x, rows, d, guard, vec, vpl, q, scale, stream);
}

template <typename T>
int dequantize(const int8_t* q, const float* scale, long long rows, int d, T* out,
               cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows < 0 || d < 1) return (int)cudaErrorInvalidValue;
  auto kernel = int8_dequantize_kernel<T>;
  static const long long full = kDequantWaves * full_grid(kernel, kDequantThreads);
  const int vec = d % 16 == 0 && aligned(q, 16) && aligned(out, 16);
  const long long work = vec ? (rows * (d / 16) + 31) / 32 * 32 : rows * d;  // lanes or values
  const long long need = (work + kDequantThreads - 1) / kDequantThreads;
  const unsigned grid = (unsigned)(need < full ? need : full);
  kernel<<<grid, kDequantThreads, 0, stream>>>(q, scale, rows, d, vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

// guard: 0 the Pallas kernel's scale, 1 the JAX collectives' (see the top).
extern "C" int int8_quantize_f32(const float* x, long long rows, int d, int guard, int8_t* q,
                                 float* scale, void* stream) {
  return quantize<float>(x, rows, d, guard, q, scale, (cudaStream_t)stream);
}

extern "C" int int8_quantize_bf16(const void* x, long long rows, int d, int guard, int8_t* q,
                                  float* scale, void* stream) {
  return quantize<__nv_bfloat16>((const __nv_bfloat16*)x, rows, d, guard, q, scale,
                                 (cudaStream_t)stream);
}

extern "C" int int8_dequantize_f32(const int8_t* q, const float* scale, long long rows, int d,
                                   float* out, void* stream) {
  return dequantize<float>(q, scale, rows, d, out, (cudaStream_t)stream);
}

extern "C" int int8_dequantize_bf16(const int8_t* q, const float* scale, long long rows, int d,
                                    void* out, void* stream) {
  return dequantize<__nv_bfloat16>(q, scale, rows, d, (__nv_bfloat16*)out,
                                   (cudaStream_t)stream);
}
