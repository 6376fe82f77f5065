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
// What bounds it on an H100: device-memory bytes. Quantize reads x once (4 or
// 2 B) and writes q (1 B) and one scale per row; dequantize reads q and the
// scales and writes 4 or 2 B. About 5 B per float32 value either way, a few
// operations per value: far below the card's ridge point. The full-width
// TinyLlama-1.1B gradient (1.1e9 values) is 5.5 GB per pass, 1.64 ms at
// 3.35 TB/s.
//
// Design. Quantize: one block per row (any N; the TPU kernel's N % 256 is a
// tiling limit, not part of the contract), 32 to 256 threads by the row's
// width. Each thread reads a strided slice of the row, coalesced across the
// block, keeps it in shared memory as float32 where the row fits (d <= 12032,
// 47 KB: every leaf of the LM) and takes its |x| maximum; warp shuffles and
// one shared-memory step reduce the block. The second pass divides and rounds
// from shared memory, so the row is read from device memory once; a wider row
// is read again (from L2). The division is a true IEEE division and rint
// rounds half to even, as jnp.round does; the file is built without
// --use_fast_math (so -prec-div=true holds) and the result is bit-equal to
// the plain PyTorch version. Dequantize: one block per row as well, its scale
// read once, the row's int8 values streamed by the block; the product is one
// rounding, as in the plain version. Loads are scalar (1 to 4 bytes a thread),
// coalesced across the block; wider vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kSmemFloats = 12032;   // 47 KB: the row cache, inside the 48 KB default

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
int8_quantize_kernel(const T* __restrict__ x, int d, int guard, int8_t* __restrict__ q,
                     float* __restrict__ scale) {
  extern __shared__ float row[];                 // d floats when cached
  __shared__ float partial[kMaxThreads / 32];
  const int64_t r = blockIdx.x;
  const T* xr = x + r * d;
  int8_t* qr = q + r * d;
  const bool cached = d <= kSmemFloats;

  float amax = 0.f;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = to_f32(xr[j]);
    if (cached) row[j] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  if (lane == 0) partial[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    amax = lane < n_warps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) partial[0] = amax;
  }
  __syncthreads();
  const float s = guard ? fmaxf(partial[0] / 127.0f, 1e-30f)
                        : fmaxf(partial[0], 1e-30f) / 127.0f;
  if (threadIdx.x == 0) scale[r] = s;

  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = cached ? row[j] : to_f32(xr[j]);
    const float qv = fminf(fmaxf(rintf(v / s), -127.f), 127.f);
    qr[j] = (int8_t)qv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
int8_dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale, int d,
                       T* __restrict__ out) {
  const int64_t r = blockIdx.x;
  const float s = scale[r];
  const int8_t* qr = q + r * d;
  T* orow = out + r * d;
  for (int j = threadIdx.x; j < d; j += blockDim.x) orow[j] = from_f32<T>((float)qr[j] * s);
}

int threads_for(int d) {
  int t = 32;
  while (t < kMaxThreads && t * 4 < d) t *= 2;   // about 4 values per thread
  return t;
}

template <typename T>
int quantize(const T* x, long long rows, int d, int guard, int8_t* q, float* scale,
             cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows > 0x7fffffffLL || d < 1 || (guard != 0 && guard != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = d <= kSmemFloats ? (size_t)d * sizeof(float) : 0;
  int8_quantize_kernel<T><<<(unsigned)rows, threads_for(d), smem, stream>>>(x, d, guard, q,
                                                                          scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dequantize(const int8_t* q, const float* scale, long long rows, int d, T* out,
               cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows > 0x7fffffffLL || d < 1) return (int)cudaErrorInvalidValue;
  int8_dequantize_kernel<T><<<(unsigned)rows, threads_for(d), 0, stream>>>(q, scale, d, out);
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
