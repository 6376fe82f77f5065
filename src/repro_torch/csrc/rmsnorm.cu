// RMSNorm over the rows of x (rows, d) with a weight w (d,):
//
//   out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w      (float32 math)
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (the Pallas TPU kernel
// _rmsnorm_kernel), which the port's LM calls for every norm
// (src/repro_torch/models/lm.py::_rmsnorm): 2 per layer + the final one.
//
// What bounds it on an H100: device-memory bytes. Each element is read once
// and written once (2 + 2 B in bfloat16, 4 + 4 B in float32) and costs ~4
// float32 operations, far below the card's ridge point. A prefill of B = 4 x
// 1024 tokens at d = 2048 in bfloat16 moves 33.6 MB: ~10 us at 3.35 TB/s.
//
// Design: one block of 256 threads per row, so any row count works (a decode
// step normalises B rows, a prefill B x S). Each thread sums the squares of a
// strided slice of the row in float32; warp shuffles and one shared-memory
// step reduce the block. A second pass over the row (now in L1/L2) scales and
// writes, rounding to bfloat16 with round-to-nearest-even as PyTorch's cast
// does. The order of the sum differs from the plain version's, so float32
// results agree to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, int d, float eps,
               T* __restrict__ out) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = to_f32(xr[j]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float partial[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / (float)d + eps);

  for (int j = threadIdx.x; j < d; j += kThreads) {
    orow[j] = from_f32<T>(to_f32(xr[j]) * r * to_f32(w[j]));
  }
}

template <typename T>
int launch(const T* x, const T* w, int64_t rows, int d, float eps, T* out,
           cudaStream_t stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(x, w, d, eps, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* w, long long rows, int d, float eps,
                           float* out, void* stream) {
  return launch<float>(x, w, rows, d, eps, out, (cudaStream_t)stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, long long rows, int d, float eps,
                            void* out, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)x, (const __nv_bfloat16*)w, rows, d, eps,
                               (__nv_bfloat16*)out, (cudaStream_t)stream);
}
