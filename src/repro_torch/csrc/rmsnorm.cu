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
// Design (a bandwidth design): one warp per row, 8 warps (8 rows) per block,
// and a grid that strides over the rows, so 4096 rows take 512 blocks, not
// 4096. The block copies w into shared memory once; every row it then
// normalises reads w from there. On the vector path (d a multiple of 16
// bytes' worth of elements, x, w and out 16-byte aligned, and the row short
// enough to sit in registers: 32 x VPL loads of 16 bytes a lane) each lane
// loads its slice of the row with 16-byte loads (a bf16 row of 2048 is 8 a
// lane), keeps it in registers, sums the squares in float32, and the warp
// reduces with shuffles only: no __syncthreads per row, and the row is read
// from device memory exactly once. The scaling pass works on the registers
// and stores 16 bytes a lane. Any other row (d not a multiple of 8 in
// bfloat16 or 4 in float32, a view at an odd offset, a very wide row) takes
// the scalar branch of the same kernel: one warp per row, 2- or 4-byte
// loads, the row read a second time (from L1/L2) for the scaling pass.
// Products are (x * r) * w as in the plain version, rounded to bfloat16 with
// round-to-nearest-even as PyTorch's cast does. The order of the sum differs
// from the plain version's, so float32 results agree to rounding, not bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                // rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 4096;         // the grid strides over rows past this
constexpr int kMaxVpl = 32;              // 16-byte loads a lane on the vector path
constexpr int kSmemLimit = 227 * 1024;   // shared memory a block may use on sm_90

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Unpack 16 bytes into float32 values, and pack them back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec<bf16> {
  static constexpr int kN = 8;
  // A bf16 is the top half of a float32: widen by a shift, no conversion.
  __device__ __forceinline__ static void unpack2(uint32_t w, float* f) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    unpack2(u.x, f);
    unpack2(u.y, f + 2);
    unpack2(u.z, f + 4);
    unpack2(u.w, f + 6);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// vec: the vector path (see the top); w_smem: w fits shared memory.
template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, long long rows, int d,
               float eps, T* __restrict__ out, int vec, int w_smem) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = Vec<T>::kN;
  const int nv = vec ? d / E : 0;
  T* sw = reinterpret_cast<T*>(smem);
  if (w_smem) {
    if (vec) {
      for (int c = threadIdx.x; c < nv; c += kThreads)
        reinterpret_cast<uint4*>(sw)[c] = reinterpret_cast<const uint4*>(w)[c];
    } else {
      for (int j = threadIdx.x; j < d; j += kThreads) sw[j] = w[j];
    }
    __syncthreads();  // once per block, before any row
  }
  const T* wr = w_smem ? sw : w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long step = (long long)gridDim.x * kWarps;

  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows; row += step) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    if (vec) {
      uint4 v[VPL];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < nv ? reinterpret_cast<const uint4*>(xr)[c] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        float f[E];
        Vec<T>::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) ss += f[e] * f[e];
      }
      const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int c = lane + 32 * i;
        if (c < nv) {
          float f[E], g[E];
          Vec<T>::unpack(v[i], f);
          Vec<T>::unpack(reinterpret_cast<const uint4*>(wr)[c], g);
#pragma unroll
          for (int e = 0; e < E; ++e) f[e] = f[e] * r * g[e];
          reinterpret_cast<uint4*>(orow)[c] = Vec<T>::pack(f);
        }
      }
    } else {
      float ss = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float t = to_f32(xr[j]);
        ss += t * t;
      }
      const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
      for (int j = lane; j < d; j += 32) orow[j] = from_f32<T>(to_f32(xr[j]) * r * to_f32(wr[j]));
    }
  }
}

template <typename T, int VPL>
int launch_vpl(const T* x, const T* w, int64_t rows, int d, float eps, T* out, int vec,
               cudaStream_t stream) {
  const size_t wbytes = (size_t)d * sizeof(T);
  const int w_smem = wbytes <= (size_t)kSmemLimit;
  const size_t smem = w_smem ? wbytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(rmsnorm_kernel<T, VPL>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t need = (rows + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(need < kMaxBlocks ? need : kMaxBlocks);
  rmsnorm_kernel<T, VPL><<<grid, kThreads, smem, stream>>>(x, w, rows, d, eps, out, vec, w_smem);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename T>
int launch(const T* x, const T* w, int64_t rows, int d, float eps, T* out,
           cudaStream_t stream) {
  if (rows == 0 || d == 0) return (int)cudaSuccess;
  if (rows < 0 || d < 0) return (int)cudaErrorInvalidValue;
  constexpr int E = Vec<T>::kN;
  const int nv = d / E;
  int vpl = 1;
  while (vpl < kMaxVpl && 32 * vpl < nv) vpl *= 2;
  const int vec = d % E == 0 && 32 * vpl >= nv && aligned16(x) && aligned16(w) && aligned16(out);
  if (!vec) vpl = 1;
  switch (vpl) {
    case 1: return launch_vpl<T, 1>(x, w, rows, d, eps, out, vec, stream);
    case 2: return launch_vpl<T, 2>(x, w, rows, d, eps, out, vec, stream);
    case 4: return launch_vpl<T, 4>(x, w, rows, d, eps, out, vec, stream);
    case 8: return launch_vpl<T, 8>(x, w, rows, d, eps, out, vec, stream);
    case 16: return launch_vpl<T, 16>(x, w, rows, d, eps, out, vec, stream);
    default: return launch_vpl<T, 32>(x, w, rows, d, eps, out, vec, stream);
  }
}

}  // namespace

extern "C" int rmsnorm_f32(const float* x, const float* w, long long rows, int d, float eps,
                           float* out, void* stream) {
  return launch<float>(x, w, rows, d, eps, out, (cudaStream_t)stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, long long rows, int d, float eps,
                            void* out, void* stream) {
  return launch<bf16>((const bf16*)x, (const bf16*)w, rows, d, eps, (bf16*)out,
                      (cudaStream_t)stream);
}
