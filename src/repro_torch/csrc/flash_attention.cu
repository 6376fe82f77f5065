// Blocked online-softmax (flash) attention, forward only.
//
//   q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv)  ->  o (B, Hq, Sq, Dv)
//   o[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / (Hq / Hkv), j]) v[b, h / (Hq / Hkv), j]
//
// over the keys j that the masks allow: j < Skv; j <= q_offset + i when causal;
// j > q_offset + i - window when window > 0. A row with no allowed key gives 0.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel _flash_kernel), which the LM's full-sequence attention
// (models/attention.py::gqa_apply, through kernels/ops.py::attention) runs on
// every prefill. It keeps that kernel's contract: GQA through h / group with
// K/V never repeated in memory, masks from global positions with q_offset,
// Dv != D, float32 running max m, normaliser l and accumulator, masked
// probabilities set to 0, l floored at 1e-30 (so fully masked rows are 0, not
// NaN), fully masked KV tiles skipped, output in q's dtype.
//
// What bounds it on an H100: at the LM's prefill shape (B = 4, Hq = 32,
// Hkv = 4, S = 1024, D = 64, causal, bfloat16) the tensor-core operations:
// 2 B Hq S (S + 1) D = 17.2 GFLOP, 17 us at 989 TFLOP/s, against 23 MB of q,
// k, v and o, 7 us at 3.35 TB/s.
//
// Design (simple first; wgmma, TMA and warp specialisation are later work):
// one block of 4 warps per (q tile of 64 rows, head, batch). The Q tile is
// staged once in shared memory; then for every KV tile of 64 keys that the
// masks do not rule out, K and V are staged in shared memory (zero padded
// to a multiple of 16 in the head dims and past Skv) and each warp owns 16
// query rows:
//   1. scores S = Q K^T of its rows, into shared memory (float32);
//   2. the online softmax of its rows: masks, running max, p = exp(s - m),
//      alpha = exp(m_prev - m_new), l = l alpha + sum p, the accumulator
//      rows scaled by alpha, p written to shared memory;
//   3. acc += P V, the float32 accumulator kept in shared memory.
// bfloat16 runs steps 1 and 3 on the tensor cores through nvcuda::wmma
// (16 x 16 x 16 bf16 fragments, float32 accumulation; p is rounded to bf16
// for the P V product). float32 runs them as float32 loops on the CUDA
// cores, so it stays within float32 rounding of the plain version. Any Sq
// and Skv are taken: the ragged edges are masked, not padded in memory. The
// inputs may be strided views (the LM passes transposes); only the last dim
// must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per KV tile
constexpr int kWarps = BQ / 16;  // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Skv, D, Dv, causal, window, q_offset;
  long long qs[3], ks[3], vs[3], os[3];  // strides of the b, h and s dims (elements)
  float scale;
};

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

// Shared-memory layout of one block: row strides (elements) and byte offsets.
template <typename T>
struct Layout {
  static constexpr bool kMma = std::is_same<T, bf16>::value;
  int Dp, Dvp, ldq, ldk, ldv, lds, ldp, ldo;
  int off_q, off_k, off_v, off_s, off_p, off_o, bytes;

  __host__ __device__ Layout(int D, int Dv) {
    Dp = round_up(D, 16);
    Dvp = round_up(Dv, 16);
    // wmma wants strides that are multiples of 16 bytes; the CUDA-core loops
    // want the K rows, read down a column by the lanes, at an odd stride.
    ldq = kMma ? Dp + 8 : Dp;
    ldk = kMma ? Dp + 8 : Dp + 1;
    ldv = kMma ? Dvp + 8 : Dvp;
    lds = kMma ? BK + 4 : BK + 1;
    ldp = kMma ? BK + 8 : BK;
    ldo = kMma ? Dvp + 4 : Dvp;
    const int e = (int)sizeof(T);
    off_q = 0;
    off_k = round_up(off_q + BQ * ldq * e, 128);
    off_v = round_up(off_k + BK * ldk * e, 128);
    off_s = round_up(off_v + BK * ldv * e, 128);
    off_p = round_up(off_s + BQ * lds * 4, 128);
    off_o = round_up(off_p + BQ * ldp * e, 128);
    bytes = round_up(off_o + BQ * ldo * 4, 128);
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Stage rows [r0, r0 + rows) of a (S, width) slice with row stride `stride`
// into shared memory as `rows` x `padded` (zeros past S and past width).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, long long stride, int r0,
                                      int S, int rows, int width, int padded) {
  for (int i = threadIdx.x; i < rows * padded; i += kThreads) {
    const int r = i / padded, c = i - r * padded;
    const bool in = r0 + r < S && c < width;
    dst[r * ld + c] = in ? src[(long long)(r0 + r) * stride + c] : from_f32<T>(0.f);
  }
}

// Step 1: S[rows of this warp] = Q K^T.
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sK, float* sS,
                                       const Layout<bf16>& L, int warp) {
  using namespace nvcuda;
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < L.Dp / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sQ + warp * 16 * L.ldq + kk * 16, L.ldq);
      wmma::load_matrix_sync(b, sK + n * 16 * L.ldk + kk * 16, L.ldk);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sS + warp * 16 * L.lds + n * 16, acc, L.lds, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void scores(const float* sQ, const float* sK, float* sS,
                                       const Layout<float>& L, int warp) {
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    for (int c = lane; c < BK; c += 32) {
      float acc = 0.f;
      for (int d = 0; d < L.Dp; ++d) acc += sQ[r * L.ldq + d] * sK[c * L.ldk + d];
      sS[r * L.lds + c] = acc;
    }
  }
}

// Step 3: acc[rows of this warp] += P V.
__device__ __forceinline__ void accumulate(const bf16* sP, const bf16* sV, float* sO,
                                           const Layout<bf16>& L, int warp) {
  using namespace nvcuda;
  for (int j = 0; j < L.Dvp / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* o = sO + warp * 16 * L.ldo + j * 16;
    wmma::load_matrix_sync(acc, o, L.ldo, wmma::mem_row_major);
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + warp * 16 * L.ldp + kk * 16, L.ldp);
      wmma::load_matrix_sync(b, sV + kk * 16 * L.ldv + j * 16, L.ldv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, L.ldo, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void accumulate(const float* sP, const float* sV, float* sO,
                                           const Layout<float>& L, int warp) {
  const int lane = threadIdx.x % 32;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    for (int j = lane; j < L.Dvp; j += 32) {
      float acc = 0.f;
      for (int c = 0; c < BK; ++c) acc += sP[r * L.ldp + c] * sV[c * L.ldv + j];
      sO[r * L.ldo + j] += acc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(p.D, p.Dv);
  T* sQ = (T*)(smem + L.off_q);
  T* sK = (T*)(smem + L.off_k);
  T* sV = (T*)(smem + L.off_v);
  float* sS = (float*)(smem + L.off_s);
  T* sP = (T*)(smem + L.off_p);
  float* sO = (float*)(smem + L.off_o);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const T* Q = (const T*)p.q + b * p.qs[0] + h * p.qs[1];
  const T* K = (const T*)p.k + b * p.ks[0] + hk * p.ks[1];
  const T* V = (const T*)p.v + b * p.vs[0] + hk * p.vs[1];
  T* O = (T*)p.o + b * p.os[0] + h * p.os[1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage(sQ, L.ldq, Q, p.qs[2], q0, p.Sq, BQ, p.D, L.Dp);
  for (int i = threadIdx.x; i < BQ * L.Dvp; i += kThreads) {
    sO[(i / L.Dvp) * L.ldo + i % L.Dvp] = 0.f;
  }

  // Global positions of this block's query rows, and the KV tiles the masks
  // leave any key in (the others are skipped, as fully masked).
  const int row_min = p.q_offset + q0;
  const int row_max = row_min + min(BQ, p.Sq - q0) - 1;
  int kv_end = (p.Skv + BK - 1) / BK;
  if (p.causal) kv_end = min(kv_end, row_max < 0 ? 0 : row_max / BK + 1);
  int kv_begin = 0;
  if (p.window > 0 && row_min - p.window + 1 > 0) kv_begin = (row_min - p.window + 1) / BK;

  float m[16], l[16];  // running max and normaliser of this warp's rows, in every lane
#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
  }

  for (int kt = kv_begin; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile (and sQ/sO are staged)
    stage(sK, L.ldk, K, p.ks[2], k0, p.Skv, BK, p.D, L.Dp);
    stage(sV, L.ldv, V, p.vs[2], k0, p.Skv, BK, p.Dv, L.Dvp);
    __syncthreads();

    scores(sQ, sK, sS, L, warp);
    __syncwarp();

#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int row = row_min + r;
      float s[2];
      bool keep[2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = lane + 32 * jj;
        const int col = k0 + c;
        keep[jj] = col < p.Skv && (!p.causal || col <= row) &&
                   (p.window <= 0 || col > row - p.window);
        s[jj] = keep[jj] ? sS[r * L.lds + c] * p.scale : kNegInf;
      }
      float mx = fmaxf(s[0], s[1]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[rr], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float pj = keep[jj] ? expf(s[jj] - m_new) : 0.f;
        sP[r * L.ldp + lane + 32 * jj] = from_f32<T>(pj);
        sum += pj;
      }
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + sum;
      m[rr] = m_new;
      for (int j = lane; j < L.Dvp; j += 32) sO[r * L.ldo + j] *= alpha;
    }
    __syncwarp();
    accumulate(sP, sV, sO, L, warp);
    __syncwarp();
  }
  __syncthreads();  // the zeroed accumulator is visible even when no KV tile ran

#pragma unroll
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (q0 + r >= p.Sq) continue;
    const float denom = fmaxf(l[rr], 1e-30f);
    T* orow = O + (long long)(q0 + r) * p.os[2];
    for (int j = lane; j < p.Dv; j += 32) orow[j] = from_f32<T>(sO[r * L.ldo + j] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const int* dims,
           const long long* strides, float scale, cudaStream_t stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.B = dims[0];
  p.Hq = dims[1];
  p.Hkv = dims[2];
  p.Sq = dims[3];
  p.Skv = dims[4];
  p.D = dims[5];
  p.Dv = dims[6];
  p.causal = dims[7];
  p.window = dims[8];
  p.q_offset = dims[9];
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.scale = scale;
  if (p.B == 0 || p.Hq == 0 || p.Sq == 0) return (int)cudaSuccess;
  if (p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.B > 65535 || p.Hq > 65535 || p.D <= 0 || p.Dv <= 0)
    return (int)cudaErrorInvalidValue;
  const Layout<T> L(p.D, p.Dv);
  if (L.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.Sq + BQ - 1) / BQ), (unsigned)p.Hq, (unsigned)p.B);
  flash_attention_kernel<T><<<grid, kThreads, L.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: B, Hq, Hkv, Sq, Skv, D, Dv, causal, window, q_offset.
// strides: (b, h, s) strides of q, k, v and o, in elements.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    const int* dims, const long long* strides, float scale,
                                    void* stream) {
  return launch<bf16>(q, k, v, o, dims, strides, scale, (cudaStream_t)stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   const int* dims, const long long* strides, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, o, dims, strides, scale, (cudaStream_t)stream);
}
