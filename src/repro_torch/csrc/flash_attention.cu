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
// every prefill. Both kernels below keep that kernel's contract: GQA through
// h / group with K/V never repeated in memory, masks from global positions
// with q_offset, Dv != D, float32 running max m, normaliser l and
// accumulator, masked probabilities set to 0, l floored at 1e-30 (so fully
// masked rows are 0, not NaN), fully masked KV tiles skipped, output in q's
// dtype, any Sq and Skv, strided inputs whose last dim is contiguous.
//
// What bounds it on an H100: at the LM's prefill shape (B = 4, Hq = 32,
// Hkv = 4, S = 1024, D = 64, causal, bfloat16) the tensor-core operations:
// 2 B Hq S (S + 1) D = 17.2 GFLOP, 17 us at 989 TFLOP/s, against 23 MB of q,
// k, v and o, 7 us at 3.35 TB/s. Two more limits sit close to that: the
// exponentials (B Hq S^2 / 2 = 67 M, ~18 us on the SMs' special-function
// units) and the K/V tiles re-read from L2 by every query tile of a head.
//
// Two entries:
//
// * flash_attention_sm90_bf16, the Hopper kernel (sm90 namespace below), the
//   bf16 path for head dims that are multiples of 8 up to 256 with 16-byte
//   aligned pointers and strides (every served config). One warpgroup (128
//   threads, one block) owns a 64-row query tile. Q arrives once and K/V
//   tiles of 64 keys stream through rings of shared memory (K two stages, V
//   one at head dim 64 and two above), each by TMA (4-d tensor maps over
//   (D, S, H, B) with the caller's strides, 128-byte swizzle, zero fill past
//   Sq, Skv and D) completing on an mbarrier; thread 0 refills a stage as
//   soon as the wgmmas reading it have completed, so the next tile's copies
//   run while this one is multiplied. S = Q K^T is wgmma m64n64k16 with both
//   operands in shared memory; the float32 S fragment is masked only on
//   tiles that straddle the causal diagonal, the window's edge or Skv,
//   scaled by scale * log2(e) in one multiply, reduced per row with two quad
//   shuffles and exponentiated with exp2, and O rescaled in registers. P is
//   packed to bf16 pairs, which
//   is the register layout of wgmma's A operand: O += P V is wgmma with P
//   from registers and V (keys x Dv, Dv contiguous) from shared memory
//   through the transpose bit. S, P and O never touch shared memory; the
//   epilogue writes O from registers. Query tiles are launched longest first
//   (the causal diagonal's last tiles have the most keys). The head dims are
//   padded to a bucket, (D, Dv) in {(64, 64), (128, 128), (256, 128),
//   (256, 256)}, a template parameter. What bounds it on the card: how
//   many warpgroups an SM holds, since each runs its products, softmax and
//   waits in series; at D = 64 it takes 90 registers and ~33 KB of shared
//   memory, so five blocks share an SM. Variants with more work in flight
//   per warpgroup (two 64-row tiles, or the next S issued before this
//   softmax) need 138-160 registers and fit three; a producer warp, alone
//   or feeding a second consumer warpgroup that shares the K/V ring, costs
//   a block per SM. Each ran slower on the card.
// * flash_attention_bf16 / flash_attention_f32, the general kernel (the
//   first design): the float32 path, and bf16 inputs the Hopper kernel does
//   not take (a head dim not a multiple of 8, an unaligned pointer or
//   stride). One block of 4 warps per 64 query rows; K and V staged in
//   shared memory per tile; S, P and the float32 accumulator in shared
//   memory; each warp owns 16 rows. bfloat16 runs the products on the tensor
//   cores through nvcuda::wmma (16 x 16 x 16), float32 as float32 loops on
//   the CUDA cores, so it stays within float32 rounding of the plain version.
//
// In bf16 both round P to bf16 before P V, as the plain version's float32
// result is held to 2e-2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------------------
// The Hopper kernel (bf16): wgmma, a TMA ring for K/V, softmax in registers
// ---------------------------------------------------------------------------

namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                 // keys per KV tile
constexpr int BQ = 64;                 // query rows per block: one warpgroup, one m64 tile
constexpr int CHUNK = 64;              // head-dim columns per 128-byte swizzled row
constexpr int TILE_BYTES = 64 * 128;   // one 64-row x 64-column bf16 chunk
constexpr float kNegInf = -1e30f;

struct Params {
  void* o;
  int Sq, Skv, group, causal, window, q_offset, Dv;
  long long os[3];   // strides of o's b, h and s dims (elements)
  float scale_log2;  // scale * log2(e)
};

// One block is one warpgroup owning 64 query rows. Shared memory (byte
// offsets from a 1024-byte aligned base): the Q tile, a ring of KS K tiles
// and one of VS V tiles, each as 64-column chunks of 8 KB, then the
// mbarriers q_full, k_full[KS], v_full[VS] (a tile's copies have landed).
// K is refilled as soon as S = Q K^T has read it, so it runs a tile ahead;
// V is needed only after the softmax, and at head dim 64 one V stage (which
// leaves room for a fifth block on the SM) measured faster than two.
template <int DK, int DV>
struct Config {
  static constexpr int NCK = DK / CHUNK, NCV = DV / CHUNK;
  static constexpr int KS = 2, VS = DV == 64 ? 1 : 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + NCK * TILE_BYTES;
  static constexpr int V = K + KS * NCK * TILE_BYTES;
  static constexpr int BAR = V + VS * NCV * TILE_BYTES;
  static constexpr int ALLOC = BAR + 8 * (1 + KS + VS) + 1024;  // + room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed. A copy that
// never lands (a fault) traps after ~2^34 cycles instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One TMA copy of a 64 x 64 box at coordinates (c0, c1, c2, c3) of a 4-d map
// into shared memory, completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte swizzled tile whose 8-row
// groups lie 1024 bytes apart (bits 32-45, in 16-byte units); `lbo` fills
// bits 16-29 (unused by the K-major tiles; 1024 bytes for V, whose single
// 64-column block makes it unused there too).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving the accumulator registers an asynchronous
// wgmma writes across the wgmma and its wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B over one k16 step, A and B in shared memory (K-major, 128-byte
// swizzle): wgmma m64n64k16, bf16 in, float32 accumulators.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B over one k16 step, A (bf16 pairs) in registers, B in shared memory
// as (k x n) with n contiguous (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The per-block state of the kernel and its steps.
template <int DK, int DV>
struct Block {
  using C = Config<DK, DV>;
  static constexpr int NCK = C::NCK, NCV = C::NCV, KS = C::KS, VS = C::VS;
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  const Params& p;
  uint32_t sQ, sK, sV, bar_k0, bar_v0;
  int hk, b, kv_begin, kv_end, cq;
  int row_min, ra, rb;   // global positions: the tile's first row, this thread's two rows
  float o[NCV][32];
  float m0, m1, l0, l1;  // running max of rows ra, rb; l: this thread's partial sums
  uint32_t pa[4][4];     // P as bf16 pairs: wgmma's A fragment for keys 16 kk .. 16 kk + 15

  __device__ __forceinline__ Block(const CUtensorMap* tk_, const CUtensorMap* tv_,
                                   const Params& p_)
      : tk(tk_), tv(tv_), p(p_) {}

  // Thread 0: the TMA copies of K (or V) of the block's it-th KV tile.
  __device__ __forceinline__ void load(bool is_k, int it) const {
    const int stage = it % (is_k ? KS : VS), kt = kv_begin + it, nc = is_k ? NCK : NCV;
    const uint32_t bar = (is_k ? bar_k0 : bar_v0) + 8 * stage;
    const uint32_t dst = (is_k ? sK : sV) + stage * nc * TILE_BYTES;
    mbar_expect_tx(bar, nc * TILE_BYTES);
    for (int c = 0; c < nc; ++c)
      tma_load_4d(dst + c * TILE_BYTES, is_k ? tk : tv, bar, c * CHUNK, kt * BK, hk, b);
  }
  // Thread 0, once the warpgroup's wgmmas on tile it's stage have completed:
  // refill the stage with the tile one ring ahead.
  __device__ __forceinline__ void refill(bool is_k, int it) const {
    const int ahead = is_k ? KS : VS;
    if (threadIdx.x == 0 && kv_begin + it + ahead < kv_end) load(is_k, it + ahead);
  }

  // Issue S = Q K^T of KV tile it (64 x 64, float32) as one wgmma group;
  // both operands in shared memory.
  __device__ __forceinline__ void issue_s(float (&s)[32], int it) {
    const int stage = it % KS;
    mbar_wait(bar_k0 + 8 * stage, (uint32_t)(it / KS) & 1u);
    __syncwarp();
    const uint32_t kst = sK + stage * NCK * TILE_BYTES;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    pin(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCK; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_sw128(sQ + c * TILE_BYTES + kk * 32, 1),
                 desc_sw128(kst + c * TILE_BYTES + kk * 32, 1), (c | kk) != 0);
    wgmma_commit();
  }

  // Issue O += P V of KV tile it as one wgmma group: P from registers, V
  // (keys x Dv) from shared memory, transposed.
  __device__ __forceinline__ void issue_pv(int it) {
    const int stage = it % VS;
    mbar_wait(bar_v0 + 8 * stage, (uint32_t)(it / VS) & 1u);
    __syncwarp();
    const uint32_t vst = sV + stage * NCV * TILE_BYTES;
#pragma unroll
    for (int c = 0; c < NCV; ++c) pin(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NCV; ++c)
        wgmma_rs(o[c], pa[kk], desc_sw128(vst + c * TILE_BYTES + kk * 16 * 128, 1024 >> 4));
    wgmma_commit();
  }

  // The online softmax of KV tile it's scores s, in registers, in the log2
  // domain (scale * log2(e) in one multiply): s becomes p; returns the
  // rescale factors of rows ra and rb.
  __device__ __forceinline__ float2 softmax(float (&s)[32], int it) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= p.scale_log2;
    const int col0 = (kv_begin + it) * BK;
    const bool straddles = col0 + BK > p.Skv || (p.causal && col0 + BK - 1 > row_min) ||
                           (p.window > 0 && col0 <= row_min + BQ - 1 - p.window);
    if (straddles) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + cq + e;
          const bool in = col < p.Skv;
          if (!(in && (!p.causal || col <= ra) && (p.window <= 0 || col > ra - p.window)))
            s[4 * j + e] = kNegInf;
          if (!(in && (!p.causal || col <= rb) && (p.window <= 0 || col > rb - p.window)))
            s[4 * j + 2 + e] = kNegInf;
        }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float2 alpha = make_float2(fast_exp2(m0 - mx0), fast_exp2(m1 - mx1));
    m0 = mx0;
    m1 = mx1;
    // A row with no allowed key so far has m = -1e30: subtract 0 instead, so
    // its masked entries (-1e30) give p = 0, not exp2(0) = 1.
    const float mu0 = mx0 == kNegInf ? 0.f : mx0, mu1 = mx1 == kNegInf ? 0.f : mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(s[4 * j] - mu0);
      s[4 * j + 1] = fast_exp2(s[4 * j + 1] - mu0);
      s[4 * j + 2] = fast_exp2(s[4 * j + 2] - mu1);
      s[4 * j + 3] = fast_exp2(s[4 * j + 3] - mu1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha.x + sum0;
    l1 = l1 * alpha.y + sum1;
    return alpha;
  }

  // o *= alpha by rows, and P packed to bf16 pairs.
  __device__ __forceinline__ void rescale_and_pack(const float (&s)[32], float2 alpha) {
#pragma unroll
    for (int c = 0; c < NCV; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= alpha.x;
        o[c][4 * j + 1] *= alpha.x;
        o[c][4 * j + 2] *= alpha.y;
        o[c][4 * j + 3] *= alpha.y;
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(128)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Config<DK, DV>;
  constexpr int NCK = C::NCK, NCV = C::NCV;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Block<DK, DV> blk(&tk, &tv, p);
  blk.sQ = base + C::Q;
  blk.sK = base + C::K;
  blk.sV = base + C::V;
  const uint32_t bar_q = base + C::BAR;
  blk.bar_k0 = bar_q + 8;
  blk.bar_v0 = blk.bar_k0 + 8 * C::KS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x;
  blk.b = blockIdx.y;
  const int q0 = (int)(gridDim.z - 1 - blockIdx.z) * BQ;  // longest causal tiles first
  blk.hk = h / p.group;
  // The KV tiles the masks leave any key in (the others are skipped, as
  // fully masked).
  blk.row_min = p.q_offset + q0;
  const int row_last = blk.row_min + min(BQ, p.Sq - q0) - 1;
  blk.kv_end = (p.Skv + BK - 1) / BK;
  if (p.causal) blk.kv_end = min(blk.kv_end, row_last < 0 ? 0 : row_last / BK + 1);
  blk.kv_begin = 0;
  if (p.window > 0 && blk.row_min - p.window + 1 > 0)
    blk.kv_begin = (blk.row_min - p.window + 1) / BK;
  const int n = blk.kv_end - blk.kv_begin;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::KS; ++s) mbar_init(blk.bar_k0 + 8 * s, 1);
    for (int s = 0; s < C::VS; ++s) mbar_init(blk.bar_v0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, NCK * TILE_BYTES);
    for (int c = 0; c < NCK; ++c)
      tma_load_4d(blk.sQ + c * TILE_BYTES, &tq, bar_q, c * CHUNK, q0, h, blk.b);
    for (int it = 0; it < C::KS && it < n; ++it) blk.load(true, it);
    for (int it = 0; it < C::VS && it < n; ++it) blk.load(false, it);
  }

#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) blk.o[c][i] = 0.f;
  // This thread's rows of the tile are r0 and r0 + 8; in every 8-column group
  // of S and O it holds columns cq and cq + 1 (the wgmma accumulator layout).
  const int r0 = 16 * warp + lane / 4;
  blk.cq = 2 * (lane % 4);
  blk.ra = blk.row_min + r0;
  blk.rb = blk.ra + 8;
  blk.m0 = blk.m1 = kNegInf;
  blk.l0 = blk.l1 = 0.f;

  mbar_wait(bar_q, 0);  // also when no KV tile runs: the copy must land before the block exits
  // Per KV tile: S = Q K^T on the tensor cores, the softmax in registers,
  // O += P V on the tensor cores; each ring stage is refilled as soon as the
  // wgmmas reading it have completed.
  for (int it = 0; it < n; ++it) {
    float s[32];
    blk.issue_s(s, it);
    wgmma_wait_all();
    pin(s);
    blk.refill(true, it);
    const float2 alpha = blk.softmax(s, it);
    blk.rescale_and_pack(s, alpha);
    blk.issue_pv(it);
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NCV; ++c) pin(blk.o[c]);
    blk.refill(false, it);
  }

  // Epilogue: the row sums over the quad, o / max(l, 1e-30), bf16 pairs.
  float l0 = blk.l0, l1 = blk.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* O = (bf16*)p.o + blk.b * p.os[0] + h * p.os[1];
  const int qa = q0 + r0, qb = qa + 8;
#pragma unroll
  for (int c = 0; c < NCV; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c * CHUNK + 8 * j + blk.cq;
      if (col >= p.Dv) continue;
      if (qa < p.Sq)
        *reinterpret_cast<uint32_t*>(O + (long long)qa * p.os[2] + col) =
            pack_bf16(blk.o[c][4 * j] * inv0, blk.o[c][4 * j + 1] * inv0);
      if (qb < p.Sq)
        *reinterpret_cast<uint32_t*>(O + (long long)qb * p.os[2] + col) =
            pack_bf16(blk.o[c][4 * j + 2] * inv1, blk.o[c][4 * j + 3] * inv1);
    }
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint) so
// that the library links without -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)f;
  }
  return fn;
}

// A 4-d map over (D, S, H, B) of a bf16 tensor with (b, h, s) element strides
// st, in 64 x 64 boxes (64 head-dim columns = 128 bytes, 64 rows) with the
// 128-byte swizzle; reads past any dim give zeros.
bool make_map(CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
              const long long* st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * sizeof(bf16), (cuuint64_t)st[1] * sizeof(bf16),
                                 (cuuint64_t)st[0] * sizeof(bf16)};
  const cuuint32_t box[4] = {CHUNK, 64, 1, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int DK, int DV>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const Params& p,
           int B, int Hq, cudaStream_t stream) {
  const int bytes = Config<DK, DV>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int nq = (p.Sq + BQ - 1) / BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)Hq, (unsigned)B, (unsigned)nq);
  flash_sm90_kernel<DK, DV><<<grid, 128, bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

int run(const void* q, const void* k, const void* v, void* o, const int* dims,
        const long long* strides, float scale, cudaStream_t stream) {
  const int B = dims[0], Hq = dims[1], Hkv = dims[2], Sq = dims[3], Skv = dims[4];
  const int D = dims[5], Dv = dims[6];
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 8 || Dv < 8 || D > 256 || Dv > 256 || D % 8 != 0 ||
      Dv % 8 != 0 || B > 65535 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] <= 0 || strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.o = o;
  p.Sq = Sq;
  p.Skv = Skv;
  p.group = Hq / Hkv;
  p.causal = dims[7];
  p.window = dims[8];
  p.q_offset = dims[9];
  p.Dv = Dv;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.scale_log2 = scale * 1.4426950408889634f;
  CUtensorMap tq, tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  if (!make_map(&tq, q, D, Sq, Hq, B, strides)) return (int)cudaErrorInvalidValue;
  if (Skv > 0 && (!make_map(&tk, k, D, Skv, Hkv, B, strides + 3) ||
                  !make_map(&tv, v, Dv, Skv, Hkv, B, strides + 6)))
    return (int)cudaErrorInvalidValue;
  // The head-dim bucket: D and Dv padded (with zeros, by the copies) to
  // (64, 64), (128, 128), (256, 128) or (256, 256).
  if (D <= 64 && Dv <= 64) return launch<64, 64>(tq, tk, tv, p, B, Hq, stream);
  if (D <= 128 && Dv <= 128) return launch<128, 128>(tq, tk, tv, p, B, Hq, stream);
  if (Dv <= 128) return launch<256, 128>(tq, tk, tv, p, B, Hq, stream);
  return launch<256, 256>(tq, tk, tv, p, B, Hq, stream);
}

}  // namespace sm90
}  // namespace

// The Hopper kernel; same arguments as flash_attention_bf16. Takes head dims
// that are multiples of 8 up to 256 and 16-byte aligned pointers and (b, h, s)
// strides; returns cudaErrorInvalidValue for anything else.
extern "C" int flash_attention_sm90_bf16(const void* q, const void* k, const void* v, void* o,
                                         const int* dims, const long long* strides, float scale,
                                         void* stream) {
  return sm90::run(q, k, v, o, dims, strides, scale, (cudaStream_t)stream);
}
