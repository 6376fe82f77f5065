// The MoE layer's routing, dispatch and combine (the port's
// src/repro_torch/models/ffn.py::moe_apply), three kernels over G token
// groups of N tokens, E experts, top-k, capacity C per expert and group:
//
//   moe_route     router logits (G, N, E) float32 -> probs (G, N, E), the
//                 top-k gate_idx (G, N, k) int32 and normalised gate_w
//                 (G, N, k) float32, each slot's position pos (G, N*k)
//                 int32 inside its expert and keep = pos < C (uint8), the
//                 inverse map src (G, E, C) int32 (each capacity slot's
//                 flat token-slot index n*k + j, or -1), and the per-group
//                 Switch aux loss (G,) float32 (0 for the sigmoid router);
//   moe_dispatch  x (G, N, d) and src -> buf (E, G, C, d) in x's dtype: row
//                 (e, g, c) is x[g, src / k] or zeros where src < 0;
//   moe_combine   the experts' out (E, G, C, d), gate_idx, pos, keep and
//                 gate_w -> y (G, N, d): sum over j = 0..k-1 in order of
//                 round(out[e_j, g, min(pos_j, C - 1)] * round(gate_w_j *
//                 keep_j)), each product rounded to the dtype, the sum in
//                 float32 rounded once.
//
// Replaces: no Pallas kernel. The reference's dispatch is XLA
// (src/repro/models/ffn.py::_dispatch_group, :72-131): softmax or sigmoid,
// jax.lax.top_k, an in-order one-hot cumsum for the slot positions, a
// scatter-add into (E, C, d), three einsums, a weighted gather. In eager
// PyTorch that chain is ~15-20 launches a layer, paid in every layer of
// every decode step; here it is three, around the expert products, which
// stay torch.bmm over the (E, G*C, d) buffer as the reference leaves its
// einsums to XLA.
//
// What must be exact: the decisions. top-k runs over the rounded
// probabilities, lower expert index first on equal values (jax.lax.top_k's
// rule), and a slot's position is the number of earlier slots (token-major,
// then choice: s = n*k + j) routed to the same expert; which slots a full
// expert drops follows from that order. The positions are integers, so a
// parallel scan over the slots is exact when it keeps their order.
//
// What bounds them on an H100: bytes, far below the ridge point. Mixtral's
// prefill (G = 4, N = 1024, E = 8, k = 2, d = 4096, C = 320, bf16) moves
// ~0.3 MB through moe_route, ~117 MB through moe_dispatch (each kept
// token's row read once, every buffer row written) and ~100 MB through
// moe_combine.
//
// Design (simple first):
// - moe_route: one block per group, 16 warps. A warp takes a token: each
//   lane holds experts lane, lane + 32, ... (E <= 256: 8 a lane) in
//   registers, the softmax's max and sum are warp butterflies, and each of
//   the k choices is a warp argmax over (value, index) with the lower index
//   winning ties, broadcast from lane 0 (so every lane agrees even on NaN).
//   The aux loss sums each expert's probabilities over the group in a fixed
//   order (strided partials, then the partials in order): no float atomics,
//   the same bits every run. Positions: the slots go in order in chunks of
//   512; within a warp __match_any_sync groups lanes of one expert and a
//   lane's rank is the popcount of its lower peers; per-warp per-expert
//   counts in shared memory give each warp its offset, and a per-expert
//   running count carries from chunk to chunk. Every counter is an
//   integer in shared memory sized by E (up to DeepSeek-V3's 256 experts,
//   k up to 8).
// - moe_dispatch: a gather, a warp a buffer row, 16-byte copies where the
//   row allows them; zeros for empty slots; no atomics.
// - moe_combine: a warp a token, its k rows read with 16-byte loads,
//   products and sums rounded as the plain version rounds them
//   (__fmul_rn/__fadd_rn, no contraction), so it matches that version bit
//   for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 256;                 // DeepSeek-V3's router
constexpr int kMaxK = 8;
constexpr int kPer = kMaxE / 32;           // experts a lane holds
constexpr int kRouteWarps = 16;
constexpr int kRouteThreads = kRouteWarps * 32;
constexpr int kCopyWarps = 8;              // dispatch and combine: rows a block
constexpr int kCopyThreads = kCopyWarps * 32;
constexpr int kMaxBlocks = 8192;           // the copy grids stride past this
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(const float* __restrict__ logits, int N, int E, int k, int C, int sigmoid,
                 float aux_scale, float* __restrict__ probs, int* __restrict__ gate_idx,
                 float* __restrict__ gate_w, int* __restrict__ pos, uint8_t* __restrict__ keep,
                 int* __restrict__ src, float* __restrict__ aux) {
  __shared__ int cnt[kMaxE];                 // slots routed to e in earlier chunks
  __shared__ int top1[kMaxE];                // tokens whose first choice is e
  __shared__ int wcnt[kRouteWarps][kMaxE];   // this chunk's slots to e, by warp
  __shared__ float part[kRouteThreads];
  __shared__ float contrib[kMaxE];

  const int g = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int S = N * k;
  const float* lg = logits + (size_t)g * N * E;
  float* pr = probs + (size_t)g * N * E;
  int* gi = gate_idx + (size_t)g * S;
  float* gw = gate_w + (size_t)g * S;
  int* ps = pos + (size_t)g * S;
  uint8_t* kp = keep + (size_t)g * S;
  int* sr = src + (size_t)g * E * C;

  for (int e = t; e < E; e += kRouteThreads) {
    cnt[e] = 0;
    top1[e] = 0;
  }
  for (long long i = t; i < (long long)E * C; i += kRouteThreads) sr[i] = -1;
  __syncthreads();

  // 1. scores and the top-k, a warp a token
  for (int n = warp; n < N; n += kRouteWarps) {
    const float* row = lg + (size_t)n * E;
    float v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      v[i] = e < E ? row[e] : -INFINITY;
    }
    if (sigmoid) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = 1.f / (1.f + expf(-v[i]));
    } else {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kPer; ++i) mx = fmaxf(mx, v[i]);
      mx = warp_max(mx);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        v[i] = lane + 32 * i < E ? expf(v[i] - mx) : 0.f;
        s += v[i];
      }
      s = warp_sum(s);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = __fdiv_rn(v[i], s);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = lane + 32 * i;
      if (e < E) pr[(size_t)n * E + e] = v[i];
    }

    unsigned chosen = 0;
    float tv[kMaxK];
    int ti[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      tv[j] = 0.f;
      ti[j] = 0;
      if (j < k) {
        float bv = 0.f;
        int bi = -1;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {   // a lane's experts ascend: '>' keeps the lower
          const int e = lane + 32 * i;
          if (e < E && !((chosen >> i) & 1u) && (bi < 0 || v[i] > bv)) {
            bv = v[i];
            bi = e;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(kFull, bv, off);
          const int oi = __shfl_xor_sync(kFull, bi, off);
          if (oi >= 0 && (bi < 0 || ov > bv || (!(ov < bv) && oi < bi))) {
            bv = ov;
            bi = oi;
          }
        }
        bv = __shfl_sync(kFull, bv, 0);
        bi = __shfl_sync(kFull, bi, 0);
        if ((bi & 31) == lane) chosen |= 1u << (bi >> 5);
        tv[j] = bv;
        ti[j] = bi;
      }
    }
    float s = tv[0];
#pragma unroll
    for (int j = 1; j < kMaxK; ++j)
      if (j < k) s = __fadd_rn(s, tv[j]);
    const float den = s < 1e-9f ? 1e-9f : s;   // NaN stays NaN, as jnp.maximum
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k && lane == j) {
        gi[(size_t)n * k + j] = ti[j];
        gw[(size_t)n * k + j] = __fdiv_rn(tv[j], den);
      }
    }
    if (lane == 0) atomicAdd(&top1[ti[0]], 1);   // integer: any order gives the same
  }
  __syncthreads();

  // 2. the Switch aux loss: aux_scale * sum_e density_e * mean_probs_e
  if (sigmoid) {
    if (t == 0) aux[g] = 0.f;
  } else {
    const int P = E >= kRouteThreads ? 1 : kRouteThreads / E;   // partial sums an expert
    if (t < P * E) {
      const int e = t % E, q = t / E;
      float acc = 0.f;
      for (int n = q; n < N; n += P) acc = __fadd_rn(acc, pr[(size_t)n * E + e]);
      part[t] = acc;
    }
    __syncthreads();
    if (t < E) {
      float tot = 0.f;
      for (int q = 0; q < P; ++q) tot = __fadd_rn(tot, part[q * E + t]);
      contrib[t] = __fmul_rn(__fdiv_rn((float)top1[t], (float)N), __fdiv_rn(tot, (float)N));
    }
    __syncthreads();
    if (t == 0) {
      float s = 0.f;
      for (int e = 0; e < E; ++e) s = __fadd_rn(s, contrib[e]);
      aux[g] = __fmul_rn(aux_scale, s);
    }
  }

  // 3. positions: slots in order, kRouteThreads a chunk
  for (int base = 0; base < S; base += kRouteThreads) {
    for (int i = t; i < kRouteWarps * kMaxE; i += kRouteThreads) (&wcnt[0][0])[i] = 0;
    __syncthreads();
    const int s = base + t;
    const int e = s < S ? gi[s] : -1;
    const unsigned peers = __match_any_sync(kFull, e);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (s < S && rank == 0) wcnt[warp][e] = __popc(peers);
    __syncthreads();
    if (s < S) {
      int p = cnt[e] + rank;
      for (int w = 0; w < warp; ++w) p += wcnt[w][e];
      ps[s] = p;
      kp[s] = p < C;
      if (p < C) sr[(size_t)e * C + p] = s;
    }
    __syncthreads();
    for (int x = t; x < E; x += kRouteThreads) {
      int add = 0;
      for (int w = 0; w < kRouteWarps; ++w) add += wcnt[w][x];
      cnt[x] += add;
    }
    __syncthreads();
  }
}

// Buffer row r = (e * G + g) * C + c takes x[g, src[g, e, c] / k] or zeros.
template <typename U>
__global__ void __launch_bounds__(kCopyThreads)
moe_dispatch_kernel(const U* __restrict__ x, const int* __restrict__ src, int G, int N, int E,
                    int C, int k, long long units, U* __restrict__ buf) {
  const long long rows = (long long)E * G * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = (long long)gridDim.x * kCopyWarps;
  for (long long r = (long long)blockIdx.x * kCopyWarps + warp; r < rows; r += step) {
    const int c = (int)(r % C);
    const long long eg = r / C;
    const int g = (int)(eg % G), e = (int)(eg / G);
    const int s = src[((long long)g * E + e) * C + c];
    U* out = buf + r * units;
    if (s >= 0) {
      const U* in = x + ((long long)g * N + s / k) * units;
      for (long long i = lane; i < units; i += 32) out[i] = in[i];
    } else {
      const U zero{};
      for (long long i = lane; i < units; i += 32) out[i] = zero;
    }
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T's precision, as a float.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// 16 bytes as float32 values, and back.
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

template <typename T>
__global__ void __launch_bounds__(kCopyThreads)
moe_combine_kernel(const T* __restrict__ out, const int* __restrict__ gate_idx,
                   const int* __restrict__ pos, const uint8_t* __restrict__ keep,
                   const float* __restrict__ gate_w, int G, int N, int C, int k, int d, int vec,
                   T* __restrict__ y) {
  const long long tokens = (long long)G * N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long step = (long long)gridDim.x * kCopyWarps;
  for (long long tok = (long long)blockIdx.x * kCopyWarps + warp; tok < tokens; tok += step) {
    const int g = (int)(tok / N);
    const T* rows[kMaxK];
    float w[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      rows[j] = out;
      w[j] = 0.f;
      if (j < k) {
        const long long sl = tok * k + j;
        const int p = min(pos[sl], C - 1);
        rows[j] = out + (((long long)gate_idx[sl] * G + g) * C + p) * d;
        w[j] = keep[sl] ? round_to<T>(gate_w[sl]) : 0.f;
      }
    }
    T* yr = y + tok * d;
    if (vec) {
      constexpr int V = Vec<T>::kN;
      const int nv = d / V;
      for (int c = lane; c < nv; c += 32) {
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j) {
          if (j < k) {
            float f[V];
            Vec<T>::unpack(reinterpret_cast<const uint4*>(rows[j])[c], f);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], round_to<T>(__fmul_rn(f[i], w[j])));
          }
        }
        reinterpret_cast<uint4*>(yr)[c] = Vec<T>::pack(acc);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxK; ++j)
          if (j < k) acc = __fadd_rn(acc, round_to<T>(__fmul_rn(to_f32(rows[j][c]), w[j])));
        yr[c] = from_f32<T>(acc);
      }
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

unsigned copy_grid(long long rows) {
  const long long need = (rows + kCopyWarps - 1) / kCopyWarps;
  return (unsigned)(need < kMaxBlocks ? need : kMaxBlocks);
}

template <typename T>
int combine(const T* out, const int* gate_idx, const int* pos, const uint8_t* keep,
            const float* gate_w, int G, int N, int E, int C, int k, int d, T* y,
            cudaStream_t stream) {
  if (G < 0 || N < 0 || E < 1 || C < 1 || k < 1 || k > kMaxK || d < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)G * N == 0 || d == 0) return (int)cudaSuccess;
  const int vec = ((long long)d * sizeof(T)) % 16 == 0 && aligned16(out) && aligned16(y);
  moe_combine_kernel<T><<<copy_grid((long long)G * N), kCopyThreads, 0, stream>>>(
      out, gate_idx, pos, keep, gate_w, G, N, C, k, d, vec, y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int moe_route_f32(const float* logits, int G, int N, int E, int k, int C,
                             int sigmoid, float aux_scale, float* probs, int* gate_idx,
                             float* gate_w, int* pos, unsigned char* keep, int* src, float* aux,
                             void* stream) {
  if (G < 0 || N < 0 || E < 1 || E > kMaxE || k < 1 || k > kMaxK || k > E || C < 1)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || N == 0) return (int)cudaSuccess;
  moe_route_kernel<<<G, kRouteThreads, 0, (cudaStream_t)stream>>>(
      logits, N, E, k, C, sigmoid, aux_scale, probs, gate_idx, gate_w, pos, keep, src, aux);
  return (int)cudaGetLastError();
}

// row_bytes: one token's row of x (d times the element size, even).
extern "C" int moe_dispatch(const void* x, const int* src, int G, int N, int E, int C, int k,
                            long long row_bytes, void* buf, void* stream) {
  if (G < 0 || N < 1 || E < 1 || C < 1 || k < 1 || row_bytes < 0 || row_bytes % 2)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)E * G * C;
  if (rows == 0 || row_bytes == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  if (row_bytes % 16 == 0 && aligned16(x) && aligned16(buf)) {
    moe_dispatch_kernel<uint4><<<copy_grid(rows), kCopyThreads, 0, st>>>(
        (const uint4*)x, src, G, N, E, C, k, row_bytes / 16, (uint4*)buf);
  } else {
    moe_dispatch_kernel<uint16_t><<<copy_grid(rows), kCopyThreads, 0, st>>>(
        (const uint16_t*)x, src, G, N, E, C, k, row_bytes / 2, (uint16_t*)buf);
  }
  return (int)cudaGetLastError();
}

extern "C" int moe_combine_f32(const float* out, const int* gate_idx, const int* pos,
                               const unsigned char* keep, const float* gate_w, int G, int N,
                               int E, int C, int k, int d, float* y, void* stream) {
  return combine<float>(out, gate_idx, pos, keep, gate_w, G, N, E, C, k, d, y,
                        (cudaStream_t)stream);
}

extern "C" int moe_combine_bf16(const void* out, const int* gate_idx, const int* pos,
                                const unsigned char* keep, const float* gate_w, int G, int N,
                                int E, int C, int k, int d, void* y, void* stream) {
  return combine<bf16>((const bf16*)out, gate_idx, pos, keep, gate_w, G, N, E, C, k, d,
                       (bf16*)y, (cudaStream_t)stream);
}
