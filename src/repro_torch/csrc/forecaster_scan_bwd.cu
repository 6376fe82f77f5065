// The backward pass of the demand forecaster's scan: the gradients of a loss
// with respect to the forecaster's operands a, 1 - a, w and bias, given the
// loss's gradient dy with respect to the readout y, over N rows of T hours.
//
// Replaces: XLA autodiff of the jax.lax.scan in
// src/repro/models/ssm.py::demand_forecaster_apply (:524-526) under
// jax.value_and_grad in train_demand_forecaster (:578). The JAX package has
// no Pallas kernel for it; on the GPU an eager loop over T would launch ~10^4
// small kernels a training step.
//
// What it computes, in float32, every product and sum rounded on its own (the
// file is built with -fmad=false). The forward chain is forecaster_scan's,
//   h_t = a_s * h_{t-1} + (1 - a_s) * u_t,
// and for each row and state s, walking the hours backwards from T - 1,
//   lam  = dy_t * w_s + a_s * lam            (lam = 0 past the last hour)
//   dA  += lam * h_{t-1}       dB += lam * u_t
//   dW  += dy_t * (h_t - u_t)  dbias += dy_t  (each from 0, in that order)
// Then each of the 3S + 1 sums is folded over the rows in index order, left
// from row 0. Out: dA (S), dB (S), dW (S), dbias (1), the gradients with
// respect to a, 1 - a, w and bias. The plain version,
// repro_torch.kernels.ref.forecaster_scan_bwd_ref, walks the same order.
//
// What bounds it on an H100. u and dy read once, 8 B an element: 72 MB at
// 2048 x 4380 (0.021 ms at 3.35 TB/s). Per element and state: the forward
// state (three operations) and the reverse step's ten: 13 float32
// lane-operations, 0.028 ms at S = 8. But each (row, state) is one dependent
// chain of T hours, and the rows are few: 2048 on the training path, one
// warp of chains a scheduler. The lam chain is a multiply and an add an hour.
//
// Design. One thread a (row, state) chain, R = min(128 / S, 32) rows a
// block. The state at the start of every tile of kTile hours comes in as a
// checkpoint (ceil(T / kTile), N, S): forecaster_scan stores them while it
// walks the chain in the training step's forward, so the backward does not
// walk it again. A step k = 0 .. n_tiles of the chain threads
// - recomputes the states of tile n_tiles - 1 - k from its checkpoint into the
//   thread's own row of a shared state buffer (two buffers, by tile parity),
// - and walks the adjoint back through tile n_tiles - k, reading the states
//   the step before recomputed,
// the two in one loop of four-hour groups: two independent dependency chains
// that share the warp's issue slots, the state reads off the lam chain's
// critical path. The group's operands (float4 loads of u, dy and the states)
// are loaded a group ahead, before the group's store of recomputed states,
// which later loads may not pass. The first and last steps run one walk
// each; a partial last tile is walked an hour at a time. A fifth warp, the
// producer, stages each tile's u, dy and checkpoints in reverse, kAhead
// tiles ahead, into a ring of kRing = kAhead + 2 slots (tiles k - 1 and k in
// use): one __syncthreads a step, and no load from global memory on a
// chain. cp.async: 16-byte copies of u and dy when T is a multiple of 4 and
// both are 16-byte aligned (a whole tile's addresses formed once, so the
// producer issues ~3 instructions a copy), else 4-byte copies. The per-row
// sums go to a (3S + 1, ld) scratch (ld = N rounded up to 4), and a second
// kernel folds each over the rows in index order: its block stages chunks
// of kFoldRows rows of every sum through a cp.async ring, and 3S + 1 of its
// threads add each chunk's rows in order from shared memory (float4 reads),
// from -0.0 (x + -0.0 == x in every bit, so the fold equals the plain
// version's, which starts at row 0). No atomics: the fixed order is what
// makes the plain version equal the kernel bit for bit.
//
// What earlier versions taught on the card (PERF.md, Findings): a checkpoint
// loaded from global memory one step ahead paced every step with its
// latency; a producer spending ~20 instructions of address arithmetic a
// copy slowed the chain warp that shares its scheduler, and every step
// waited for that warp. Slower or no faster than this design: the states
// kept in registers (their layout flipping each step), two threads a chain
// (lam, dA and dB on one; the recompute, dW and dbias on the other), TMA
// bulk copies of each 256-byte row, a deeper ring; for the fold, smaller
// chunks or a deeper ring.
//
// Any S past kFastState takes the run-time instance instead: a thread a
// (row, state) chain, blocks of kAnyThreads states of one row, each tile's
// states recomputed from its checkpoint into registers and the adjoint walked
// back through it, u and dy read from device memory; then a fold thread a
// sum over the rows in index order from -0.0. The same operations in the same
// order, so the same bits; it is not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                // chain threads a block at most: rows x states
constexpr int kMaxRows = 32;                 // rows a block at most
constexpr int kTile = 64;                    // hours a staged tile (and a checkpoint)
constexpr int kGroups = kTile / 4;           // four-hour groups a tile
constexpr int kAhead = 4;                    // tiles in flight ahead of the step
constexpr int kRing = kAhead + 2;            // tiles in the ring
constexpr int kPad = kTile + 4;              // ring and state row stride (words): 16-byte rows
constexpr int kFastState = 16;              // compile-time instances: S = 1 .. kFastState
constexpr int kAnyThreads = 128;             // the run-time instance's blocks
constexpr int kFoldThreads = 256;            // the fold's block
constexpr int kFoldRows = 256;               // rows a staged chunk of the fold
constexpr int kFoldPad = kFoldRows + 4;      // a sum's row stride in a chunk (words)
constexpr int kFoldRing = 3;                 // chunks in the fold's ring

template <int S>
struct Geo {
  static constexpr int R = kThreads / S < kMaxRows ? kThreads / S : kMaxRows;   // rows a block
  static constexpr int kCompute = (R * S + 31) / 32 * 32;   // chain warps' threads
  static constexpr int kBlock = kCompute + 32;              // and the producer warp
  static constexpr int kSlot = 2 * R * kPad + kCompute;     // u, dy and checkpoints (words)
  static constexpr int kSmem = (kRing * kSlot + 2 * kCompute * kPad) * 4;
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The producer warp stages u and dy of tile t of the block's R rows, and
// their chains' checkpoints of the tile, into a ring slot (a no-op for t <
// 0; rows past N and hours past T are never copied). VEC: 16-byte copies of
// u and dy, four hours each; the checkpoints' R x S words are 4-byte copies.
template <int R, int S, bool VEC>
__device__ __forceinline__ void stage_tile(float* slot, const float* u, const float* dy,
                                           const float* ckpt, int64_t n0, int N, int T, int t,
                                           int lane) {
  if (t < 0) return;
  const int t0 = t * kTile, len = min(kTile, T - t0);
  const float* ck = ckpt + ((int64_t)t * N + n0) * S;
  for (int e = lane; e < R * S; e += 32)
    if (n0 + e / S < N) cp_async4(slot + 2 * R * kPad + e, ck + e);
  if (VEC && len == kTile && n0 + R <= N) {         // a whole tile: no test a copy
    constexpr int kPerRow = kTile / 4, kRowsPerPass = 32 / kPerRow;
    const int rr = lane / kPerRow, i = (lane % kPerRow) * 4;
    const float* su = u + (n0 + rr) * T + t0 + i;
    const float* sd = dy + (n0 + rr) * T + t0 + i;
    float* dst = slot + rr * kPad + i;
#pragma unroll
    for (int p = 0; p < (R + kRowsPerPass - 1) / kRowsPerPass; ++p) {
      if (R % kRowsPerPass == 0 || p * kRowsPerPass + rr < R) {
        const int64_t off = (int64_t)p * kRowsPerPass * T;
        cp_async16(dst + p * kRowsPerPass * kPad, su + off);
        cp_async16(dst + (R + p * kRowsPerPass) * kPad, sd + off);
      }
    }
    return;
  }
  constexpr int kStep = VEC ? 4 : 1;
  constexpr int kPer = kTile / kStep;
  for (int e = lane; e < 2 * R * kPer; e += 32) {
    const int which = e / (R * kPer), rest = e % (R * kPer);
    const int r = rest / kPer, i = (rest % kPer) * kStep;
    if (i < len && n0 + r < N) {
      const int64_t g = (n0 + r) * T + t0 + i;
      float* dst = slot + (which * R + r) * kPad + i;
      if (VEC)
        cp_async16(dst, (which ? dy : u) + g);
      else
        cp_async4(dst, (which ? dy : u) + g);
    }
  }
}

struct Chain {
  float as, bs, ws;                            // a_s, 1 - a_s, w_s
  float lam, dA, dB, dW, dBias;                // the adjoint and the sums
  float hr;                                    // the recompute's state
};

// One hour of the adjoint: g = dy_t, uv = u_t, ht = h_t, hp = h_{t-1}.
__device__ __forceinline__ void adjoint_hour(Chain& c, float g, float uv, float ht, float hp) {
  c.lam = __fadd_rn(__fmul_rn(g, c.ws), __fmul_rn(c.as, c.lam));
  c.dA = __fadd_rn(c.dA, __fmul_rn(c.lam, hp));
  c.dB = __fadd_rn(c.dB, __fmul_rn(c.lam, uv));
  c.dW = __fadd_rn(c.dW, __fmul_rn(g, __fsub_rn(ht, uv)));
  c.dBias = __fadd_rn(c.dBias, g);
}

__device__ __forceinline__ float recompute_hour(Chain& c, float uv) {
  c.hr = __fadd_rn(__fmul_rn(c.as, c.hr), __fmul_rn(c.bs, uv));
  return c.hr;
}

// The adjoint back through the first len hours of a tile, an hour at a time
// (a partial tile): reads only, so the unrolled loads run ahead.
__device__ __forceinline__ void adjoint_partial(Chain& c, const float* Ua, const float* Da,
                                                const float* Ha, float hc, int len) {
#pragma unroll 8
  for (int i = len - 1; i >= 0; --i)
    adjoint_hour(c, Da[i], Ua[i], Ha[i], i > 0 ? Ha[i - 1] : hc);
}

// The recompute of the first len hours of a tile (a partial tile): the
// tile's u into registers first, so no load waits behind a state's store.
__device__ __forceinline__ void recompute_partial(Chain& c, const float* Ur, float* Hr, int len) {
  float uv[kTile];                              // hours past len are read, not used
#pragma unroll
  for (int i = 0; i < kTile; ++i) uv[i] = Ur[i];
#pragma unroll
  for (int i = 0; i < kTile; ++i)
    if (i < len) Hr[i] = recompute_hour(c, uv[i]);
}

// A step over whole tiles, group by group: ADJ, the adjoint back through a
// tile (u Ua, dy Da, states Ha, hc its checkpoint); REC, the recompute of
// the tile before it (u Ur, states out to Hr, from c.hr).
template <bool ADJ, bool REC>
__device__ __forceinline__ void grouped_step(Chain& c, const float* Ua, const float* Da,
                                             const float* Ha, float hc, const float* Ur,
                                             float* Hr) {
  const float4* u4 = reinterpret_cast<const float4*>(Ua);
  const float4* d4 = reinterpret_cast<const float4*>(Da);
  const float4* h4 = reinterpret_cast<const float4*>(Ha);
  const float4* r4 = reinterpret_cast<const float4*>(Ur);
  float4* o4 = reinterpret_cast<float4*>(Hr);
  float4 uv{}, dv{}, hv{}, rv{};
  if (ADJ) {
    uv = u4[kGroups - 1];
    dv = d4[kGroups - 1];
    hv = h4[kGroups - 1];
  }
  if (REC) rv = r4[0];
#pragma unroll
  for (int g = kGroups - 1; g >= 0; --g) {
    const int q = kGroups - 1 - g;             // the recompute's group
    // The next group's operands, loaded before this group's store.
    float4 uv_n = uv, dv_n = dv, hv_n = hv, rv_n = rv;
    if (ADJ && g > 0) {
      uv_n = u4[g - 1];
      dv_n = d4[g - 1];
      hv_n = h4[g - 1];
    }
    if (REC && q < kGroups - 1) rv_n = r4[q + 1];
    const float hm = g > 0 ? hv_n.w : hc;     // h before the group's first hour
    float4 out;
    if (ADJ) adjoint_hour(c, dv.w, uv.w, hv.w, hv.z);
    if (REC) out.x = recompute_hour(c, rv.x);
    if (ADJ) adjoint_hour(c, dv.z, uv.z, hv.z, hv.y);
    if (REC) out.y = recompute_hour(c, rv.y);
    if (ADJ) adjoint_hour(c, dv.y, uv.y, hv.y, hv.x);
    if (REC) out.z = recompute_hour(c, rv.z);
    if (ADJ) adjoint_hour(c, dv.x, uv.x, hv.x, hm);
    if (REC) {
      out.w = recompute_hour(c, rv.w);
      o4[q] = out;
    }
    uv = uv_n;
    dv = dv_n;
    hv = hv_n;
    rv = rv_n;
  }
}

template <int S, bool VEC>
__global__ void __launch_bounds__(Geo<S>::kBlock)
forecaster_bwd_chains_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                             const float* __restrict__ a, const float* __restrict__ one_minus_a,
                             const float* __restrict__ w, const float* __restrict__ ckpt, int N,
                             int T, int ld, float* __restrict__ part) {
  using G = Geo<S>;
  constexpr int R = G::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);   // [kRing][u, dy][R][kPad], checkpoints
  float* hbuf = ring + kRing * G::kSlot;                // [2][kCompute][kPad] states
  const int64_t n0 = (int64_t)blockIdx.x * R;
  const int tid = threadIdx.x;
  const bool producer = tid >= G::kCompute;
  const int r = min(tid / S, R - 1), s = tid % S;       // padding threads read row R - 1
  const int64_t n = n0 + r;
  const bool chain = !producer && tid < R * S && n < N;   // thread (r, s) walks a state
  const int n_tiles = (T + kTile - 1) / kTile;

  if (producer) {
    for (int m = 0; m < kAhead; ++m) {
      stage_tile<R, S, VEC>(ring + (m % kRing) * G::kSlot, u, dy, ckpt, n0, N, T,
                            n_tiles - 1 - m, tid % 32);
      cp_async_commit();
    }
  }
  Chain c{};
  if (chain) {
    c.as = a[s];
    c.bs = one_minus_a[s];
    c.ws = w[s];
  }
  float* hrow = hbuf + tid * kPad;

  // Step k: the adjoint of tile ja = n_tiles - k (ring slot of m = k - 1),
  // the recompute of tile jr = ja - 1 (slot of m = k).
  for (int k = 0; k <= n_tiles; ++k) {
    if (producer) cp_async_wait<kAhead - 1>();      // tile m = k has landed
    __syncthreads();                                // ... for every thread; step k - 1 done
    if (producer) {
      const int m = k + kAhead;                     // into the slot of m = k - 2
      stage_tile<R, S, VEC>(ring + (m % kRing) * G::kSlot, u, dy, ckpt, n0, N, T,
                            n_tiles - 1 - m, tid % 32);
      cp_async_commit();
      continue;
    }
    const int ja = n_tiles - k, jr = ja - 1;
    const float* slot_a = ring + ((k + kRing - 1) % kRing) * G::kSlot;
    const float* slot_r = ring + (k % kRing) * G::kSlot;
    const float* Ua = slot_a + r * kPad;
    const float* Da = slot_a + (R + r) * kPad;
    const float* Ur = slot_r + r * kPad;
    const float* Ha = hrow + (ja & 1) * (G::kCompute * kPad);
    float* Hr = hrow + (jr & 1) * (G::kCompute * kPad);
    const float hc = slot_a[2 * R * kPad + tid];    // tile ja's checkpoint (k >= 1)
    c.hr = slot_r[2 * R * kPad + tid];              // tile jr's (k < n_tiles)
    const int len_a = min(kTile, T - ja * kTile), len_r = min(kTile, T - jr * kTile);
    const bool adj = k >= 1, rec = jr >= 0;
    const bool full_a = adj && len_a == kTile, full_r = rec && len_r == kTile;
    if (adj && !full_a) adjoint_partial(c, Ua, Da, Ha, hc, len_a);      // the last tile
    if (rec && !full_r) recompute_partial(c, Ur, Hr, len_r);
    if (full_a && full_r)
      grouped_step<true, true>(c, Ua, Da, Ha, hc, Ur, Hr);
    else if (full_r)                                // the first step, or after a partial tile
      grouped_step<false, true>(c, Ua, Da, Ha, hc, Ur, Hr);
    else if (full_a)                                // the last step
      grouped_step<true, false>(c, Ua, Da, Ha, hc, Ur, Hr);
  }
  if (chain) {
    part[(int64_t)s * ld + n] = c.dA;
    part[(int64_t)(S + s) * ld + n] = c.dB;
    part[(int64_t)(2 * S + s) * ld + n] = c.dW;
    if (s == 0) part[(int64_t)(3 * S) * ld + n] = c.dBias;
  }
}

// Each of the Q = 3S + 1 per-row sums folded over the rows, left in index
// order. Every thread stages chunks of kFoldRows rows of all Q sums (16-byte
// copies: ld is a multiple of 4 and part 16-byte aligned) kFoldRing - 1
// chunks ahead; thread q < Q adds its sum's rows of the chunk in order.
__global__ void __launch_bounds__(kFoldThreads)
forecaster_bwd_fold_kernel(const float* __restrict__ part, int N, int ld, int Q,
                           float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* buf = reinterpret_cast<float*>(smem_raw);    // [kFoldRing][Q][kFoldPad]
  const int tid = threadIdx.x;
  const int n_chunks = (N + kFoldRows - 1) / kFoldRows;
  const int slot_words = Q * kFoldPad;
  auto stage = [&](int c) {
    if (c >= n_chunks) return;
    const int c0 = c * kFoldRows, len = min(kFoldRows, ld - c0);   // a multiple of 4
    float* slot = buf + (c % kFoldRing) * slot_words;
    for (int e = tid; e < Q * (kFoldRows / 4); e += kFoldThreads) {
      const int q = e / (kFoldRows / 4), i = (e % (kFoldRows / 4)) * 4;
      if (i < len) cp_async16(slot + q * kFoldPad + i, part + (int64_t)q * ld + c0 + i);
    }
  };
  for (int c = 0; c < kFoldRing - 1; ++c) {
    stage(c);
    cp_async_commit();
  }
  float acc = -0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kFoldRing - 2>();                 // chunk c has landed
    __syncthreads();                                // ... for every thread; chunk c - 1 folded
    stage(c + kFoldRing - 1);                       // into the slot of chunk c - 1
    cp_async_commit();
    if (tid < Q) {
      const float4* row = reinterpret_cast<const float4*>(buf + (c % kFoldRing) * slot_words +
                                                          tid * kFoldPad);
      const int len = min(kFoldRows, N - c * kFoldRows);
      if (len == kFoldRows) {
#pragma unroll
        for (int i = 0; i < kFoldRows / 4; ++i) {
          const float4 v = row[i];
          acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, v.x), v.y), v.z), v.w);
        }
      } else {
        const float* rs = reinterpret_cast<const float*>(row);
        for (int i = 0; i < len; ++i) acc = __fadd_rn(acc, rs[i]);
      }
    }
  }
  if (tid < Q) out[tid] = acc;
}

template <int S, bool VEC>
int launch_chains(const float* u, const float* dy, const float* a, const float* oma,
                  const float* w, const float* ckpt, int N, int T, int ld, float* part,
                  cudaStream_t stream) {
  using G = Geo<S>;
  cudaError_t err = cudaFuncSetAttribute(forecaster_bwd_chains_kernel<S, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return (int)err;
  forecaster_bwd_chains_kernel<S, VEC><<<(N + G::R - 1) / G::R, G::kBlock, G::kSmem, stream>>>(
      u, dy, a, oma, w, ckpt, N, T, ld, part);
  return (int)cudaGetLastError();
}

template <int S>
int launch(const float* u, const float* dy, const float* a, const float* oma, const float* w,
           const float* ckpt, int N, int T, float* part, float* out, cudaStream_t stream) {
  const int ld = (N + 3) / 4 * 4;
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  int err = (vec ? launch_chains<S, true> : launch_chains<S, false>)(u, dy, a, oma, w, ckpt, N,
                                                                     T, ld, part, stream);
  if (err != 0) return err;
  const int Q = 3 * S + 1;
  const int smem = kFoldRing * Q * kFoldPad * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(forecaster_bwd_fold_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  forecaster_bwd_fold_kernel<<<1, kFoldThreads, smem, stream>>>(part, N, ld, Q, out);
  return (int)cudaGetLastError();
}

// The run-time instance's chains, for S past kFastState: thread (n, s) with
// n = blockIdx.x, s = blockIdx.y * kAnyThreads + threadIdx.x.
__global__ void __launch_bounds__(kAnyThreads)
forecaster_bwd_chains_any_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                                 const float* __restrict__ a,
                                 const float* __restrict__ one_minus_a,
                                 const float* __restrict__ w, const float* __restrict__ ckpt,
                                 int N, int T, int S, int ld, float* __restrict__ part) {
  const int64_t n = blockIdx.x;
  const int s = blockIdx.y * kAnyThreads + threadIdx.x;
  if (s >= S) return;
  Chain c{};
  c.as = a[s];
  c.bs = one_minus_a[s];
  c.ws = w[s];
  const float* ur = u + n * T;
  const float* dr = dy + n * T;
  for (int j = (T + kTile - 1) / kTile - 1; j >= 0; --j) {
    const int t0 = j * kTile, len = min(kTile, T - t0);
    const float hc = ckpt[((int64_t)j * N + n) * S + s];
    float hv[kTile];                                // the tile's states; past len unused
    c.hr = hc;
#pragma unroll
    for (int i = 0; i < kTile; ++i) hv[i] = i < len ? recompute_hour(c, ur[t0 + i]) : 0.0f;
#pragma unroll
    for (int i = kTile - 1; i >= 0; --i)
      if (i < len) adjoint_hour(c, dr[t0 + i], ur[t0 + i], hv[i], i > 0 ? hv[i - 1] : hc);
  }
  part[(int64_t)s * ld + n] = c.dA;
  part[(int64_t)(S + s) * ld + n] = c.dB;
  part[(int64_t)(2 * S + s) * ld + n] = c.dW;
  if (s == 0) part[(int64_t)(3 * S) * ld + n] = c.dBias;
}

// The run-time instance's fold: thread q adds sum q's rows in index order.
__global__ void __launch_bounds__(kAnyThreads)
forecaster_bwd_fold_any_kernel(const float* __restrict__ part, int N, int ld, int Q,
                               float* __restrict__ out) {
  const int q = blockIdx.x * kAnyThreads + threadIdx.x;
  if (q >= Q) return;
  const float* row = part + (int64_t)q * ld;
  float acc = -0.0f;
  for (int n = 0; n < N; ++n) acc = __fadd_rn(acc, row[n]);
  out[q] = acc;
}

int launch_any(const float* u, const float* dy, const float* a, const float* oma,
               const float* w, const float* ckpt, int N, int T, int S, float* part, float* out,
               cudaStream_t stream) {
  const int ld = (N + 3) / 4 * 4;
  const dim3 grid(N, (S + kAnyThreads - 1) / kAnyThreads);
  forecaster_bwd_chains_any_kernel<<<grid, kAnyThreads, 0, stream>>>(u, dy, a, oma, w, ckpt, N,
                                                                     T, S, ld, part);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int Q = 3 * S + 1;
  forecaster_bwd_fold_any_kernel<<<(Q + kAnyThreads - 1) / kAnyThreads, kAnyThreads, 0,
                                   stream>>>(part, N, ld, Q, out);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, int, int, float*, float*, cudaStream_t);

// The compile-time instance of S, or null past kFastState.

LaunchFn pick_state(int S) {
  switch (S) {
    case 1: return launch<1>;
    case 2: return launch<2>;
    case 3: return launch<3>;
    case 4: return launch<4>;
    case 5: return launch<5>;
    case 6: return launch<6>;
    case 7: return launch<7>;
    case 8: return launch<8>;
    case 9: return launch<9>;
    case 10: return launch<10>;
    case 11: return launch<11>;
    case 12: return launch<12>;
    case 13: return launch<13>;
    case 14: return launch<14>;
    case 15: return launch<15>;
    case 16: return launch<16>;
    default: return nullptr;
  }
}

static_assert(kFastState == 16, "pick_state instantiates S = 1 .. kFastState");
static_assert(3 * kFastState + 1 <= kFoldThreads, "one fold thread a sum");
static_assert(kTile % 4 == 0 && kFoldRows % 4 == 0, "float4 groups");
static_assert(Geo<4>::kSmem <= 232448, "shared memory: 32 rows of 128 chains, the most");
static_assert(kFoldRing * (3 * kFastState + 1) * kFoldPad * 4 <= 232448, "the fold's ring");

}  // namespace

// u, dy (N, T); a / one_minus_a / w (S,); ckpt (ceil(T / 64), N, S), the
// forward chain's state at the start of every tile (forecaster_scan_f32's
// checkpoint output); part ((3S + 1) x ld scratch, ld = N rounded up to a
// multiple of 4, 16-byte aligned); out (3S + 1): dA, dB, dW, dbias. Any
// S >= 1: S = 1 .. 16 take their compile-time instances, a larger S the
// run-time one. N = 0 writes nothing.
extern "C" int forecaster_scan_bwd_f32(const float* u, const float* dy, const float* a,
                                       const float* one_minus_a, const float* w,
                                       const float* ckpt, int N, int T, int S, float* part,
                                       float* out, void* stream) {
  if (N < 0 || T < 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const LaunchFn fn = pick_state(S);
  if (fn == nullptr)
    return launch_any(u, dy, a, one_minus_a, w, ckpt, N, T, S, part, out, (cudaStream_t)stream);
  return fn(u, dy, a, one_minus_a, w, ckpt, N, T, part, out, (cudaStream_t)stream);
}
