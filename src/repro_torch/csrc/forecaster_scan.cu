// The demand forecaster's scan: the EMA bank and its readout over N rows of T
// hours, in one launch.
//
// Replaces: the jax.lax.scan of src/repro/models/ssm.py::demand_forecaster_state
// (:514) and demand_forecaster_apply (:524-526) over demand_forecaster_step
// (:492). The JAX package has no Pallas kernel for it; on the GPU an eager loop
// over T would launch ~10^5 small kernels per forecast.
//
// What it computes, in float32, every product and sum rounded on its own (the
// file is built with -fmad=false): for each hour t, in order,
//   h_s = a_s * h_s + (1 - a_s) * u_t          for s = 0 .. S-1
//   p_s = (h_s - u_t) * w_s
//   acc = p_0, then acc = acc + p_s            for s = 1 .. S-1 (a left fold)
//   y_t = (u_t + acc) + bias
// It writes y (N, T), unless write_y is 0 (demand_forecaster_state), and the
// last h (N, S). a and 1 - a come in as operands, so that the kernel and its
// plain version (repro_torch.kernels.ref.forecaster_scan_ref) share their bits.
// Given a checkpoint output (ceil(T / kTile), N, S), the chain threads also
// store each chain's state at the start of every tile (tile 0's is h0): the
// backward pass (forecaster_scan_bwd.cu, the same kTile) recomputes a tile's
// states from it. The store adds no operation to the chain.
//
// What bounds it on an H100. u read and y written, 8 B an element: 215 MB at
// 2048 x 13140 (0.064 ms at 3.35 TB/s); 6S + 1 float32 operations an element,
// each a whole lane-cycle (49 at S = 8: 0.040 ms at half the FMA-counted
// peak). But each (row, state) is one dependent chain of T hours, a multiply
// and an add an hour, and the rows are few: 2048 on the main path.
//
// Design. Only h is a recurrence: y_t needs h at hour t and nothing later. So
// a block's kThreads compute threads own R = kThreads / S rows, and each tile
// of kTile hours runs in two phases. In the recurrence phase thread (r, s)
// walks state s of row r through the tile and writes each hour's p_s into
// shared memory; after a barrier, in the readout phase, the compute threads
// fold (row, hour) pairs of the tile, lanes over hours, each pair's S
// products in index order, and store y coalesced. At S = 8 a block holds 16
// rows, and 2048 rows take 128 blocks, one an SM: four warps of chains an SM,
// each hour's chain two dependent operations.
//
// What the first designs taught (PERF.md), and what this one does:
// - A chain thread loads its row's whole tile into registers first. Loads
//   from shared memory that follow its stores of p may not pass them, so a
//   load an hour put a shared-memory round trip into every hour of the chain.
// - A fifth warp, the producer, stages the u tiles kAhead tiles ahead with
//   cp.async (16-byte copies when T is a multiple of 4 and u is 16-byte
//   aligned, else 4-byte copies; lanes over a row's contiguous hours, any T),
//   in a ring of kRing: when the compute threads staged the tiles themselves,
//   sending the copies cost them about as long a tile as the chain.
// - A whole tile of a full block runs with no test an hour or a pair.
// - The readout's kPairs pairs a thread are unrolled, so their folds
//   interleave.
// The u ring's rows are kPadU = kTile + 4 words apart (16-byte rows, a chain
// warp's rows on distinct banks), the products' rows kPad = kTile + 1 apart
// (thread (r, s) stores hour i at word (r * S + s) * kPad + i: distinct banks;
// the readout reads consecutive hours). Two __syncthreads a tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                // compute threads a block: rows x states
constexpr int kBlock = kThreads + 32;        // and the producer warp
constexpr int kTile = 64;                    // hours a staged tile
constexpr int kAhead = 4;                    // tiles in flight ahead of the recurrence
constexpr int kRing = kAhead + 1;            // u tiles in the ring: j .. j + kAhead
constexpr int kPadU = kTile + 4;             // u ring row stride (words): 16-byte rows
constexpr int kPad = kTile + 1;              // products' row stride (words)
constexpr int kMaxState = 16;

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

// The producer warp stages tile j of the block's R rows into ring slot
// j % kRing (a no-op past the last tile; rows past N and hours past T are
// never copied). VEC: 16-byte copies, four hours each (T % 4 == 0 and u
// 16-byte aligned, so every row and tile starts on 16 bytes and len is a
// multiple of 4).
template <int R, bool VEC>
__device__ __forceinline__ void stage_tile(float* U, const float* u, int64_t n0, int N, int T,
                                           int j, int lane) {
  const int t0 = j * kTile;
  if (t0 >= T) return;
  const int len = min(kTile, T - t0);
  float* slot = U + (j % kRing) * (R * kPadU);
  constexpr int kStep = VEC ? 4 : 1;
  for (int e = lane; e < R * (kTile / kStep); e += 32) {
    const int r = e / (kTile / kStep), i = (e % (kTile / kStep)) * kStep;
    if (i < len && n0 + r < N) {
      const float* src = u + (n0 + r) * T + t0 + i;
      if (VEC)
        cp_async16(slot + r * kPadU + i, src);
      else
        cp_async4(slot + r * kPadU + i, src);
    }
  }
}

// One tile's two phases for the block's compute threads: the chains through
// the tile's len hours, then the readout of its (row, hour) pairs. FULL: a
// whole tile of a block whose rows all lie below N, where no hour or pair
// needs a test. The producer warp only meets the readout's barrier.
template <int S, bool WRITE_Y, bool FULL>
__device__ __forceinline__ void tile_phases(const float* Uj, float* P, float* __restrict__ y,
                                            int64_t n0, int N, int T, int t0, int len,
                                            bool chain, float& h, float as, float bs, float ws,
                                            float b) {
  constexpr int R = kThreads / S;                                 // rows a block
  constexpr int kPairs = (R * kTile + kThreads - 1) / kThreads;   // readout pairs a thread
  const int tid = threadIdx.x;
  if (chain) {
    const float* ur = Uj + (tid / S) * kPadU;
    float* pr = P + tid * kPad;
    float uv[kTile];                                // hours past len are read, not used
#pragma unroll
    for (int i = 0; i < kTile; ++i) uv[i] = ur[i];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (FULL || i < len) {
        h = __fadd_rn(__fmul_rn(as, h), __fmul_rn(bs, uv[i]));
        if (WRITE_Y) pr[i] = __fmul_rn(__fsub_rn(h, uv[i]), ws);
      }
    }
  }
  if (WRITE_Y) {
    __syncthreads();                                // every p of the tile is written
    if (tid >= kThreads) return;                    // the producer warp
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      const int e = tid + m * kThreads;
      const int rr = e / kTile, i = e % kTile;
      if ((R * kTile % kThreads == 0 || e < R * kTile) && (FULL || (i < len && n0 + rr < N))) {
        const float* pp = P + rr * S * kPad + i;
        float acc = pp[0];
#pragma unroll
        for (int k = 1; k < S; ++k) acc = __fadd_rn(acc, pp[k * kPad]);
        y[(n0 + rr) * T + t0 + i] = __fadd_rn(__fadd_rn(Uj[rr * kPadU + i], acc), b);
      }
    }
  }
}

template <int S, bool WRITE_Y, bool VEC>
__global__ void __launch_bounds__(kBlock)
forecaster_scan_kernel(const float* __restrict__ u, const float* __restrict__ a,
                       const float* __restrict__ one_minus_a, const float* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ h0, int N,
                       int T, float* __restrict__ y, float* __restrict__ h_out,
                       float* __restrict__ ckpt) {
  constexpr int R = kThreads / S;                   // rows a block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* U = reinterpret_cast<float*>(smem_raw);   // [kRing][R][kPadU]
  float* P = U + kRing * R * kPadU;                 // [R][S][kPad]
  const int64_t n0 = (int64_t)blockIdx.x * R;
  const int tid = threadIdx.x;
  const int r = tid / S, s = tid % S;
  const bool producer = tid >= kThreads;
  const bool chain = tid < R * S && n0 + r < N;    // thread (r, s) walks a state
  const int n_tiles = (T + kTile - 1) / kTile;

  if (producer) {
    for (int j = 0; j < kAhead; ++j) {
      stage_tile<R, VEC>(U, u, n0, N, T, j, tid % 32);
      cp_async_commit();
    }
  }
  float h = 0.0f, as = 0.0f, bs = 0.0f, ws = 0.0f;
  if (chain) {
    h = h0 != nullptr ? h0[(n0 + r) * S + s] : 0.0f;
    as = a[s];
    bs = one_minus_a[s];
    ws = w[s];
  }
  const float b = *bias;

  for (int j = 0; j < n_tiles; ++j) {
    if (producer) cp_async_wait<kAhead - 1>();      // tile j has landed
    __syncthreads();                                // ... for every thread; readout j-1 done
    if (producer) {
      stage_tile<R, VEC>(U, u, n0, N, T, j + kAhead, tid % 32);   // into tile j-1's slot
      cp_async_commit();
    }
    const int t0 = j * kTile, len = min(kTile, T - t0);
    const float* Uj = U + (j % kRing) * (R * kPadU);
    if (ckpt != nullptr && chain) ckpt[((int64_t)j * N + n0) * S + tid] = h;   // coalesced
    if (len == kTile && n0 + R <= N)
      tile_phases<S, WRITE_Y, true>(Uj, P, y, n0, N, T, t0, len, chain, h, as, bs, ws, b);
    else
      tile_phases<S, WRITE_Y, false>(Uj, P, y, n0, N, T, t0, len, chain, h, as, bs, ws, b);
  }
  if (chain) h_out[(n0 + r) * S + s] = h;
}

template <int S, bool WRITE_Y, bool VEC>
int launch_kernel(const float* u, const float* a, const float* oma, const float* w,
                  const float* bias, const float* h0, int N, int T, float* y, float* h_out,
                  float* ckpt, cudaStream_t stream) {
  constexpr int R = kThreads / S;
  const int smem = (kRing * R * kPadU + R * S * kPad) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(forecaster_scan_kernel<S, WRITE_Y, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  forecaster_scan_kernel<S, WRITE_Y, VEC><<<(N + R - 1) / R, kBlock, smem, stream>>>(
      u, a, oma, w, bias, h0, N, T, y, h_out, ckpt);
  return (int)cudaGetLastError();
}

template <int S, bool WRITE_Y>
int launch(const float* u, const float* a, const float* oma, const float* w, const float* bias,
           const float* h0, int N, int T, float* y, float* h_out, float* ckpt,
           cudaStream_t stream) {
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  return (vec ? launch_kernel<S, WRITE_Y, true> : launch_kernel<S, WRITE_Y, false>)(
      u, a, oma, w, bias, h0, N, T, y, h_out, ckpt, stream);
}

using LaunchFn = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, int, int, float*, float*, float*, cudaStream_t);

template <int S>
LaunchFn pick(bool write_y) {
  return write_y ? launch<S, true> : launch<S, false>;
}

LaunchFn pick_state(int S, bool write_y) {
  switch (S) {
    case 1: return pick<1>(write_y);
    case 2: return pick<2>(write_y);
    case 3: return pick<3>(write_y);
    case 4: return pick<4>(write_y);
    case 5: return pick<5>(write_y);
    case 6: return pick<6>(write_y);
    case 7: return pick<7>(write_y);
    case 8: return pick<8>(write_y);
    case 9: return pick<9>(write_y);
    case 10: return pick<10>(write_y);
    case 11: return pick<11>(write_y);
    case 12: return pick<12>(write_y);
    case 13: return pick<13>(write_y);
    case 14: return pick<14>(write_y);
    case 15: return pick<15>(write_y);
    case 16: return pick<16>(write_y);
    default: return nullptr;
  }
}

static_assert(kMaxState == 16, "pick_state instantiates S = 1 .. kMaxState");

}  // namespace

// u (N, T), a / one_minus_a / w (S,), bias (1,), h0 (N, S) or null for zeros;
// y (N, T) (unused when write_y is 0) and h_out (N, S); ckpt (ceil(T / 64), N,
// S) or null for none. S in 1 .. 16.
extern "C" int forecaster_scan_f32(const float* u, const float* a, const float* one_minus_a,
                                   const float* w, const float* bias, const float* h0, int N,
                                   int T, int S, int write_y, float* y, float* h_out,
                                   float* ckpt, void* stream) {
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const LaunchFn fn = pick_state(S, write_y != 0);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  return fn(u, a, one_minus_a, w, bias, h0, N, T, y, h_out, ckpt, (cudaStream_t)stream);
}
