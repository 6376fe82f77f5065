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
// Design (S <= kFastState, compile-time instances). Only h is a recurrence:
// y_t needs h at hour t and nothing later. So the readout of a tile can run
// while the chains walk the next one. A block's kChainThreads chain threads
// own R = kChainThreads / S rows, thread (r, s) walking state s of row r;
// each step j of the block
// - the chain warps walk tile j of kTile hours: an hour is a * h and
//   (1 - a) * u, their sum (the chain: two dependent operations) and the
//   hour's product (h - u) * w off the chain, four hours' products a 16-byte
//   store into the product buffer of tile j's parity;
// - the readout warps fold tile j - 1 from the other buffer in quads of four
//   hours of a row: each state's four products one 16-byte load, the S of
//   each hour added left from state 0, y one 16-byte store;
// - the producer warp stages the u tile kAhead tiles ahead with cp.async
//   (16-byte copies when T is a multiple of 4 and u is 16-byte aligned, else
//   4-byte copies; lanes over a row's contiguous hours, any T) into a ring of
//   kRing = kAhead + 2 slots: tile j (the chains), tile j - 1 (the readout)
//   and the kAhead in flight;
// with one __syncthreads a step. A block is one warp of each role: at S = 8
// it holds 4 rows, and 2048 rows take 512 blocks, about four an SM, so that
// while one block waits at its barrier or reads out, the others' chains run.
// The state-only instance has no readout warp.
// What the card showed (PERF.md): a warp's chain waits ~8 cycles an hour on
// itself, and another warp on its scheduler delays it (the scheduler does
// not favour the chain). So the readout is kept short: the products are the
// chain warp's (their issue fills the chain's stalls in its own instruction
// stream) and the readout only adds; both move four hours an instruction
// through shared memory; and the blocks are small, so that an SM's other
// blocks cover each one's barrier and readout. Slower on the card: blocks of
// four warps of each role, one an SM, with the chains storing their states
// and the readout forming the products; the readout interleaved into each
// chain warp's hours; the readout warps on two schedulers and the chains on
// the other two; the u tiles staged by bulk copies (the tensor memory
// accelerator) on an mbarrier a slot; the copies issued by the readout warp.
// What the first designs taught, and what this one keeps:
// - A chain thread loads its row's whole tile into registers first, every
//   load issued before the chain. Loads from shared memory that follow its
//   stores may not pass them, so a load an hour put a shared-memory round
//   trip into every hour of the chain.
// - A warp stages the u tiles: when the chain threads staged them
//   themselves, sending the copies cost them about as long a tile as the
//   chain.
// - A whole tile of a full block runs with no test an hour or a pair.
// The ring's and the product buffers' rows are kTile + 4 words apart: 16-byte
// rows, a warp's 16-byte accesses on distinct banks in each group of eight
// lanes.
//
// Any other S (more than kFastState states) takes one run-time instance,
// forecaster_scan_any_kernel: a block a row, its threads over the states in
// passes of kAnyThreads, each state kept in the output h between tiles (the
// thread that walks it reads back its own store), each pass's products in
// shared memory, folded into each hour's running sum by the thread of that
// hour, left from state 0. The same operations in the same order as the
// plain version, so the same bits at every S; it is not tuned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChainThreads = 32;            // chain threads a block (a warp): rows x states
constexpr int kReadThreads = 32;             // readout threads a block (a warp)
constexpr int kTile = 64;                    // hours a staged tile
constexpr int kPadU = kTile + 4;             // u ring row stride (words): 16-byte rows
constexpr int kPadH = kTile + 4;             // products' row stride (words): 16-byte rows
constexpr int kPad = kTile + 1;              // the run-time instance's products' row stride
constexpr int kFastState = 16;               // compile-time instances: S = 1 .. kFastState
constexpr int kAnyThreads = 128;             // the run-time instance's block: states a pass

// The block of the instance that writes y (chain warps, readout warps, the
// producer warp) or only the state (chain warps, the producer warp).
template <bool WRITE_Y>
__host__ __device__ constexpr int block_threads() {
  return kChainThreads + (WRITE_Y ? kReadThreads : 0) + 32;
}

// An instance's geometry: R rows a block; kAhead tiles in flight ahead of the
// chains in a ring of kRing = kAhead + 2 u tiles (j - 1 .. j + kAhead); the
// readout's kQuads quads (four hours of a row) a tile, kQuadsPer a readout
// thread; the dynamic shared memory: the ring, then (WRITE_Y) the two
// product buffers.
template <int S, bool WRITE_Y>
struct Geo {
  static constexpr int R = kChainThreads / S;
  static constexpr int kAhead = 4;
  static constexpr int kRing = kAhead + 2;
  static constexpr int kQuads = R * (kTile / 4);
  static constexpr int kQuadsPer = (kQuads + kReadThreads - 1) / kReadThreads;
  static constexpr int kSmem = (kRing * R * kPadU + (WRITE_Y ? 2 * R * S * kPadH : 0)) * 4;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The producer warp stages tile j of the block's R rows into ring slot
// j % RING (a no-op past the last tile; rows past N and hours past T are
// never copied). VEC: 16-byte copies, four hours each (T % 4 == 0 and u
// 16-byte aligned, so every row and tile starts on 16 bytes and len is a
// multiple of 4).
template <int R, int RING, bool VEC>
__device__ __forceinline__ void stage_tile(float* U, const float* u, int64_t n0, int N, int T,
                                           int j, int lane) {
  const int t0 = j * kTile;
  if (t0 >= T) return;
  const int len = min(kTile, T - t0);
  float* slot = U + (j % RING) * (R * kPadU);
  const int rows = (int)min((int64_t)R, N - n0);
  constexpr int kStep = VEC ? 4 : 1;
  for (int e = lane; e < rows * (kTile / kStep); e += 32) {
    const int r = e / (kTile / kStep), i = (e % (kTile / kStep)) * kStep;
    if (i < len) {
      const float* src = u + (n0 + r) * T + t0 + i;
      if (VEC)
        cp_async16(slot + r * kPadU + i, src);
      else
        cp_async4(slot + r * kPadU + i, src);
    }
  }
}

// A chain thread's walk through the len hours of a tile from its staged u
// row ur: each hour's product (h - u) * w_s into hr (WRITE_Y), four hours a
// 16-byte store in a whole tile. FULL: a whole tile. The tile's u is loaded
// into registers first, every load issued before the chain.
template <bool WRITE_Y, bool FULL>
__device__ __forceinline__ void chain_tile(const float* ur, float* hr, int len, float& h,
                                           float as, float bs, float ws) {
  float uv[kTile];                                  // hours past len are read, not used
#pragma unroll
  for (int i = 0; i < kTile; ++i) uv[i] = ur[i];
  asm volatile("" ::: "memory");
  auto hour = [&](int i) {
    h = __fadd_rn(__fmul_rn(as, h), __fmul_rn(bs, uv[i]));
    return __fmul_rn(__fsub_rn(h, uv[i]), ws);
  };
  if (FULL) {
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      float4 o;
      o.x = hour(4 * q);
      o.y = hour(4 * q + 1);
      o.z = hour(4 * q + 2);
      o.w = hour(4 * q + 3);
      if (WRITE_Y) reinterpret_cast<float4*>(hr)[q] = o;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < len) {
        const float pv = hour(i);
        if (WRITE_Y) hr[i] = pv;
      }
    }
  }
}

// The readout of one hour from a (row, hour)'s S products hk(k) and u: the
// products folded left from s = 0, then y = (u + acc) + bias.
template <int S, class HK>
__device__ __forceinline__ float readout(HK hk, float uv, float b) {
  float acc = hk(0);
#pragma unroll
  for (int k = 1; k < S; ++k) acc = __fadd_rn(acc, hk(k));
  return __fadd_rn(__fadd_rn(uv, acc), b);
}

// A readout thread's share of a tile, from its products H and staged u Uj.
// QUADS (a whole tile of a full block, T % 4 == 0): quads of four hours of a
// row, each state's four hours one 16-byte load and y one 16-byte store.
// Else (row, hour) pairs one at a time, the hours below len of the rows
// below N.
template <int S, bool QUADS>
__device__ __forceinline__ void readout_tile(const float* Uj, const float* H, float* y,
                                             int64_t n0, int N, int T, int t0, int len, int rt,
                                             float b) {
  using G = Geo<S, true>;
  constexpr int R = G::R;
  if (QUADS) {
#pragma unroll 4
    for (int m = 0; m < G::kQuadsPer; ++m) {
      const int q = rt + m * kReadThreads;
      if (G::kQuads % kReadThreads != 0 && q >= G::kQuads) break;
      const int rr = q / (kTile / 4), i0 = (q % (kTile / 4)) * 4;
      const float4 u4 = *reinterpret_cast<const float4*>(Uj + rr * kPadU + i0);
      const float4* hq = reinterpret_cast<const float4*>(H + rr * S * kPadH + i0);
      float4 acc = hq[0];                           // the products folded left from s = 0
#pragma unroll
      for (int k = 1; k < S; ++k) {
        const float4 v = hq[k * (kPadH / 4)];
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      float4 o;
      o.x = __fadd_rn(__fadd_rn(u4.x, acc.x), b);
      o.y = __fadd_rn(__fadd_rn(u4.y, acc.y), b);
      o.z = __fadd_rn(__fadd_rn(u4.z, acc.z), b);
      o.w = __fadd_rn(__fadd_rn(u4.w, acc.w), b);
      *reinterpret_cast<float4*>(y + (n0 + rr) * T + t0 + i0) = o;
    }
  } else {
    for (int e = rt; e < R * kTile; e += kReadThreads) {
      const int rr = e / kTile, i = e % kTile;
      if (i < len && n0 + rr < N) {
        const float* hp = H + rr * S * kPadH + i;
        y[(n0 + rr) * T + t0 + i] =
            readout<S>([&](int k) { return hp[k * kPadH]; }, Uj[rr * kPadU + i], b);
      }
    }
  }
}

template <int S, bool WRITE_Y, bool VEC>
__global__ void __launch_bounds__(block_threads<WRITE_Y>())
forecaster_scan_kernel(const float* __restrict__ u, const float* __restrict__ a,
                       const float* __restrict__ one_minus_a, const float* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ h0, int N,
                       int T, float* __restrict__ y, float* __restrict__ h_out,
                       float* __restrict__ ckpt) {
  using G = Geo<S, WRITE_Y>;
  constexpr int R = G::R;                           // rows a block
  constexpr int kRing = G::kRing;
  constexpr int kProducer = block_threads<WRITE_Y>() - 32;   // the producer warp's first thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* U = reinterpret_cast<float*>(smem_raw);   // [kRing][R][kPadU]
  float* H = U + kRing * R * kPadU;                 // [2][R * S][kPadH] (WRITE_Y)
  const int64_t n0 = (int64_t)blockIdx.x * R;
  const int tid = threadIdx.x;
  const bool producer = tid >= kProducer;
  const bool chain_warp = tid < kChainThreads;
  const int r = tid / S, s = tid % S;
  const bool chain = chain_warp && tid < R * S && n0 + r < N;   // thread (r, s) walks a state
  const int n_tiles = (T + kTile - 1) / kTile;
  const bool full_rows = n0 + R <= N;

  if (producer) {
    for (int j = 0; j < G::kAhead; ++j) {
      stage_tile<R, kRing, VEC>(U, u, n0, N, T, j, tid % 32);
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
  [[maybe_unused]] const float b = WRITE_Y && !chain_warp && !producer ? *bias : 0.0f;

  // Step j: the chains walk tile j, the readout warps fold tile j - 1.
  const int n_steps = WRITE_Y ? n_tiles + 1 : n_tiles;
  for (int j = 0; j < n_steps; ++j) {
    if (producer && j < n_tiles) cp_async_wait<G::kAhead - 1>();   // tile j has landed
    __syncthreads();                                // ... for every thread; step j - 1 done
    if (producer) {
      stage_tile<R, kRing, VEC>(U, u, n0, N, T, j + G::kAhead, tid % 32);   // tile j-2's slot
      cp_async_commit();
    } else if (chain_warp) {
      if (j < n_tiles && chain) {
        const int len = min(kTile, T - j * kTile);
        if (ckpt != nullptr) ckpt[((int64_t)j * N + n0) * S + tid] = h;   // coalesced
        const float* ur = U + (j % kRing) * (R * kPadU) + r * kPadU;
        float* hr = H + ((j & 1) * R * S + tid) * kPadH;
        if (len == kTile)
          chain_tile<WRITE_Y, true>(ur, hr, len, h, as, bs, ws);
        else
          chain_tile<WRITE_Y, false>(ur, hr, len, h, as, bs, ws);
      }
    } else if constexpr (WRITE_Y) {
      if (j >= 1) {
        const int jr = j - 1, t0 = jr * kTile, len = min(kTile, T - t0);
        const float* Uj = U + (jr % kRing) * (R * kPadU);
        const float* Hj = H + (jr & 1) * R * S * kPadH;
        const int rt = tid - kChainThreads;
        if (VEC && len == kTile && full_rows)
          readout_tile<S, true>(Uj, Hj, y, n0, N, T, t0, len, rt, b);
        else
          readout_tile<S, false>(Uj, Hj, y, n0, N, T, t0, len, rt, b);
      }
    }
  }
  if (chain) h_out[(n0 + r) * S + s] = h;
}

template <int S, bool WRITE_Y, bool VEC>
int launch_kernel(const float* u, const float* a, const float* oma, const float* w,
                  const float* bias, const float* h0, int N, int T, float* y, float* h_out,
                  float* ckpt, cudaStream_t stream) {
  constexpr int R = Geo<S, WRITE_Y>::R;
  constexpr int smem = Geo<S, WRITE_Y>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(forecaster_scan_kernel<S, WRITE_Y, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  forecaster_scan_kernel<S, WRITE_Y, VEC>
      <<<(N + R - 1) / R, block_threads<WRITE_Y>(), smem, stream>>>(u, a, oma, w, bias, h0, N,
                                                                     T, y, h_out, ckpt);
  return (int)cudaGetLastError();
}

// VEC: T a multiple of 4 and u and y 16-byte aligned (the 16-byte copies of
// u, the readout's 16-byte stores of y).
template <int S, bool WRITE_Y>
int launch(const float* u, const float* a, const float* oma, const float* w, const float* bias,
           const float* h0, int N, int T, float* y, float* h_out, float* ckpt,
           cudaStream_t stream) {
  const bool vec = T % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   (!WRITE_Y || reinterpret_cast<uintptr_t>(y) % 16 == 0);
  return (vec ? launch_kernel<S, WRITE_Y, true> : launch_kernel<S, WRITE_Y, false>)(
      u, a, oma, w, bias, h0, N, T, y, h_out, ckpt, stream);
}

// The run-time instance, for S past kFastState: a block a row (see the design
// notes above). h_out holds the row's states between tiles.
__global__ void __launch_bounds__(kAnyThreads)
forecaster_scan_any_kernel(const float* __restrict__ u, const float* __restrict__ a,
                           const float* __restrict__ one_minus_a, const float* __restrict__ w,
                           const float* __restrict__ bias, const float* __restrict__ h0, int N,
                           int T, int S, int write_y, float* __restrict__ y,
                           float* __restrict__ h_out, float* __restrict__ ckpt) {
  __shared__ float us[kTile];
  __shared__ float P[kAnyThreads][kPad];            // a pass's products
  const int64_t n = blockIdx.x;
  const int tid = threadIdx.x;
  float* hrow = h_out + n * S;
  for (int s = tid; s < S; s += kAnyThreads) hrow[s] = h0 != nullptr ? h0[n * S + s] : 0.0f;
  const float b = *bias;
  float acc = 0.0f;                                 // thread i: hour i's running fold
  const int n_tiles = (T + kTile - 1) / kTile;
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kTile, len = min(kTile, T - t0);
    __syncthreads();                                // the last tile's us and P are read
    if (tid < len) us[tid] = u[n * T + t0 + tid];
    if (ckpt != nullptr)
      for (int s = tid; s < S; s += kAnyThreads) ckpt[((int64_t)j * N + n) * S + s] = hrow[s];
    __syncthreads();
    for (int s0 = 0; s0 < S; s0 += kAnyThreads) {
      const int s = s0 + tid;
      if (s < S) {                                  // state s through the tile
        float h = hrow[s];
        const float as = a[s], bs = one_minus_a[s], ws = w[s];
        for (int i = 0; i < len; ++i) {
          const float ui = us[i];
          h = __fadd_rn(__fmul_rn(as, h), __fmul_rn(bs, ui));
          if (write_y) P[tid][i] = __fmul_rn(__fsub_rn(h, ui), ws);
        }
        hrow[s] = h;
      }
      if (write_y) {
        __syncthreads();                            // the pass's products are written
        if (tid < len) {
          const int ns = min(kAnyThreads, S - s0);
          int q = 0;
          if (s0 == 0) acc = P[q++][tid];
          for (; q < ns; ++q) acc = __fadd_rn(acc, P[q][tid]);
        }
        __syncthreads();                            // ... and read
      }
    }
    if (write_y && tid < len) y[n * T + t0 + tid] = __fadd_rn(__fadd_rn(us[tid], acc), b);
  }
}

int launch_any(const float* u, const float* a, const float* oma, const float* w,
               const float* bias, const float* h0, int N, int T, int S, bool write_y, float* y,
               float* h_out, float* ckpt, cudaStream_t stream) {
  forecaster_scan_any_kernel<<<N, kAnyThreads, 0, stream>>>(u, a, oma, w, bias, h0, N, T, S,
                                                           write_y ? 1 : 0, y, h_out, ckpt);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, int, int, float*, float*, float*, cudaStream_t);

template <int S>
LaunchFn pick(bool write_y) {
  return write_y ? launch<S, true> : launch<S, false>;
}

// The compile-time instance of S, or null past kFastState.
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

static_assert(kFastState == 16, "pick_state instantiates S = 1 .. kFastState");
static_assert(Geo<1, true>::kSmem <= 232448 && Geo<2, true>::kSmem <= 232448,
              "shared memory of the largest compile-time instances");
static_assert(kTile % 4 == 0 && kPadU % 4 == 0 && kPadH % 4 == 0, "16-byte rows");

}  // namespace

// u (N, T), a / one_minus_a / w (S,), bias (1,), h0 (N, S) or null for zeros;
// y (N, T) (unused when write_y is 0) and h_out (N, S); ckpt (ceil(T / 64), N,
// S) or null for none. Any S >= 1: S = 1 .. 16 take their compile-time
// instances, a larger S the run-time one.
extern "C" int forecaster_scan_f32(const float* u, const float* a, const float* one_minus_a,
                                   const float* w, const float* bias, const float* h0, int N,
                                   int T, int S, int write_y, float* y, float* h_out,
                                   float* ckpt, void* stream) {
  if (N < 0 || T < 0 || S < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const LaunchFn fn = pick_state(S, write_y != 0);
  if (fn == nullptr)
    return launch_any(u, a, one_minus_a, w, bias, h0, N, T, S, write_y != 0, y, h_out, ckpt,
                      (cudaStream_t)stream);
  return fn(u, a, one_minus_a, w, bias, h0, N, T, y, h_out, ckpt, (cudaStream_t)stream);
}
