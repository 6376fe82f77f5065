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
//   h_t = a_s * h_{t-1} + (1 - a_s) * u_t,   h_{-1} = h0 (zeros if null),
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
// chain twice (once to checkpoint, once to recompute a tile), three
// operations each, and the reverse step's ten: ~16 float32 lane-operations,
// 0.034 ms at S = 8. But each (row, state) is one dependent chain of T hours,
// and the rows are few: 2048 on the training path.
//
// Design (simple first). One thread a (row, state) chain, R = 128 / S rows a
// block, as forecaster_scan. A first pass walks the chain forward and stores
// its state at every tile boundary (kTile hours) into a global scratch
// (tiles x N x S floats, 4.5 MB at 2048 x 4380, S = 8: any T). A second pass
// walks the tiles in reverse: it recomputes the tile's states from its
// checkpoint into registers, then runs lam back through the tile, the sums in
// the chain's registers. The block stages each tile's u (and dy) rows through
// shared memory, coalesced. The per-row sums go to a (3S + 1, N) scratch, and
// a second kernel of 3S + 1 threads folds each over the rows in index order.
// No atomics: the fixed order is what makes the plain version equal the
// kernel bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                // chain threads a block: rows x states
constexpr int kTile = 64;                    // hours a staged tile (and a checkpoint)
constexpr int kPad = kTile + 1;              // staged rows' stride (words)
constexpr int kMaxState = 16;
constexpr int kFoldThreads = 64;             // >= 3 * kMaxState + 1 sums
constexpr int kFoldBatch = 32;               // rows a fold thread loads at once

// The block stages hours [t0, t0 + len) of its R rows of src into buf.
template <int R>
__device__ __forceinline__ void stage(float* buf, const float* __restrict__ src, int64_t n0,
                                      int N, int T, int t0, int len) {
  for (int e = threadIdx.x; e < R * kTile; e += kThreads) {
    const int r = e / kTile, i = e % kTile;
    if (i < len && n0 + r < N) buf[r * kPad + i] = src[(n0 + r) * T + t0 + i];
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
forecaster_bwd_rows_kernel(const float* __restrict__ u, const float* __restrict__ dy,
                           const float* __restrict__ a, const float* __restrict__ one_minus_a,
                           const float* __restrict__ w, const float* __restrict__ h0, int N,
                           int T, float* __restrict__ ckpt, float* __restrict__ part) {
  constexpr int R = kThreads / S;                   // rows a block
  extern __shared__ float smem[];
  float* U = smem;                                  // [R][kPad] u of the tile
  float* DY = smem + R * kPad;                      // [R][kPad] dy of the tile
  const int64_t n0 = (int64_t)blockIdx.x * R;
  const int tid = threadIdx.x;
  const int r = tid / S, s = tid % S;
  const int64_t n = n0 + r;
  const bool chain = tid < R * S && n < N;         // thread (r, s) walks a state
  const int n_tiles = (T + kTile - 1) / kTile;
  float as = 0.0f, bs = 0.0f, ws = 0.0f, h = 0.0f;
  if (chain) {
    as = a[s];
    bs = one_minus_a[s];
    ws = w[s];
    h = h0 != nullptr ? h0[n * S + s] : 0.0f;
  }

  // Pass 1: the forward chain, its state stored at each tile's start.
  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = j * kTile, len = min(kTile, T - t0);
    __syncthreads();                                // the last tile is read
    stage<R>(U, u, n0, N, T, t0, len);
    __syncthreads();
    if (chain) {
      ckpt[((int64_t)j * N + n) * S + s] = h;
      const float* ur = U + r * kPad;
      for (int i = 0; i < len; ++i) h = __fadd_rn(__fmul_rn(as, h), __fmul_rn(bs, ur[i]));
    }
  }

  // Pass 2: the tiles in reverse, each recomputed from its checkpoint.
  float lam = 0.0f, dA = 0.0f, dB = 0.0f, dW = 0.0f, dBias = 0.0f;
  for (int j = n_tiles - 1; j >= 0; --j) {
    const int t0 = j * kTile, len = min(kTile, T - t0);
    __syncthreads();
    stage<R>(U, u, n0, N, T, t0, len);
    stage<R>(DY, dy, n0, N, T, t0, len);
    __syncthreads();
    if (chain) {
      const float* ur = U + r * kPad;
      const float* dr = DY + r * kPad;
      const float hc = ckpt[((int64_t)j * N + n) * S + s];
      float hs[kTile];                              // h after each hour of the tile
      float hh = hc;
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (i < len) {
          hh = __fadd_rn(__fmul_rn(as, hh), __fmul_rn(bs, ur[i]));
          hs[i] = hh;
        }
      }
#pragma unroll
      for (int i = kTile - 1; i >= 0; --i) {
        if (i < len) {
          const float g = dr[i], uv = ur[i];
          lam = __fadd_rn(__fmul_rn(g, ws), __fmul_rn(as, lam));
          dA = __fadd_rn(dA, __fmul_rn(lam, i > 0 ? hs[i - 1] : hc));
          dB = __fadd_rn(dB, __fmul_rn(lam, uv));
          dW = __fadd_rn(dW, __fmul_rn(g, __fsub_rn(hs[i], uv)));
          dBias = __fadd_rn(dBias, g);
        }
      }
    }
  }
  if (chain) {
    part[(int64_t)s * N + n] = dA;
    part[(int64_t)(S + s) * N + n] = dB;
    part[(int64_t)(2 * S + s) * N + n] = dW;
    if (s == 0) part[(int64_t)(3 * S) * N + n] = dBias;
  }
}

// Each of the Q = 3S + 1 per-row sums folded over the rows, left from row 0.
// The loads of kFoldBatch rows are issued before their adds, so the chain of
// adds waits for one round trip a batch, not one a row.
__global__ void __launch_bounds__(kFoldThreads)
forecaster_bwd_fold_kernel(const float* __restrict__ part, int N, int Q, float* __restrict__ out) {
  const int q = threadIdx.x;
  if (q >= Q) return;
  const float* p = part + (int64_t)q * N;
  float acc = p[0];
  int n = 1;
  for (; n + kFoldBatch <= N; n += kFoldBatch) {
    float v[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) v[k] = p[n + k];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; n < N; ++n) acc = __fadd_rn(acc, p[n]);
  out[q] = acc;
}

template <int S>
int launch(const float* u, const float* dy, const float* a, const float* oma, const float* w,
           const float* h0, int N, int T, float* ckpt, float* part, float* out,
           cudaStream_t stream) {
  constexpr int R = kThreads / S;
  const int smem = 2 * R * kPad * (int)sizeof(float);   // 66.5 KB at S = 1
  cudaError_t err = cudaFuncSetAttribute(forecaster_bwd_rows_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  forecaster_bwd_rows_kernel<S><<<(N + R - 1) / R, kThreads, smem, stream>>>(
      u, dy, a, oma, w, h0, N, T, ckpt, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  forecaster_bwd_fold_kernel<<<1, kFoldThreads, 0, stream>>>(part, N, 3 * S + 1, out);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const float*, const float*, const float*, const float*,
                         const float*, int, int, float*, float*, float*, cudaStream_t);

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

static_assert(kMaxState == 16, "pick_state instantiates S = 1 .. kMaxState");
static_assert(3 * kMaxState + 1 <= kFoldThreads, "one fold thread a sum");

}  // namespace

// u, dy (N, T); a / one_minus_a / w (S,); h0 (N, S) or null for zeros;
// ckpt (ceil(T / 64) x N x S) and part ((3S + 1) x N) scratch; out (3S + 1):
// dA, dB, dW, dbias. S in 1 .. 16. N = 0 writes nothing.
extern "C" int forecaster_scan_bwd_f32(const float* u, const float* dy, const float* a,
                                       const float* one_minus_a, const float* w,
                                       const float* h0, int N, int T, int S, float* ckpt,
                                       float* part, float* out, void* stream) {
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const LaunchFn fn = pick_state(S);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  return fn(u, dy, a, one_minus_a, w, h0, N, T, ckpt, part, out, (cudaStream_t)stream);
}
