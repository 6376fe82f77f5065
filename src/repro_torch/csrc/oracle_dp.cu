// Offline-optimal cost-to-go of every row of a fleet or a topology.
//
// Replaces: the numpy dynamic program of src/repro/core/oracle.py:64
// (offline_optimal's backward pass), which the reference's fleet_oracle
// (src/repro/fleet/engine.py:614) and topology_oracle (:589) run row by row
// in Python, a dozen numpy calls an hour. For every row the kernels run that
// recurrence over the row's states
//
//   0               OFF        (serve VPN; stay, or request CCI)
//   1 .. D          WAITING j  (serve VPN; j provisioning hours left)
//   D+1 .. D+Tc     ON, j commitment hours left (serve CCI)
//   D+Tc+1          ON past the commitment (serve CCI; stay, or release)
//
// backwards over the hours from V = 0, with the reference's edge branches
// (D == 0 requests serve CCI in the request hour, D == 1 requests land in ON
// with the full commitment, Tc == 1 lands in ON free):
//
//   V'[OFF]     = req < stay ? req : stay      stay = vpn[t] + V[OFF]
//                                              req  = (D > 0 ? vpn : cci)[t] + V[req_next]
//   V'[wait j]  = vpn[t] + V[j == 1 ? on_fresh : wait j-1]
//   V'[on j]    = cci[t] + V[j == 1 ? on_free : on j-1]
//   V'[on_free] = stay_on <= release ? stay_on : release
//                 stay_on = cci[t] + V[on_free], release = vpn[t] + V[OFF]
//
// and returns the row's total, V[OFF], or V[on_free] when head starts are
// allowed and it is strictly smaller (as Python's min() picks the first of
// equals), and whether it started ON. Each add is __dadd_rn(cost, state)
// (and the source builds with -fmad=false), so every value equals numpy's
// scalar and slice adds bit for bit. The comparisons are the reference's:
// false on NaN, so a NaN keeps `stay` at OFF and `release` at ON free, as in
// numpy; no fmin/fmax, which would drop the NaN. The schedule stays on the
// host (repro_torch.core.oracle.offline_optimal); the reports need the totals.
//
// What bounds it on an H100: operations. At 2048 rows x 8760 hours with the
// fleet scenario's ~268 states a row the DP does ~4.9e9 float64 adds and
// compares; an add or a compare takes a whole float64 lane-cycle, so at the
// card's 17e12 of them a second (half its 34 TFLOP/s, which counts an FMA
// as two) that is 0.29 ms; the vpn and cci planes, 287 MB, are 0.086 ms at
// 3.35 TB/s.
//
// Two forms; the host's launch plan (kernels/oracle_dp.py::launch_plan)
// picks one for each row from D and Tc alone, and a call launches each form
// that has rows (the reports' batches all take the register form).
//
// Register form (oracle_dp_rows_kernel): one warp a row, 4 to 16 rows a
// block (about one block an SM; the host picks), no block barrier. Apart
// from OFF and ON free, every state reads one state of the next hour, and
// those reads form one chain
//
//   ON free -> ON 1 -> ... -> ON Tc -> WAITING 1 -> ... -> WAITING D-1 -> req
//
// (D == 1: req reads ON Tc; D == 0: ON Tc-1, or ON free when Tc == 1;
// WAITING D, and ON Tc when D == 0, are read by no state). A value entering
// the chain at ON 1 adds one CCI hour a step for R1 = Tc (Tc - 1 when D ==
// 0) steps, then one VPN hour a step for R2 = max(D - 1, 0) steps, and is
// read by the request. Laid out as one shift register of the chain, both
// its ends and the CCI/VPN boundary would sit at run-time register
// positions (Tc and D vary by row): a run-time index sends the array to
// local memory, and the alternative is a select for every state. So the two
// segments are held apart, each adding one plane only:
//
//   ON:   a ring of R1 slots, slot s in lane s / K1, register s % K1. The
//         values stay put: every hour every slot adds cci[t] (the same add,
//         cci[t] + ON j(t+1), as the state's), and the ring head, one slot
//         further each hour, holds the value that has aged R1 hours (ON R1
//         of hour t + 1). One __shfl_sync broadcasts it, and the head's
//         lane replaces it with ON 1 of hour t (cci[t] + ON free). The hour
//         loop is unrolled over the K1 registers, so the head's register is
//         a compile-time index and only its lane is a run-time one.
//   WAIT: a shift register of R2 positions, three a lane (position p in
//         lane p / 3, register p % 3), updated in place from the top
//         register down (w[q] = vpn[t] + w[q-1]); one __shfl_up_sync
//         carries each lane's top into the next lane (a value crosses a lane
//         every third hour), and lane 0 takes the ON ring's broadcast. The
//         request's operand, the top position, comes with one __shfl_sync
//         after a select over the three registers.
//
// OFF and ON free are two scalars every lane computes alike. Each K1 from 1
// to 12, with and without the WAITING registers, is a template instance
// (25 in all); each warp switches on its own row's instance, and the rows
// are ordered by instance on the card, so a block's rows, and so an SM's
// warps, mostly run one instance's code (warps of many instances on one SM
// thrash its instruction cache). The hour costs are staged per warp in a
// ring of four 64-hour tiles in shared memory with cp.async (one 8-byte
// copy a lane, plane and 32 hours), one tile ahead, so no hour waits on
// device memory. As built for sm_90a a whole ring block is one basic block
// in which selects, shuffles and integer work outnumber the DP's adds, so
// at four warps a scheduler the issue slots, not the float64 units, are
// what a 2048-row call spends.
//
// Large-row form (oracle_dp_block_kernel): the first form of this kernel,
// unchanged, for rows the register form does not hold (Tc past 384 or D
// past 97, or every row when the caller forces it): one block a row, one
// thread a state, the states double-buffered in shared memory (one barrier
// an hour), the hour costs staged backwards in tiles of blockDim hours. It
// is bound by its 8760 dependent barrier rounds a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB, the most a block can hold
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;                // rows a block, register form, at most
constexpr int kTile = 64;                    // hours a staged tile
constexpr int kSlots = 4 * kTile;            // the staging ring, hours a plane

// ---------------------------------------------------------------------------
// Register form
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Tile k (hours [64k, 64k + 64) below T) of both planes into the ring, one
// commit group. Branch-free: a lane past T copies nothing (src-size 0, the
// slot zero-filled; no hour reads it), so the warp never diverges here.
__device__ __forceinline__ void stage_tile(double* sv, double* sc, const double* v_row,
                                           const double* c_row, int k, int T, int lane) {
#pragma unroll
  for (int j = 0; j < kTile; j += 32) {
    const int h = k * kTile + j + lane;
    const int hc = h < T ? h : T - 1;
    const int bytes = h < T ? 8 : 0;
    const unsigned dv = static_cast<unsigned>(__cvta_generic_to_shared(sv + (h & (kSlots - 1))));
    const unsigned dc = static_cast<unsigned>(__cvta_generic_to_shared(sc + (h & (kSlots - 1))));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dv), "l"(v_row + hc),
                 "r"(bytes) : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dc), "l"(c_row + hc),
                 "r"(bytes) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The register form's hour is software-pipelined. ORACLE_HOUR(r, rr, hh)
// updates every state from hour t + 1 to hour t, the ring head in register
// r of lane hl, with operands read during the hour before (cv, cc, out,
// up, src); in between, once the values they read are made and before
// OFF's and ON free's compares and selects, it reads the next hour's: its
// two costs from shared memory, the ON ring's output from register rr of
// lane hh, the WAITING carry and top. Each group of shuffles in a
// warp-divergence-checked region starts a basic block, so the compiler
// cannot move them up itself; issued here, their latency (tens of cycles
// each) runs under the compares and the next hour's ring adds instead of
// opening every hour.
#define ORACLE_READS(rr, hh)                                                        \
  {                                                                                 \
    const int s_ = t & (kSlots - 1);                                                \
    cv = sv[s_];                                                                    \
    cc = sc[s_];                                                                    \
    if constexpr (K1 > 0) {                                                         \
      out = __shfl_sync(kFull, v[rr], (hh));                                        \
    }                                                                               \
    if constexpr (K2 > 0) {                                                         \
      up = __shfl_up_sync(kFull, w[K2 - 1], 1);                                     \
      double x_ = w[0];                                                             \
      _Pragma("unroll") for (int q = 1; q < K2; ++q) x_ = top_reg == q ? w[q] : x_; \
      src = __shfl_sync(kFull, x_, top_lane);                                       \
    }                                                                               \
  }

#define ORACLE_HOUR(r, rr, hh)                                                      \
  {                                                                                 \
    const double cv0 = cv, cc0 = cc;                                                \
    const double stay = __dadd_rn(cv0, off);                                        \
    const double stay_on = __dadd_rn(cc0, onf);                                     \
    if constexpr (K1 > 0) {                                                         \
      _Pragma("unroll") for (int q = 0; q < K1; ++q)                                \
          v[q] = __dadd_rn(cc0, (q == (r) && head_lane) ? onf : v[q]);              \
    } else {                                                                        \
      out = onf; /* no ring: the request and WAITING 1 read ON free */              \
    }                                                                               \
    if constexpr (K2 > 0) {                                                         \
      _Pragma("unroll") for (int q = K2 - 1; q > 0; --q) w[q] = __dadd_rn(cv0, w[q - 1]); \
      w[0] = __dadd_rn(cv0, lane0 ? out : up);                                      \
    } else {                                                                        \
      src = out;                                                                    \
    }                                                                               \
    const double req = __dadd_rn(K2 > 0 ? cv0 : (req_cci ? cc0 : cv0), src);       \
    --t;                                                                            \
    ORACLE_READS(rr, hh)                                                            \
    off = req < stay ? req : stay;                                                  \
    onf = stay_on <= stay ? stay_on : stay;                                         \
  }

// One row on one warp: V[OFF] and V[on_free] at hour 0 into off_out/onf_out
// (every lane alike). K1 >= ceil(R1 / 32) and K2 >= ceil(R2 / 32), with K2
// == 0 exactly when R2 == 0 and K1 == 0 exactly when R1 == 0.
template <int K1, int K2>
__device__ __forceinline__ void row_dp(const double* __restrict__ v_row,
                                       const double* __restrict__ c_row, int D, int Tc, int T,
                                       double* sv, double* sc, int lane, double& off_out,
                                       double& onf_out) {
  constexpr int KU = K1 > 0 ? K1 : 1;   // hours a ring block
  constexpr int KW = K2 > 0 ? K2 : 1;
  const int R1 = Tc - (D == 0 ? 1 : 0);
  const int R2 = D > 1 ? D - 1 : 0;
  double v[KU], w[KW];
#pragma unroll
  for (int q = 0; q < KU; ++q) v[q] = 0.0;
#pragma unroll
  for (int q = 0; q < KW; ++q) w[q] = 0.0;
  double off = 0.0, onf = 0.0;
  const bool req_cci = D == 0;
  const bool lane0 = lane == 0;
  const int top_lane = K2 > 0 ? (R2 - 1) / K2 : 0;
  const int top_reg = K2 > 0 ? (R2 - 1) % K2 : 0;
  const int nb = K1 > 0 ? (R1 + K1 - 1) / K1 : 1;   // lanes the ring spans
  const int last = K1 > 0 ? R1 - (nb - 1) * K1 : 1;  // its slots in the last one

  int t = T - 1;
  int k_done = 0;   // lowest tile known to be in shared memory
  double cv = 0.0, cc = 0.0, out = 0.0, up = 0.0, src = 0.0;   // the next hour's operands
  if (T > 0) {
    k_done = t / kTile;
    stage_tile(sv, sc, v_row, c_row, k_done, T, lane);
    cp_async_wait_all();
    __syncwarp();
    if (k_done > 0) stage_tile(sv, sc, v_row, c_row, k_done - 1, T, lane);
    ORACLE_READS(0, 0)
  }
  int hl = 0;   // the ring head's lane; its register is the unrolled r
  while (t >= 0) {
    const int n = hl == nb - 1 ? last : KU;
    const int m = n < t + 1 ? n : t + 1;   // hours of this ring block
    const int hl_next = hl + 1 == nb ? 0 : hl + 1;
    // The block reads hours t - m + 1 .. t and, ahead, t - m: at most one
    // tile down (m <= 12 < 64), which was prefetched a tile ago. The one
    // below goes into the slot of the tile three above, which no hour
    // left reads.
    const int k_low = (t - m > 0 ? t - m : 0) / kTile;
    if (k_low < k_done) {
      cp_async_wait_all();
      __syncwarp();
      k_done = k_low;
      if (k_low > 0) stage_tile(sv, sc, v_row, c_row, k_low - 1, T, lane);
    }
    const bool head_lane = lane == hl;
    if (m == KU) {   // a whole block: no branch between its hours
#pragma unroll
      for (int r = 0; r < KU; ++r)
        ORACLE_HOUR(r, r + 1 < KU ? r + 1 : 0, r + 1 < KU ? hl : hl_next)
    } else {
#pragma unroll
      for (int r = 0; r < KU; ++r) {
        if (r >= m) break;
        const int rn = r + 1 < m ? r + 1 : 0;   // the next hour's head register ...
        if (rn == 0) {
          ORACLE_HOUR(r, 0, hl_next)   // ... 0, in the next lane
        } else {
          ORACLE_HOUR(r, (r + 1) % KU, hl)
        }
      }
    }
    hl = hl_next;
  }
  off_out = off;
  onf_out = onf;
}

#undef ORACLE_HOUR
#undef ORACLE_READS

#define ORACLE_ROW(K1, K2)                                                        \
  case (K1) * 4 + (K2):                                                           \
    row_dp<K1, K2>(v_row, c_row, D_[row], Tc_[row], T, sv, sc, lane, off, onf);   \
    break;
#define ORACLE_ROWS(K1) ORACLE_ROW(K1, 0) ORACLE_ROW(K1, 3)

// Up to 16 rows (warps) a block: 128 registers a thread at most, so the
// largest instance's ~85 keep clear of spills.
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
oracle_dp_rows_kernel(const double* __restrict__ vpn,   // (N, T)
                      const double* __restrict__ cci,   // (N, T)
                      const int* __restrict__ D_,       // (N,)
                      const int* __restrict__ Tc_,      // (N,)
                      const int* __restrict__ order,    // (n_rows,) rows of this form
                      const int* __restrict__ regs,     // (N,) K1 * 4 + K2 of each row
                      int n_rows, int T, int allow_head_start,
                      double* __restrict__ total, unsigned char* __restrict__ start_on) {
  extern __shared__ __align__(16) double stage[];   // per warp: kSlots of vpn, kSlots of cci
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= n_rows) return;   // the whole warp: nothing below waits on the block
  const int64_t row = order[i];
  const double* v_row = vpn + row * T;
  const double* c_row = cci + row * T;
  double* sv = stage + warp * 2 * kSlots;
  double* sc = sv + kSlots;
  double off = 0.0, onf = 0.0;
  switch (regs[row]) {
    ORACLE_ROW(0, 0)
    ORACLE_ROWS(1) ORACLE_ROWS(2) ORACLE_ROWS(3) ORACLE_ROWS(4)
    ORACLE_ROWS(5) ORACLE_ROWS(6) ORACLE_ROWS(7) ORACLE_ROWS(8)
    ORACLE_ROWS(9) ORACLE_ROWS(10) ORACLE_ROWS(11) ORACLE_ROWS(12)
    default:   // not a pair launch_plan gives: a loud NaN, never a plausible total
      off = onf = __longlong_as_double(0x7ff8dead0000dead);
  }
  if (lane == 0) {
    const bool take_on = allow_head_start && onf < off;
    total[row] = take_on ? onf : off;
    start_on[row] = take_on ? 1 : 0;
  }
}

#undef ORACLE_ROWS
#undef ORACLE_ROW

// ---------------------------------------------------------------------------
// Large-row form
// ---------------------------------------------------------------------------

__global__ void oracle_dp_block_kernel(const double* __restrict__ vpn,   // (N, T)
                                       const double* __restrict__ cci,   // (N, T)
                                       const int* __restrict__ D_,       // (N,)
                                       const int* __restrict__ Tc_,      // (N,)
                                       const int* __restrict__ order,    // (grid,) its rows
                                       int T, int S_max, int allow_head_start,
                                       double* __restrict__ total,       // (N,)
                                       unsigned char* __restrict__ start_on) {
  extern __shared__ double smem[];
  const int nthreads = blockDim.x;
  double* cur = smem;                    // S_max state values, hour t + 1
  double* nxt = smem + S_max;            // S_max state values, hour t
  double* tile_v = smem + 2 * S_max;     // nthreads hours of vpn
  double* tile_c = tile_v + nthreads;    // nthreads hours of cci

  const int tid = threadIdx.x;
  const int64_t row = order[blockIdx.x];
  const int D = D_[row];
  const int Tc = Tc_[row];
  const int on0 = D + 1;
  const int on_free = D + Tc + 1;
  const int on_fresh = on0 + Tc - 1;
  const int S = on_free + 1;
  const int req_next = D > 1 ? D - 1 : (D == 1 ? on_fresh : (Tc > 1 ? on0 + Tc - 2 : on_free));
  const double* v_row = vpn + row * T;
  const double* c_row = cci + row * T;

  // Padding threads and states past a row's own count are never read by a
  // real state (every state reads a lower index or on_fresh/on_free, all
  // below the row's count).
  for (int s = tid; s < S; s += nthreads) cur[s] = 0.0;
  for (int hi = T; hi > 0; hi -= nthreads) {
    const int lo = hi > nthreads ? hi - nthreads : 0;
    // The last hour's barrier (or none yet) leaves the tile free to overwrite.
    if (lo + tid < hi) {
      tile_v[tid] = v_row[lo + tid];
      tile_c[tid] = c_row[lo + tid];
    }
    __syncthreads();
    for (int t = hi - 1; t >= lo; --t) {
      const double cv = tile_v[t - lo];
      const double cc = tile_c[t - lo];
      for (int s = tid; s < S; s += nthreads) {
        double v;
        if (s == 0) {
          const double stay = __dadd_rn(cv, cur[0]);
          const double req = __dadd_rn(D > 0 ? cv : cc, cur[req_next]);
          v = req < stay ? req : stay;
        } else if (s == on_free) {
          const double stay_on = __dadd_rn(cc, cur[on_free]);
          const double release = __dadd_rn(cv, cur[0]);
          v = stay_on <= release ? stay_on : release;
        } else if (s <= D) {
          v = __dadd_rn(cv, cur[s == 1 ? on_fresh : s - 1]);
        } else {
          v = __dadd_rn(cc, cur[s == on0 ? on_free : s - 1]);
        }
        nxt[s] = v;
      }
      __syncthreads();
      double* swap = cur;
      cur = nxt;
      nxt = swap;
    }
  }
  __syncthreads();   // T == 0: the zeros written above
  if (tid == 0) {
    const double off = cur[0];
    const double on = cur[on_free];
    const bool take_on = allow_head_start && on < off;
    total[row] = take_on ? on : off;
    start_on[row] = take_on ? 1 : 0;
  }
}

}  // namespace

// vpn, cci (N, T) float64; D, T_cci (N,) int32 with D >= 0, T_cci >= 1;
// order (N,) int32, a permutation of the rows: the first n_large take the
// large-row form, the rest the register form; regs (N,) int32, K1 * 4 + K2
// of each register-form row (launch_plan's); S_max >= D + T_cci + 2 of every
// large-form row; total (N,) float64; start_on (N,) bytes (a torch.bool
// tensor). Launches each form that has rows on `stream` (the large-row form
// first), does not synchronise.
extern "C" int oracle_dp_f64(const double* vpn, const double* cci, const int* D,
                             const int* T_cci, const int* order, const int* regs, int N, int T,
                             int n_large, int S_max, int warps, int allow_head_start,
                             double* total, unsigned char* start_on, void* stream) {
  if (N < 0 || T < 0 || n_large < 0 || n_large > N) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_large > 0) {
    if (S_max < 3) return (int)cudaErrorInvalidValue;
    int threads = ((S_max + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    const size_t bytes = (2 * (size_t)S_max + 2 * (size_t)threads) * sizeof(double);
    if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          oracle_dp_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (e != cudaSuccess) return (int)e;
    }
    oracle_dp_block_kernel<<<n_large, threads, bytes, st>>>(
        vpn, cci, D, T_cci, order, T, S_max, allow_head_start, total, start_on);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int n_rows = N - n_large;
  if (n_rows > 0) {
    if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
    const int bytes = warps * 2 * kSlots * (int)sizeof(double);
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          oracle_dp_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return (int)e;
    }
    oracle_dp_rows_kernel<<<(n_rows + warps - 1) / warps, warps * 32, bytes, st>>>(
        vpn, cci, D, T_cci, order + n_large, regs, n_rows, T, allow_head_start, total,
        start_on);
  }
  return (int)cudaGetLastError();
}
