// Offline-optimal cost-to-go of every row of a fleet or a topology, one launch.
//
// Replaces: the numpy dynamic program of src/repro/core/oracle.py:64
// (offline_optimal's backward pass), which the reference's fleet_oracle
// (src/repro/fleet/engine.py:614) and topology_oracle (:589) run row by row
// in Python, a dozen numpy calls an hour. For every row the kernel runs that
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
// equals), and whether it started ON. Each add is __dadd_rn (and the source
// builds with -fmad=false), so every value equals numpy's scalar and slice
// adds bit for bit. The comparisons are the reference's: false on NaN, so a
// NaN keeps `stay` at OFF and `release` at ON free, as in numpy; no
// fmin/fmax, which would drop the NaN. The schedule stays on the host
// (repro_torch.core.oracle.offline_optimal); the reports need the totals.
//
// Layout: one block a row, one thread a state (a thread takes several when
// a row has more states than the block has threads). The state values live
// in shared memory, double-buffered, sized by the batch's largest D + Tc +
// 2, so each hour is one barrier: read the old buffer, write the new one.
// Padding threads and states past a row's own count are never read by a
// real state (every state reads a lower index or on_fresh/on_free, all
// below the row's count). The hour costs are staged backwards in tiles of
// blockDim hours, one coalesced load of each plane a tile, so no hour is a
// dependent load from device memory.
//
// What bounds it on an H100: operations. At 2048 rows x 8760 hours with the
// fleet scenario's ~266 states a row the DP does ~4.8e9 float64 adds and
// compares, 0.14 ms at the card's 34 TFLOP/s float64 peak (which counts an
// FMA as two; adds alone run at half that rate, 0.28 ms); the vpn and cci
// planes, 287 MB, are 0.086 ms at 3.35 TB/s. This first form is bound
// instead by its 8760 dependent barrier rounds a row (a shared load, an add,
// a shared store and a barrier each), with four or so rows resident on an
// SM; fewer barriers a row, several rows a block and the chains kept in
// registers are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB, the most a block can hold

__global__ void oracle_dp_kernel(const double* __restrict__ vpn,   // (N, T)
                                 const double* __restrict__ cci,   // (N, T)
                                 const int* __restrict__ D_,       // (N,)
                                 const int* __restrict__ Tc_,      // (N,)
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
  const int64_t row = blockIdx.x;
  const int D = D_[row];
  const int Tc = Tc_[row];
  const int on0 = D + 1;
  const int on_free = D + Tc + 1;
  const int on_fresh = on0 + Tc - 1;
  const int S = on_free + 1;
  const int req_next = D > 1 ? D - 1 : (D == 1 ? on_fresh : (Tc > 1 ? on0 + Tc - 2 : on_free));
  const double* v_row = vpn + row * T;
  const double* c_row = cci + row * T;

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

// vpn, cci (N, T) float64; D, T_cci (N,) int32 with D >= 0, T_cci >= 1 and
// D + T_cci + 2 <= S_max for every row; total (N,) float64; start_on (N,)
// bytes (a torch.bool tensor). Launches on `stream`, does not synchronise.
extern "C" int oracle_dp_f64(const double* vpn, const double* cci, const int* D,
                             const int* T_cci, int N, int T, int S_max,
                             int allow_head_start, double* total,
                             unsigned char* start_on, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || T < 0 || S_max < 3) return (int)cudaErrorInvalidValue;
  int threads = ((S_max + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t bytes = (2 * (size_t)S_max + 2 * (size_t)threads) * sizeof(double);
  if (bytes > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        oracle_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  oracle_dp_kernel<<<N, threads, bytes, (cudaStream_t)stream>>>(
      vpn, cci, D, T_cci, T, S_max, allow_head_start, total, start_on);
  return (int)cudaGetLastError();
}
