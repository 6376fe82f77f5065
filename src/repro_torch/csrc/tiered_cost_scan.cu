// K-hour chunked tiered VPN pricing with a billing carry.
//
// Replaces: src/repro/kernels/tiered_cost.py::tiered_cost_scan (the Pallas TPU
// kernel _tiered_scan_kernel), and the inline billing-calendar scan plus tier
// fold of the JAX streaming runtime's chunked step
// (src/repro/fleet/runtime.py::_build_step_many, cal_body and the unrolled
// tier loop).
//
// Two carry forms, one entry point each; both price with tier_fold.cuh's
// fold (the tiered_cost_batched arithmetic; the month-to-date kernel's with
// min_sel/max_sel):
//
// * month-to-date (the Pallas kernel's contract): carry the month-to-date
//   volume cum, zero it where reset[k] marks a new month, price at cum:
//     cum = reset[k] ? 0 : cum;  cost = fold(cum, d);  cum = cum + d
//   Rows are row-major (N, K) as the TPU kernel lays them out. float64 and
//   float32.
// * calendar (what the streaming runtime prices with; stream_chunk.cu now
//   runs this form inside the runtime's fused chunk): carry the global prefix
//   dcum and its value at the month start dcum_month, price at their
//   difference, as the offline monthly_cumsum does:
//     if ((t0 + k) % hours_per_month == 0) dcum_month = dcum;
//     cost = fold(dcum - dcum_month, d);  dcum = dcum + d
//   (a+b+c) - a is not b+c in the last bits, and a window sum at a threshold
//   can flip a decision, so the runtime must use this form to stay bit-equal
//   to plan_fleet. Planes are hour-major (K, N), the runtime's layout, so a
//   warp's 32 loads of one hour are contiguous. float64 only. One thread walks
//   one row with the carry in a register; it stays as stream_chunk's same-run
//   yardstick.
//
// What bounds the month-to-date form on an H100: device-memory bytes (demand
// read and cost written, 16 B per row-hour in float64, plus the (N, Kt) tier
// tables once): 2048 x 8760 in one chunk moves 287 MB, 86 us at 3.35 TB/s.
// Its carry is sequential only within a billing month: at every reset the
// carry becomes exactly +0.0, so a chunk is independent (row, month) chains,
// and splitting it at the resets changes no add and no order. Design:
//
// * the segment plan: a one-block pre-pass turns reset (K,) into the
//   segments' starts (segment 0 at hour 0, one more at every k > 0 with
//   reset[k] != 0) and their count, in a scratch the wrapper allocates, on
//   the caller's stream (no host read). A chunk of one segment slot (K <=
//   512, kernels/tiered_cost_scan.py::segment_slots) has no pre-pass: its
//   blocks walk it as one segment, the resets staged with the demand and
//   applied inside the carry, so a streaming-sized chunk is one launch;
// * the main kernel: a fixed grid of (row tile of kScanRows rows) x (slots);
//   block (x, y) prices segments y, y + slots, ... below the count. For a
//   segment it stages its rows' hours in tiles of kScanHours through a ring
//   of kScanRing shared-memory tiles with cp.async (a row's hours are
//   contiguous, so a warp copies 32 consecutive hours of one row; two tiles
//   ahead are in flight), then one warp runs the carry, lane r on row r, one
//   add an hour from shared memory (the row stride is padded to an odd
//   number of words, so the lanes' reads of one hour fall in distinct banks
//   as far as their width allows), and every thread folds (row, hour) pairs
//   against the block's tables staged once, storing the costs coalesced. The
//   block that prices the last segment writes cum_out. A segment starts from
//   +0.0, or segment 0 from cum0 unless reset[0] is set.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_fold.cuh"

namespace {

constexpr int kScanRows = 32;       // rows a block: lane r of warp 0 carries row n0 + r
constexpr int kScanHours = 64;      // hours a staged tile
constexpr int kScanStride = kScanHours + 1;   // a staged row, padded to an odd word count
constexpr int kScanRing = 3;        // staged tiles: the carry's, and two in flight
constexpr int kScanThreads = 256;
constexpr int kPlanThreads = 1024;  // the segment plan's one block, at most
constexpr int kMaxSmem = 227 * 1024;

// plan[0] = S, the segment count; plan[1 + s] = segment s's first hour (s < S);
// plan[1 + S] = K. Each round gives every thread a run of up to 32 hours,
// flags their resets in a mask, and places them by a block-wide prefix sum.
// The block has a warp for every 1024 hours of K, up to 32 warps.
__global__ void __launch_bounds__(kPlanThreads, 1)
tiered_cost_scan_plan_kernel(const int* __restrict__ reset, int K, int* __restrict__ plan) {
  __shared__ int warp_sum[kPlanThreads / 32];
  __shared__ int round_base;
  const int threads = blockDim.x, round = 32 * threads;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = threads / 32;
  if (tid == 0) {
    plan[1] = 0;
    round_base = 1;                     // segments placed so far
  }
  for (int r0 = 0; r0 < K; r0 += round) {
    const int per = (min(round, K - r0) + threads - 1) / threads;
    const int a = r0 + tid * per, b = min(K, a + per);
    unsigned mask = 0;
#pragma unroll 8
    for (int k = a; k < b; ++k) mask |= (unsigned)(k > 0 && reset[k] != 0) << (k - a);
    const int c = __popc(mask);
    int incl = c;                       // inclusive scan over the warp, then the warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = lane < warps ? warp_sum[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += v;
      }
      if (lane < warps) warp_sum[lane] = w;   // inclusive over the warps
    }
    __syncthreads();
    int pos = round_base + incl - c + (warp > 0 ? warp_sum[warp - 1] : 0);
    for (unsigned m = mask; m != 0; m &= m - 1) plan[1 + pos++] = a + __ffs(m) - 1;
    __syncthreads();                    // every thread has read round_base
    if (tid == threads - 1) round_base = pos;
    __syncthreads();
  }
  if (tid == 0) {
    const int S = K > 0 ? round_base : 1;
    plan[0] = S;
    plan[1 + S] = K;
  }
}

__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

template <typename F>
__global__ void __launch_bounds__(kScanThreads, 3)
tiered_cost_scan_mtd_kernel(const F* __restrict__ cum0,      // (N,)
                            const F* __restrict__ demand,    // (N, K)
                            const F* __restrict__ bounds,    // (N, Kt)
                            const F* __restrict__ rates,     // (N, Kt)
                            const int* __restrict__ reset,   // (K,)
                            const int* __restrict__ plan,    // the segment plan, or null
                            int N, int K, int Kt,
                            F* __restrict__ costs,           // (N, K)
                            F* __restrict__ cum_out) {       // (N,)
  extern __shared__ __align__(16) unsigned char smem[];
  F* ring = reinterpret_cast<F*>(smem);                      // [kScanRing][kScanRows][kScanStride]
  F* lo = ring + kScanRing * kScanRows * kScanStride;        // [kScanRows][kScanStride]
  F* tb = lo + kScanRows * kScanStride;                      // [kScanRows][Kt] bounds, then rates
  F* tr = tb + kScanRows * Kt;
  int* rs = reinterpret_cast<int*>(tr + kScanRows * Kt);     // [kScanRing][kScanHours] resets
  // With no plan (one segment slot) the block walks the whole chunk as one
  // segment and applies the resets inside the carry, staged with the demand.
  const bool inline_resets = plan == nullptr;
  // the count, this block's first segment, its rows' carry and reset[0]:
  // loads in flight together (plan has at least gridDim.y + 2 entries)
  const int S = inline_resets ? 1 : plan[0];
  int a = inline_resets ? 0 : plan[1 + blockIdx.y], b = inline_resets ? K : plan[2 + blockIdx.y];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kScanRows;
  const int rows = min(kScanRows, N - n0);
  const F c0 = warp == 0 && lane < rows ? cum0[n0 + lane] : F(0);
  const bool reset0 = K > 0 && reset[0] != 0;
  if ((int)blockIdx.y >= S) return;
  for (int o = tid; o < rows * Kt; o += kScanThreads) {
    tb[o] = bounds[(int64_t)n0 * Kt + o];
    tr[o] = rates[(int64_t)n0 * Kt + o];
  }
  const F* src = demand + (int64_t)n0 * K;
  F* dst = costs + (int64_t)n0 * K;

  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    if (s != (int)blockIdx.y) {
      a = plan[1 + s];
      b = plan[2 + s];
    }
    const int len = b - a;
    const int tiles = (len + kScanHours - 1) / kScanHours;
    // tile t of the segment into ring slot t % kScanRing, a warp a row's 32 hours
    auto stage = [&](int t) {
      F* slot = ring + (t % kScanRing) * kScanRows * kScanStride;
      for (int i = tid; i < rows * kScanHours; i += kScanThreads) {
        const int r = i / kScanHours, k = t * kScanHours + i % kScanHours;
        if (k < len) cp_async(slot + r * kScanStride + k % kScanHours,
                              src + (int64_t)r * K + a + k);
      }
      if (inline_resets && tid < kScanHours && t * kScanHours + tid < len)
        cp_async(rs + (t % kScanRing) * kScanHours + tid, reset + a + t * kScanHours + tid);
      cp_async_commit();
    };
    F cum = inline_resets || (s == 0 && !reset0) ? c0 : F(0);
    stage(0);
    stage(1);
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait<1>();               // tile t has landed (t + 1 may be in flight)
      __syncthreads();                  // ... for every thread; tile t - 1 is folded
      stage(t + 2);                     // into the slot tile t - 1 held
      const F* d = ring + (t % kScanRing) * kScanRows * kScanStride;
      const int hours = min(kScanHours, len - t * kScanHours);
      if (warp == 0 && lane < rows) {   // the carry, one add an hour
        const F* dr = d + lane * kScanStride;
        F* lr = lo + lane * kScanStride;
        if (inline_resets) {
          const int* rt = rs + (t % kScanRing) * kScanHours;
#pragma unroll 8
          for (int k = 0; k < hours; ++k) {
            cum = rt[k] != 0 ? F(0) : cum;
            lr[k] = cum;
            cum = tier::add_rn(cum, dr[k]);
          }
        } else {
#pragma unroll 8
          for (int k = 0; k < hours; ++k) {
            lr[k] = cum;
            cum = tier::add_rn(cum, dr[k]);
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < rows * kScanHours; i += kScanThreads) {
        const int r = i / kScanHours, k = i % kScanHours;
        if (k < hours) {
          const F* rb = tb + r * Kt;
          const F* rr = tr + r * Kt;
          dst[(int64_t)r * K + a + t * kScanHours + k] = tier::fold_with_sel(
              lo[r * kScanStride + k], d[r * kScanStride + k], [rb](int j) { return rb[j]; },
              [rr](int j) { return rr[j]; }, Kt);
        }
      }
    }
    if (s == S - 1 && warp == 0 && lane < rows) cum_out[n0 + lane] = cum;
    cp_async_wait<0>();
    __syncthreads();                    // the ring and lo are free for the next segment
  }
}

template <typename F>
int launch_mtd(const F* cum0, const F* demand, const F* bounds, const F* rates,
               const int* reset, int N, int K, int Kt, int slots, int* plan, F* costs,
               F* cum_out, cudaStream_t stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || K < 0 || Kt < 0 || slots < 1 || slots > max(K, 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(F) * ((size_t)(kScanRing + 1) * kScanRows * kScanStride +
                                   2 * (size_t)kScanRows * Kt) +
                      sizeof(int) * kScanRing * kScanHours;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tiered_cost_scan_mtd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (slots > 1) {   // one slot: no plan, the resets inside the carry
    const int warps = min(kPlanThreads / 32, max(1, (K + 1023) / 1024));
    tiered_cost_scan_plan_kernel<<<1, 32 * warps, 0, stream>>>(reset, K, plan);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kScanRows - 1) / kScanRows, slots);
  tiered_cost_scan_mtd_kernel<F><<<grid, kScanThreads, smem, stream>>>(
      cum0, demand, bounds, rates, reset, slots > 1 ? plan : nullptr, N, K, Kt, costs, cum_out);
  return (int)cudaGetLastError();
}

// The calendar form: the one-thread-a-row kernel of both forms before the
// month-to-date form had a kernel of its own, unchanged as stream_chunk's
// same-run yardstick; only its calendar instance is built.
template <typename F, bool kCalendar>
__global__ void tiered_cost_scan_kernel(const F* __restrict__ cum0,    // (N,) cum | dcum
                                        const F* __restrict__ month0,  // (N,) dcum_month (calendar)
                                        const F* __restrict__ demand,
                                        const F* __restrict__ bounds,  // (N, Kt)
                                        const F* __restrict__ rates,   // (N, Kt)
                                        const int* __restrict__ reset, // (K,) (month-to-date)
                                        int phase0, int hours_per_month,
                                        int N, int K, int Kt,
                                        F* __restrict__ costs,
                                        F* __restrict__ cum_out,       // (N,) cum | dcum
                                        F* __restrict__ month_out) {   // (N,) dcum_month
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const F* b = bounds + (int64_t)n * Kt;
  const F* r = rates + (int64_t)n * Kt;
  F cum = cum0[n];
  F month = kCalendar ? month0[n] : F(0);
  int phase = phase0;  // (t0 + k) % hours_per_month
  for (int k = 0; k < K; ++k) {
    const int64_t i = kCalendar ? (int64_t)k * N + n : (int64_t)n * K + k;
    F lo;
    if (kCalendar) {
      if (phase == 0) month = cum;
      lo = tier::sub_rn(cum, month);
      phase = phase + 1 == hours_per_month ? 0 : phase + 1;
    } else {
      if (reset[k] != 0) cum = F(0);
      lo = cum;
    }
    const F d = demand[i];
    costs[i] = tier::fold(lo, d, b, r, Kt);
    cum = tier::add_rn(cum, d);
  }
  cum_out[n] = cum;
  if (kCalendar) month_out[n] = month;
}

template <typename F, bool kCalendar>
int launch(const F* cum0, const F* month0, const F* demand, const F* bounds,
           const F* rates, const int* reset, int phase0, int hours_per_month,
           int N, int K, int Kt, F* costs, F* cum_out, F* month_out,
           cudaStream_t stream) {
  if (N == 0) return (int)cudaSuccess;
  const int threads = 32;
  const int blocks = (N + threads - 1) / threads;
  tiered_cost_scan_kernel<F, kCalendar><<<blocks, threads, 0, stream>>>(
      cum0, month0, demand, bounds, rates, reset, phase0, hours_per_month,
      N, K, Kt, costs, cum_out, month_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Month-to-date form: demand/costs (N, K) row-major, reset (K,) int32; plan a
// scratch of max(K, 1) + 2 int32 (the segment plan) and slots (<= max(K, 1))
// the grid's segment slots, both from the wrapper
// (kernels/tiered_cost_scan.py::segment_slots).
extern "C" int tiered_cost_scan_f64(const double* cum0, const double* demand,
                                    const double* bounds, const double* rates,
                                    const int* reset, int N, int K, int Kt, int slots,
                                    int* plan, double* costs, double* cum_out, void* stream) {
  return launch_mtd<double>(cum0, demand, bounds, rates, reset, N, K, Kt, slots, plan, costs,
                            cum_out, (cudaStream_t)stream);
}

extern "C" int tiered_cost_scan_f32(const float* cum0, const float* demand,
                                    const float* bounds, const float* rates,
                                    const int* reset, int N, int K, int Kt, int slots,
                                    int* plan, float* costs, float* cum_out, void* stream) {
  return launch_mtd<float>(cum0, demand, bounds, rates, reset, N, K, Kt, slots, plan, costs,
                           cum_out, (cudaStream_t)stream);
}

// Calendar form: demand/costs (K, N) hour-major; carry (2, N) = dcum, dcum_month
// in and out; phase0 = t0 % hours_per_month.
extern "C" int tiered_cost_calendar_f64(const double* carry_in, const double* demand,
                                        const double* bounds, const double* rates,
                                        int phase0, int hours_per_month,
                                        int N, int K, int Kt, double* costs,
                                        double* carry_out, void* stream) {
  return launch<double, true>(carry_in, carry_in + N, demand, bounds, rates, nullptr,
                              phase0, hours_per_month, N, K, Kt, costs, carry_out,
                              carry_out + N, (cudaStream_t)stream);
}
