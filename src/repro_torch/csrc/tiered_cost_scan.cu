// K-hour chunked tiered VPN pricing with the billing carry in a register.
//
// Replaces: src/repro/kernels/tiered_cost.py::tiered_cost_scan (the Pallas TPU
// kernel _tiered_scan_kernel), and the inline billing-calendar scan plus tier
// fold of the JAX streaming runtime's chunked step
// (src/repro/fleet/runtime.py::_build_step_many, cal_body and the unrolled
// tier loop).
//
// One kernel template, two carry forms, one entry point each:
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
//   warp's 32 loads of one hour are contiguous. float64 only.
//
// Both forms share tier::fold (tier_fold.cuh), the tiered_cost_batched fold.
//
// What bounds it on an H100: in principle device-memory bytes (demand read and
// cost written, 16 B per link-hour in float64, plus the (N, Kt) tier tables
// once): 2048 x 8760 in one chunk moves 287 MB, 86 us at 3.35 TB/s. At the
// runtime's chunks (K = 24, N = 2048: 0.8 MB) the bytes take 0.3 us, but this
// design takes ~50x that on the device: one thread per row walks its K hours
// in order with the carry in a register (so the carried sums are sequential
// and exact), 32 threads a block, 64 one-warp blocks at 2048 rows, and each
// hour's demand load waits a device-memory round trip with nothing to hide
// it. The streaming runtime now prices its chunks inside stream_chunk.cu; the
// calendar entry stays as that kernel's same-run yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_fold.cuh"

namespace {

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

// Month-to-date form: demand/costs (N, K) row-major, reset (K,) int32.
extern "C" int tiered_cost_scan_f64(const double* cum0, const double* demand,
                                    const double* bounds, const double* rates,
                                    const int* reset, int N, int K, int Kt,
                                    double* costs, double* cum_out, void* stream) {
  return launch<double, false>(cum0, nullptr, demand, bounds, rates, reset, 0, 1,
                               N, K, Kt, costs, cum_out, nullptr,
                               (cudaStream_t)stream);
}

extern "C" int tiered_cost_scan_f32(const float* cum0, const float* demand,
                                    const float* bounds, const float* rates,
                                    const int* reset, int N, int K, int Kt,
                                    float* costs, float* cum_out, void* stream) {
  return launch<float, false>(cum0, nullptr, demand, bounds, rates, reset, 0, 1,
                              N, K, Kt, costs, cum_out, nullptr,
                              (cudaStream_t)stream);
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
