// The grid of a kernel that strides over its work: how many of its blocks one
// card holds at once (shared by int8_quant.cu and tiered_cost.cu).
#pragma once

#include <cuda_runtime.h>

// Blocks of `threads` that fit the card at once for `kernel` (1024 if the
// runtime cannot say). A caller asks once per kernel and keeps the answer; a
// grid that strides over its work is correct at any count.
template <typename Kernel>
long long full_grid(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0) != cudaSuccess)
    return 1024LL;
  return (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}
