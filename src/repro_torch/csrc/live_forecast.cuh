// The live forecast of the forecast-gated policy, shared by the streaming
// kernels' live instances (stream_chunk.cu, stream_chunk_routed.cu).
//
// The reference steps its SSM demand forecaster inside the chunk's lax.scan
// (src/repro/fleet/runtime.py:549-562; the step is
// src/repro/models/ssm.py::demand_forecaster_step): an hour's gates read the
// predicted mode costs of the forecast carried into the hour, and after the
// hour's FSM step the forecaster consumes the hour's demand and makes the
// next forecast. In the plain version's order (kernels/ref.py::fsm_chunk_ref):
//   predicted costs  p = exp(c_a + c_b * log1p(pred))   (fleet/policy.py::
//                    predicted_mode_costs), for VPN and CCI
//   input            u = log1pf(float32(d / scale))
//   state            h_s = a_s h_s + (1 - a_s) u          (forecaster_scan.cu's)
//   readout          y = (u + sum_s (h_s - u) w_s) + bias, folded left from s = 0
//   forecast         pred = maximum(expm1(double(y)), 0) * scale
// Every product and sum is an _rn intrinsic and the including sources build
// with -fmad=false. The transcendentals are CUDA's log1p, exp, expm1 and
// log1pf, which gave torch's CUDA ops' bits on the H100 over ~10^6 values
// each (tests/test_torch_cuda.py::test_live_transcendentals_equal_torch).
#pragma once

#include <cuda_runtime.h>

namespace live {

// The forecaster's input for an hour of clipped demand d: a NaN d gives NaN,
// which then stays in the row's state for ever, as in JAX.
__device__ __forceinline__ float ssm_input(double d, double scale) {
  return log1pf(__double2float_rn(__ddiv_rn(d, scale)));
}

// One state's hour: the EMA update, then its readout term (h_s - u) w_s.
__device__ __forceinline__ float ssm_state(float& h, float u, float a, float oma, float w) {
  h = __fadd_rn(__fmul_rn(a, h), __fmul_rn(oma, u));
  return __fmul_rn(__fsub_rn(h, u), w);
}

// The readout from the fold of the states' terms.
__device__ __forceinline__ float ssm_readout(float u, float acc, float bias) {
  return __fadd_rn(__fadd_rn(u, acc), bias);
}

// torch.maximum(expm1(y), 0) * scale: a NaN y stays NaN (fmax would drop it).
__device__ __forceinline__ double prediction(float y, double scale) {
  const double e = expm1((double)y);
  return __dmul_rn(e > 0.0 ? e : isnan(e) ? e : 0.0, scale);
}

// The predicted mode costs of a forecast, from the row's coefficients
// [a_vpn, b_vpn, a_cci, b_cci] (row-major (M, 4)).
__device__ __forceinline__ void mode_costs(double pred, const double* coef, double& p_vpn,
                                           double& p_cci) {
  const double lp = log1p(pred);
  p_vpn = exp(__dadd_rn(coef[0], __dmul_rn(coef[1], lp)));
  p_cci = exp(__dadd_rn(coef[2], __dmul_rn(coef[3], lp)));
}

}  // namespace live
