// One hour of the ToggleCCI FSM, shared by the kernels that run it
// (fsm_scan.cu's fsm_scan and fsm_chunk, stream_chunk.cu, stream_chunk_routed.cu),
// so that all of them decide alike.
//
// The step of src/repro/fleet/policy.py::_fsm_cascade with the hold counters
// of ReactivePolicy.step / HysteresisPolicy.step (hold counts of 1 make the
// hysteresis rule the reactive one): the raw triggers from the hour's window
// sums, then request, provisioning done and release, in that order. The
// forecast gates of ForecastGatedPolicy.step (fsm_gate, fsm_gate_bits,
// fsm_gated_triggers) turn the raw triggers into the gated ones; its cascade
// is this step with hold counts of 1.
#pragma once

#include <cuda_runtime.h>

namespace fsm {

constexpr int kOff = 0;
constexpr int kWaiting = 1;
constexpr int kOn = 2;

// One row's policy parameters.
struct FsmRow {
  double theta1, theta2;
  int D, T_cci, up_hold, down_hold;
  bool renew_in_chunks;
};

// One row's FSM carry: state, hours in state, consecutive trigger hours, and
// t_state % T_cci kept by counting (the renewal check needs no division).
struct FsmCarry {
  int state, t_state, up, down, phase;
};

// The hour's raw triggers from its window sums.
__device__ __forceinline__ void fsm_triggers(const FsmRow& p, double r_vpn, double r_cci,
                                             bool& raw_req, bool& raw_rel) {
  raw_req = r_cci < __dmul_rn(p.theta1, r_vpn);
  raw_rel = r_cci > __dmul_rn(p.theta2, r_vpn);
}

// The forecast gates' thresholds of one row with margin m, formed once:
// theta1 - m, theta1 + m, theta2 + m and theta2 - m, as
// src/repro/fleet/policy.py:290-300 forms them before each product.
struct FsmGate {
  double t1_lo, t1_hi, t2_hi, t2_lo;
};

__device__ __forceinline__ FsmGate fsm_gate(const FsmRow& p, double m) {
  return {__dsub_rn(p.theta1, m), __dadd_rn(p.theta1, m), __dadd_rn(p.theta2, m),
          __dsub_rn(p.theta2, m)};
}

// The four gate bits of an hour from its predicted mode costs: the request
// the forecast makes alone (a_req) and the one it lets a raw trigger make
// (b_req), and the release's two (a_rel, b_rel). They read no window sum.
// `<` and `>` keep NaN out: a NaN prediction makes every comparison false,
// as in JAX.
__device__ __forceinline__ void fsm_gate_bits(const FsmGate& g, double p_vpn, double p_cci,
                                              bool& a_req, bool& b_req, bool& a_rel,
                                              bool& b_rel) {
  a_req = p_cci < __dmul_rn(g.t1_lo, p_vpn);
  b_req = p_cci < __dmul_rn(g.t1_hi, p_vpn);
  a_rel = p_cci > __dmul_rn(g.t2_hi, p_vpn);
  b_rel = p_cci > __dmul_rn(g.t2_lo, p_vpn);
}

// ForecastGatedPolicy.step's request and release from the hour's raw triggers
// and its predicted mode costs: the forecast alone when it is confident, or
// the raw trigger when the forecast does not object.
__device__ __forceinline__ void fsm_gated_triggers(const FsmGate& g, double p_vpn, double p_cci,
                                                   bool& req, bool& rel) {
  bool a_req, b_req, a_rel, b_rel;
  fsm_gate_bits(g, p_vpn, p_cci, a_req, b_req, a_rel, b_rel);
  req = a_req | (req & b_req);
  rel = a_rel | (rel & b_rel);
}

// One hour of the policy step from its raw triggers: the hold counts, then
// the cascade of _fsm_cascade (request, provisioning done, release). Returns
// the state that serves the hour; t_state then counts it. Written as selects,
// with no branch: the lanes of a warp walk rows in different states, and a
// branch would run each state's path in turn.
__device__ __forceinline__ int fsm_step(const FsmRow& p, FsmCarry& c, bool raw_req,
                                        bool raw_rel, bool renew_in_chunks) {
  c.up = raw_req ? c.up + 1 : 0;
  c.down = raw_rel ? c.down + 1 : 0;
  const bool req = raw_req & (c.up >= p.up_hold);
  const bool rel = raw_rel & (c.down >= p.down_hold);

  const bool to_wait = (c.state == kOff) & req;
  c.state = to_wait ? kWaiting : c.state;
  c.t_state = to_wait ? 0 : c.t_state;
  c.phase = to_wait ? 0 : c.phase;
  const bool to_on = (c.state == kWaiting) & (c.t_state >= p.D);
  c.state = to_on ? kOn : c.state;
  c.t_state = to_on ? 0 : c.t_state;
  c.phase = to_on ? 0 : c.phase;
  const bool past_commit = c.t_state >= p.T_cci;
  const bool check = renew_in_chunks ? past_commit & (c.phase == 0) : past_commit;
  const bool to_off = (c.state == kOn) & check & rel;
  c.state = to_off ? kOff : c.state;
  c.t_state = to_off ? 0 : c.t_state;
  c.phase = to_off ? 0 : c.phase;
  const int s = c.state;
  c.t_state += 1;
  c.phase = c.phase + 1 == p.T_cci ? 0 : c.phase + 1;
  return s;
}

// fsm_step with every transition decided from the hour's carry at once, for
// the kernel whose FSM chain sets its pace (stream_chunk.cu). The same states,
// counters and return value as fsm_step when T_cci >= 1 (its callers' carry
// already takes t_state % T_cci): a request that finds the FSM OFF with D <= 0
// is provisioned at once (fsm_step's WAITING -> ON right after it), and a row
// that moved to WAITING or ON this hour cannot be released in it (t_state is
// 0 < T_cci). So a release is decided on the carry's own t_state and phase,
// and the chain through the carry is ~5 dependent operations, not fsm_step's
// ~10. tests/test_torch_chunk_launch.py holds it equal to fsm_step on every
// small carry.
__device__ __forceinline__ int fsm_step_flat(const FsmRow& p, FsmCarry& c, bool raw_req,
                                             bool raw_rel, bool renew_in_chunks) {
  c.up = raw_req ? c.up + 1 : 0;
  c.down = raw_rel ? c.down + 1 : 0;
  const bool req = raw_req & (c.up >= p.up_hold);
  const bool rel = raw_rel & (c.down >= p.down_hold);
  const bool to_wait = (c.state == kOff) & req;
  const bool to_on = ((c.state == kWaiting) & (c.t_state >= p.D)) | (to_wait & (p.D <= 0));
  const bool past_commit = c.t_state >= p.T_cci;
  const bool check = renew_in_chunks ? past_commit & (c.phase == 0) : past_commit;
  const bool to_off = (c.state == kOn) & check & rel;
  const int s = to_off ? kOff : to_on ? kOn : to_wait ? kWaiting : c.state;
  const bool moved = to_wait | to_on | to_off;
  c.state = s;
  c.t_state = moved ? 1 : c.t_state + 1;
  const int phase = moved ? 0 : c.phase;
  c.phase = phase + 1 == p.T_cci ? 0 : phase + 1;
  return s;
}

// One hour: triggers, then the step.
__device__ __forceinline__ int fsm_hour(const FsmRow& p, FsmCarry& c,
                                        double r_vpn, double r_cci) {
  bool raw_req, raw_rel;
  fsm_triggers(p, r_vpn, r_cci, raw_req, raw_rel);
  return fsm_step(p, c, raw_req, raw_rel, p.renew_in_chunks);
}

}  // namespace fsm
