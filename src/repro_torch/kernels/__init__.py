"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Per-kernel contract (the three layers of :mod:`repro.kernels`):
  ../csrc/<name>.cu  the CUDA C++ kernel for sm_90a, with a plain C entry
  <name>.py          its wrapper: checks, allocates, launches, counts
  ref.py             the plain PyTorch version of every kernel
  ops.py             the dispatcher: CUDA tensors to the kernel, CPU tensors
                     to the plain version

Kernels: ``tiered_cost_batched`` (the paper's Eq. 2 pricing over an (N, T)
plane; replaces the Pallas kernel of the same name), ``fsm_scan`` (the
ToggleCCI scan over rows, reactive, hysteresis or forecast-gated; replaces
``lax.scan`` in ``policy_scan``), ``forecaster_scan`` (the demand
forecaster's EMA bank and readout; replaces the ``lax.scan`` of
``demand_forecaster_apply`` and ``_state``), ``forecaster_scan_bwd`` (its
backward pass for training; replaces XLA autodiff of that scan),
``tiered_cost_scan`` (K-hour chunk pricing with a billing carry, entry
points ``tiered_cost_scan`` and ``tiered_cost_calendar``; replaces the
Pallas kernel of that name), ``fsm_chunk`` (K hours of the FSM from a
carry; replaces the ``lax.scan`` of the streaming runtime's chunk) and
``stream_chunk`` (the streaming runtime's whole chunk, the calendar pricing
and the FSM of the last two fused into one launch; the runtime runs it,
reactive, hysteresis or forecast-gated), and
for the LM's serving path ``flash_attention`` (blocked online-softmax
attention) and ``rmsnorm``, and for the actuation path ``int8_quantize`` /
``int8_dequantize`` (per-row int8 of the compressed gradient sync) and
``tiered_cost`` (one static tier table over a (T, P) plane), each replacing
the Pallas kernel of that name, and for the topology planner
``leg_segment_sum`` (demand rows folded onto ports over the routing's leg
list, each port's legs in order; replaces ``jax.ops.segment_sum`` in the
route stage, whose XLA scatter adds in update order where CUDA's
``index_add_`` adds with atomics), and for the MoE layer ``moe_route``,
``moe_dispatch`` and ``moe_combine`` (the router's top-k, the in-order slot
positions and the capacity map; the gather into the (E, G, C, d) expert
buffer; the weighted combine; they replace the reference's XLA dispatch in
``_dispatch_group``).
"""
from . import ops, ref  # noqa: F401
