"""Device-dispatching wrappers for every kernel of the port.

Dispatch rule (port of :mod:`repro.kernels.ops`):

* a CUDA tensor  -> the hand-written CUDA kernel, or an error (a failed
  build or launch raises; nothing falls back);
* a CPU tensor   -> the kernel's plain PyTorch version in
  :mod:`repro_torch.kernels.ref`;
* anything else  -> an error.

:data:`LAUNCHES` counts kernel launches by name; each kernel wrapper adds
one where it launches and nowhere else.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import ref
from .flash_attention import flash_attention as _flash_kernel
from .forecaster import checkpoint_shape
from .forecaster import forecaster_scan as _forecaster_kernel
from .forecaster import forecaster_scan_bwd as _forecaster_bwd_kernel
from .fsm_scan import fsm_chunk as _fsm_chunk_kernel
from .fsm_scan import fsm_scan as _fsm_scan_kernel
from .int8_quant import int8_dequantize as _dequant_kernel
from .int8_quant import int8_quantize as _quant_kernel
from .leg_segment_sum import leg_segment_sum as _leg_kernel
from .leg_segment_sum import port_major
from .moe import MoERouting
from .moe import moe_combine as _moe_combine_kernel
from .moe import moe_dispatch as _moe_dispatch_kernel
from .moe import moe_route as _moe_route_kernel
from .oracle_dp import oracle_dp as _oracle_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .stream_chunk import stream_chunk as _stream_chunk_kernel
from .stream_chunk import stream_chunk_routed as _stream_chunk_routed_kernel
from .tiered_cost import tiered_cost as _tiered_static_kernel
from .tiered_cost import tiered_cost_batched as _tiered_kernel
from .tiered_cost_scan import tiered_cost_calendar as _calendar_kernel
from .tiered_cost_scan import tiered_cost_scan as _scan_kernel
from ._lib import LAUNCHES, reset_launches  # noqa: F401


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def tiered_cost_batched(month_cum, demand, bounds, rates) -> torch.Tensor:
    """(N, T) tiered VPN transfer cost; float64 or float32 like the inputs."""
    if _route(month_cum, "tiered_cost_batched"):
        return _tiered_kernel(*(a.contiguous() for a in (month_cum, demand, bounds, rates)))
    return ref.tiered_cost_batched_ref(month_cum, demand, bounds, rates)


def fsm_scan(vpn, cci, theta1, theta2, h, D, T_cci, up_hold, down_hold,
             *, renew_in_chunks: bool = False, gate=None) -> Dict[str, torch.Tensor]:
    """ToggleCCI over (N, T) cost planes: ``x``, ``state``, ``total_cost``.
    ``gate=(pred, coef, margin)`` runs the forecast-gated policy on the (N, T)
    predicted demand, the (N, 4) cost coefficients and (N,) margins (hold
    counts must be 1)."""
    args = (vpn, cci, theta1, theta2, h, D, T_cci, up_hold, down_hold)
    if _route(vpn, "fsm_scan"):
        return _fsm_scan_kernel(*(a.contiguous() for a in args), renew_in_chunks=renew_in_chunks,
                                gate=None if gate is None else tuple(g.contiguous() for g in gate))
    return ref.fsm_scan_ref(*args, renew_in_chunks=renew_in_chunks, gate=gate)


def forecaster_scan(u, a, one_minus_a, w, bias, h0=None, *, write_y: bool = True, ckpt=None
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The demand forecaster's EMA bank and readout over (N, T) float32
    inputs from ``h0`` (zeros if None): ``(y (N, T) or None, h (N, S))``.
    ``ckpt`` (from :func:`forecaster_checkpoints`), when given, receives the
    state at the start of every tile, for :func:`forecaster_scan_bwd`."""
    if _route(u, "forecaster_scan"):
        c = lambda t: None if t is None else t.contiguous()
        return _forecaster_kernel(c(u), c(a), c(one_minus_a), c(w), c(bias), c(h0),
                                  write_y=write_y, ckpt=ckpt)
    return ref.forecaster_scan_ref(u, a, one_minus_a, w, bias, h0, write_y=write_y, ckpt=ckpt)


def forecaster_checkpoints(u: torch.Tensor, S: int) -> torch.Tensor:
    """An empty checkpoint output for :func:`forecaster_scan` over ``u``
    (N, T) with S states, on ``u``'s device."""
    return torch.empty(checkpoint_shape(*u.shape, S), dtype=torch.float32, device=u.device)


def forecaster_scan_bwd(u, dy, a, one_minus_a, w, h0=None, *, ckpt=None):
    """The forecaster's backward pass over (N, T) float32 ``u`` and ``dy``:
    ``(da, d_one_minus_a, dw, dbias)``, each sum over rows and hours walked
    in one fixed order (hours backwards, then rows in index order). ``ckpt``:
    the checkpoints of the forward scan that ``dy`` belongs to, in place of
    its ``h0``."""
    if _route(u, "forecaster_scan_bwd"):
        c = lambda t: None if t is None else t.contiguous()
        return _forecaster_bwd_kernel(c(u), c(dy), c(a), c(one_minus_a), c(w), c(h0),
                                      ckpt=ckpt)
    return ref.forecaster_scan_bwd_ref(u, dy, a, one_minus_a, w, h0, ckpt=ckpt)


def tiered_cost_scan(cum0, demand, bounds, rates, reset):
    """K-hour chunk pricing with a month-to-date carry (the TPU kernel's
    contract): ``(costs (N, K), cum_out (N,))``, float64 or float32."""
    args = (cum0, demand, bounds, rates, reset)
    if _route(demand, "tiered_cost_scan"):
        return _scan_kernel(*(a.contiguous() for a in args))
    return ref.tiered_cost_scan_ref(*args)


def tiered_cost_calendar(carry, demand, bounds, rates, t0: int, hours_per_month: int):
    """K-hour chunk pricing on the billing calendar (hour-major (K, N)
    demand, carry (2, N) = dcum, dcum_month): ``(costs (K, N), carry)``."""
    args = (carry, demand, bounds, rates)
    if _route(demand, "tiered_cost_calendar"):
        return _calendar_kernel(*(a.contiguous() for a in args), t0, hours_per_month)
    return ref.tiered_cost_calendar_ref(*args, t0, hours_per_month)


def fsm_chunk(vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold, down_hold,
              carry, pref, t0: int, *, renew_in_chunks: bool = False
              ) -> Dict[str, torch.Tensor]:
    """K hours of the ToggleCCI FSM from a carry, on hour-major (K, M) planes."""
    args = (vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold, down_hold,
            carry, pref)
    if _route(vpn, "fsm_chunk"):
        return _fsm_chunk_kernel(*(a.contiguous() for a in args), t0,
                                 renew_in_chunks=renew_in_chunks)
    return ref.fsm_chunk_ref(*args, t0, renew_in_chunks=renew_in_chunks)


def _contiguous_gate(gate):
    return None if gate is None else (*(g.contiguous() for g in gate[:3]), int(gate[3]))


def _contiguous_live(live):
    return None if live is None else tuple(t.contiguous() for t in live)


def stream_chunk(block, K: int, endo: bool, capacity, L_vpn, lease_cci, c_cci, bounds,
                 rates, theta1, theta2, h, D, T_cci, up_hold, down_hold, cal, fsm, pref,
                 t0=None, hours_per_month=None, *, renew_in_chunks: bool = False, gate=None,
                 live=None, clocks=None) -> Tuple[torch.Tensor, ...]:
    """The streaming runtime's whole chunk from its packed block: ``(packed
    (8K + 4, M) float64, FSM carry (4, M) int32)``. ``gate=(p_vpn, p_cci,
    margin, T_pred)`` runs the forecast-gated policy on the hour-major
    (T_pred, M) predicted mode costs, read at hour ``min(t0 + k, T_pred − 1)``,
    with (M,) margins (hold counts must be 1). ``live=(h, pred, a,
    one_minus_a, w, bias, scale, cost_coef, margin)`` runs it in live mode,
    the forecast stepped inside the chunk: the result is then (9K + 4, M) and
    the forecaster's state after the chunk comes third. ``clocks=(t0,
    hours_per_month)``, (M,) int32 tensors in place of the ints, runs the
    pooled instance, one clock per row
    (:func:`repro_torch.kernels.stream_chunk.chunk_clocks`)."""
    args = (capacity, L_vpn, lease_cci, c_cci, bounds, rates, theta1, theta2, h, D, T_cci,
            up_hold, down_hold, cal, fsm, pref)
    if _route(block, "stream_chunk"):
        return _stream_chunk_kernel(block.contiguous(), K, endo,
                                    *(a.contiguous() for a in args), t0, hours_per_month,
                                    renew_in_chunks=renew_in_chunks,
                                    gate=_contiguous_gate(gate), live=_contiguous_live(live),
                                    clocks=clocks)
    return ref.stream_chunk_ref(block, K, endo, *args, t0, hours_per_month,
                                renew_in_chunks=renew_in_chunks, gate=gate, live=live,
                                clocks=clocks)


def stream_chunk_routed(block, K: int, endo: bool, pair_capacity, L_vpn, bounds, rates,
                        lease_cci, c_cci, port_capacity, theta1, theta2, h, D, T_cci,
                        up_hold, down_hold, routing, cal, fsm, pref, t0=None,
                        hours_per_month=None, *, renew_in_chunks: bool = False, gate=None,
                        live=None, clocks=None) -> Tuple[torch.Tensor, ...]:
    """The streaming runtime's whole chunk in topology mode from its packed
    block: ``(flat float64 result (8K·M + 2P + 2M), FSM carry (4, M) int32)``.
    ``routing`` is a :class:`~repro_torch.fleet.routing.RoutingOperand`; the
    kernel walks its port-major index, the plain version its legs in order.
    ``gate`` and ``live`` are :func:`stream_chunk`'s, per port;
    ``clocks=(t0_port (M,), hours_per_month (P,), t0_pair (P,))`` int32
    runs the pooled instance."""
    args = (pair_capacity, L_vpn, bounds, rates, lease_cci, c_cci, port_capacity, theta1,
            theta2, h, D, T_cci, up_hold, down_hold)
    carries = (cal, fsm, pref)
    if _route(block, "stream_chunk_routed"):
        return _stream_chunk_routed_kernel(
            block.contiguous(), K, endo, *(a.contiguous() for a in args), routing,
            *(a.contiguous() for a in carries), t0, hours_per_month,
            renew_in_chunks=renew_in_chunks, gate=_contiguous_gate(gate),
            live=_contiguous_live(live), clocks=clocks)
    return ref.stream_chunk_routed_ref(block, K, endo, *args, routing, *carries, t0,
                                       hours_per_month, renew_in_chunks=renew_in_chunks,
                                       gate=gate, live=live, clocks=clocks)


def leg_segment_sum(src, leg_pair, leg_port, w, num_segments: int, *, index=None):
    """Fold rows of ``src`` (P, T) onto ``num_segments`` segments over a leg
    list, each segment's legs summed in ascending leg index from +0.0:
    ``out[m] = sum_{e: leg_port[e] == m} src[leg_pair[e]] * w[e]``, float64.

    ``src`` and ``w`` may each be a tuple of two (planes folded over the same
    legs; one launch on CUDA), and the result is then a tuple too. ``index``
    is the ``(order, start)`` port-major index of the legs
    (:func:`~repro_torch.kernels.leg_segment_sum.port_major`); on CUDA it is
    built on the host when not given. The plain version needs none.
    """
    many = isinstance(src, (tuple, list))
    srcs, ws = (tuple(src), tuple(w)) if many else ((src,), (w,))
    if _route(srcs[0], "leg_segment_sum"):
        if index is None:
            order, start = port_major(leg_port.cpu().numpy(), num_segments)
            dev = srcs[0].device
            index = (torch.from_numpy(order).to(dev), torch.from_numpy(start).to(dev))
        order, start = index
        if start.shape[0] != num_segments + 1:
            raise ValueError(f"index holds {start.shape[0] - 1} segments, not {num_segments}")
        outs = _leg_kernel([s.contiguous() for s in srcs], [x.contiguous() for x in ws],
                           leg_pair.contiguous(), order.contiguous(), start.contiguous())
    else:
        outs = tuple(ref.leg_segment_sum_ref(s, leg_pair, leg_port, x, num_segments)
                     for s, x in zip(srcs, ws))
    return outs if many else outs[0]


def oracle_dp(vpn, cci, D, T_cci, *, allow_head_start: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every row's offline-optimal DP over (N, T) float64 cost planes with
    per-row ``D`` and ``T_cci`` (int32): ``(total (N,) float64, start_on
    (N,) bool)``, each bit-equal to
    :func:`repro_torch.core.oracle.offline_optimal` on the row."""
    if _route(vpn, "oracle_dp"):
        return _oracle_kernel(*(a.contiguous() for a in (vpn, cci, D, T_cci)),
                              allow_head_start=allow_head_start)
    return ref.oracle_dp_ref(vpn, cci, D, T_cci, allow_head_start=allow_head_start)


def attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Attention over q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv)
    with GQA, causal/sliding-window masks and ``q_offset``: the flash kernel
    on CUDA for any Sq and Skv (the reference's padding and its small-Sq
    threshold are not needed), the plain version on the CPU."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if _route(q, "attention"):
        return _flash_kernel(q, k, v, **kw)
    return ref.attention(q, k, v, **kw)


def rmsnorm(x, w, *, eps: float = 1e-6) -> torch.Tensor:
    """Row-wise RMSNorm of x (..., d) with weight w (d,), float32 math."""
    if _route(x, "rmsnorm"):
        return _rmsnorm_kernel(x.contiguous(), w.contiguous(), eps=eps)
    return ref.rmsnorm(x, w, eps=eps)


def int8_quantize(x: torch.Tensor, *, guard: str = "pallas"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of x (N, d), float32 or bfloat16: ``(q int8
    (N, d), scale float32 (N, 1))``, any N and d. ``guard`` picks the
    scale: ``"pallas"`` (the TPU kernel's) or ``"collectives"`` (the JAX
    gradient sync's)."""
    if _route(x, "int8_quantize"):
        return _quant_kernel(x.contiguous(), guard=guard)
    return ref.int8_quantize(x, guard=guard)


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q · scale`` of int8 q (N, d) and float32 scale (N, 1), as ``dtype``."""
    if _route(q, "int8_dequantize"):
        return _dequant_kernel(q.contiguous(), scale.contiguous(), dtype)
    return ref.int8_dequantize(q, scale, dtype)


def tiered_cost(month_cum: torch.Tensor, demand: torch.Tensor,
                bounds: Sequence[float], rates: Sequence[float]) -> torch.Tensor:
    """(T, P) float32 tiered cost against one static tier table given as
    Python sequences (an infinite bound becomes ``1e30``; at most 8 tiers)."""
    if _route(month_cum, "tiered_cost"):
        f32 = lambda a: a.to(torch.float32).contiguous()
        return _tiered_static_kernel(f32(month_cum), f32(demand), bounds, rates)
    return ref.tiered_cost(month_cum, demand, bounds, rates)


def moe_route(logits: torch.Tensor, top_k: int, capacity: int, *, router: str = "softmax",
              aux_coef: float = 0.0) -> MoERouting:
    """Route (G, N, E) float32 router logits of G token groups: the scores
    (softmax or sigmoid), the top-k experts and their normalised weights,
    each slot's position inside its expert, which slots fit ``capacity``,
    the (G, E, C) capacity map and the per-group aux loss
    (:class:`~repro_torch.kernels.moe.MoERouting`)."""
    kw = dict(router=router, aux_coef=aux_coef)
    if _route(logits, "moe_route"):
        return _moe_route_kernel(logits.contiguous(), top_k, capacity, **kw)
    return ref.moe_route_ref(logits, top_k, capacity, **kw)


def moe_dispatch(x: torch.Tensor, src: torch.Tensor, top_k: int) -> torch.Tensor:
    """The (E, G, C, d) expert buffer of x (G, N, d) by the capacity map
    ``src``: row (e, g, c) is ``x[g, src // top_k]``, or zeros."""
    if _route(x, "moe_dispatch"):
        return _moe_dispatch_kernel(x.contiguous(), src.contiguous(), top_k)
    return ref.moe_dispatch_ref(x, src, top_k)


def moe_combine(out: torch.Tensor, gate_idx: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """y (G, N, d) from the experts' out (E, G, C, d): each token's k rows
    weighted by ``gate_w · keep``, summed in choice order."""
    args = (out, gate_idx, pos, keep, gate_w)
    if _route(out, "moe_combine"):
        return _moe_combine_kernel(*(a.contiguous() for a in args))
    return ref.moe_combine_ref(*args)
