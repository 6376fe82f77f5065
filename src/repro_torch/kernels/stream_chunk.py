"""The streaming runtime's chunk kernel wrappers: K hours of every row in one call.

Port of the chunk step of :class:`repro.fleet.runtime.FleetRuntime`
(``_build_step_many``, one jitted dispatch for K hours). Each takes the
runtime's packed host block on the device (demand, optionally the CCI
demand, and the host's pre-chunk window reads) and the device carries, and
computes the clip, the billing calendar, the tier fold, the VPN and CCI
cost planes, the prefix snapshots, the window sums and the FSM, into one
packed float64 result:

* :func:`stream_chunk`, fleet mode (one row per link): ``csrc/stream_chunk.cu``,
  in one of two launch forms that :func:`launch_form` picks by K: the tick
  form (one thread a row, the K hours in registers) for K up to
  :data:`TICK_MAX_K`, the chunk form (sub-tiles of 8 hours handed between
  warp roles) past it;
* :func:`stream_chunk_routed`, topology mode: pairs are priced, then folded
  onto the shared ports over the routing's leg list, each port's legs in
  leg order, before the port FSMs run: ``csrc/stream_chunk_routed.cu``.

Both take an optional ``gate=(p_vpn, p_cci, margin, T_pred)``: the
forecast-gated policy's hour-major (T_pred, M) predicted mode costs and its
(M,) margins. A gated call launches the kernels' gated instances, which
read the planes at hour ``min(t0 + k, T_pred − 1)`` and gate the raw
triggers as ``ForecastGatedPolicy.step`` does (``csrc/fsm_step.cuh``); it
counts under ``stream_chunk_gated`` / ``stream_chunk_routed_gated`` in
:data:`~repro_torch.kernels._lib.LAUNCHES`, an ungated one under
``stream_chunk`` / ``stream_chunk_routed``.

Their plain PyTorch versions are :func:`repro_torch.kernels.ref.stream_chunk_ref`
and :func:`~repro_torch.kernels.ref.stream_chunk_routed_ref`. These wrappers
take CUDA tensors only; :mod:`repro_torch.kernels.ops` dispatches CPU
tensors to the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib


def block_size(K: int, M: int, endo: bool, P: Optional[int] = None) -> int:
    """Elements of the runtime's packed chunk block: the demand (and the CCI
    demand) (K, P), then the window reads pre_v, pre_c (K, M); P == M in
    fleet mode."""
    return ((2 if endo else 1) * (M if P is None else P) + 2 * M) * K


def routed_result_size(K: int, P: int, M: int) -> int:
    """Elements of the routed chunk's flat result: the 8 (K, M) planes, then
    dcum, dcum_month (P each), then vpn_pref, cci_pref (M each)."""
    return 8 * K * M + 2 * P + 2 * M


#: The largest K the wrapper sends to the tick form, and its last
#: compile-time instance (K = 1..5, ``kTickMaxK`` in ``csrc/stream_chunk.cu``):
#: from K = 6 the chunk form was faster on the card (PERF.md, the K sweep of
#: both forms up to K = 8). Then the tiers its tables hold in registers.
TICK_MAX_K = 5
TICK_MAX_TIERS = 8
#: Hours a chunk-form sub-tile, and sub-tiles a tile (five named barriers
#: each, of the 15 a block has besides ``__syncthreads``).
SUB_HOURS = 8
MAX_SUBS = 3
FORMS = ("auto", "tick", "chunk")


def launch_form(K: int, Kt: int, form: str = "auto") -> int:
    """The C entry's ``form`` code for a chunk of K hours against Kt-tier
    tables: 0 the tick form, S = 1..3 the chunk form with S sub-tiles of
    :data:`SUB_HOURS` hours a tile (``ceil(K / 8)``, at most
    :data:`MAX_SUBS`; a longer chunk walks several tiles). ``"auto"`` takes
    the tick form for K <= :data:`TICK_MAX_K` when the tables fit its
    registers; ``"tick"`` and ``"chunk"`` force one (the tick form raises
    past its instances), for :func:`_stream_chunk_launch`."""
    if form not in FORMS:
        raise ValueError(f"stream_chunk form {form!r}: want one of {FORMS}")
    if K < 1:
        raise ValueError(f"stream_chunk: K {K}")
    fits = K <= TICK_MAX_K and Kt <= TICK_MAX_TIERS
    if form == "tick" and not fits:
        raise ValueError(f"stream_chunk tick form: K {K} (at most {TICK_MAX_K}) or "
                         f"{Kt} tiers (at most {TICK_MAX_TIERS})")
    if form == "tick" or (form == "auto" and fits):
        return 0
    return min(MAX_SUBS, -(-K // SUB_HOURS))


def _gate_operands(name: str, gate, M: int) -> list:
    """``_check_operands``' entries for a chunk's ``gate=(p_vpn, p_cci,
    margin, T_pred)`` (none for None); raises unless ``T_pred`` is the
    planes' hour count and at least 1."""
    if gate is None:
        return []
    p_vpn, p_cci, margin, T_pred = gate
    T_pred = int(T_pred)
    if T_pred < 1 or p_vpn.dim() != 2 or p_vpn.shape[0] != T_pred:
        raise ValueError(f"{name} gate: T_pred {T_pred} against predicted-cost planes "
                         f"{tuple(p_vpn.shape)}; want ({T_pred}, {M}) with T_pred >= 1")
    f64 = torch.float64
    return [(p_vpn, (T_pred, M), f64), (p_cci, (T_pred, M), f64), (margin, (M,), f64)]


def _gate_args(gate) -> tuple:
    """The C entry's gate arguments: the three pointers (null for an
    ungated call) and T_pred (0)."""
    if gate is None:
        return (None, None, None), 0
    return tuple(a.data_ptr() for a in gate[:3]), int(gate[3])


def _check_operands(name: str, block: torch.Tensor, want) -> None:
    """Raise unless every ``(tensor, shape, dtype)`` of ``want`` matches and
    they and ``block`` are contiguous CUDA tensors on one device."""
    for a, shape, dt in want:
        if a.shape != shape or a.dtype != dt:
            raise ValueError(f"{name} operand: want {shape} {dt}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for a in [block] + [w[0] for w in want]:
        if not a.is_cuda or a.device != block.device or not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous CUDA tensors on one device")


def stream_chunk(
    block: torch.Tensor,      # flat float64, block_size(K, M, endo)
    K: int,
    endo: bool,               # the block holds a CCI demand plane
    capacity: torch.Tensor,   # (M,) float64
    L_vpn: torch.Tensor,      # (M,) float64
    lease_cci: torch.Tensor,  # (M,) float64: L_cci + V_cci
    c_cci: torch.Tensor,      # (M,) float64
    bounds: torch.Tensor,     # (M, Kt) float64 padded tier bounds (finite)
    rates: torch.Tensor,      # (M, Kt) float64
    theta1: torch.Tensor,     # (M,) float64
    theta2: torch.Tensor,     # (M,) float64
    h: torch.Tensor,          # (M,) int32 window
    D: torch.Tensor,          # (M,) int32
    T_cci: torch.Tensor,      # (M,) int32
    up_hold: torch.Tensor,    # (M,) int32 >= 1
    down_hold: torch.Tensor,  # (M,) int32 >= 1
    cal: torch.Tensor,        # (2, M) float64: dcum, dcum_month
    fsm: torch.Tensor,        # (4, M) int32: state, t_state, up, down
    pref: torch.Tensor,       # (2, M) float64: vpn_pref, cci_pref
    t0: int,                  # the chunk's first hour
    hours_per_month: int,
    *,
    renew_in_chunks: bool = False,
    gate=None,                # (p_vpn, p_cci (T_pred, M) f64, margin (M,) f64, T_pred)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk on the card: the packed float64 (8K + 4, M) result (vpn, cci,
    r_vpn, r_cci, snap_v, snap_c, x, state, K rows each, then dcum,
    dcum_month, vpn_pref, cci_pref) and the FSM carry after the chunk, (4, M)
    int32, in the launch form :func:`launch_form` picks by K; with ``gate``,
    the forecast-gated instance of that form."""
    return _stream_chunk_launch(
        "auto", block, K, endo, capacity, L_vpn, lease_cci, c_cci, bounds, rates, theta1,
        theta2, h, D, T_cci, up_hold, down_hold, cal, fsm, pref, t0, hours_per_month,
        renew_in_chunks=renew_in_chunks, gate=gate)


def _stream_chunk_launch(form, block, K, endo, capacity, L_vpn, lease_cci, c_cci, bounds,
                         rates, theta1, theta2, h, D, T_cci, up_hold, down_hold, cal, fsm,
                         pref, t0, hours_per_month, *, renew_in_chunks=False, gate=None):
    """:func:`stream_chunk` in the launch form ``form`` (``"auto"``,
    ``"tick"`` or ``"chunk"``, :func:`launch_form`): the tests and
    ``chip_smoke.py`` force each form with it; both give the same bits."""
    M = capacity.shape[0]
    dev = block.device
    f64, i32 = torch.float64, torch.int32
    if K < 1 or t0 < 0 or hours_per_month < 1:
        raise ValueError(f"stream_chunk: K {K}, t0 {t0}, hours_per_month {hours_per_month}")
    if block.dtype != f64 or block.shape != (block_size(K, M, endo),):
        raise ValueError(f"stream_chunk block: want flat float64 of {block_size(K, M, endo)}, "
                         f"got {tuple(block.shape)} {block.dtype}")
    Kt = bounds.shape[-1]
    want = [(bounds, (M, Kt), f64), (rates, (M, Kt), f64), (cal, (2, M), f64),
            (fsm, (4, M), i32), (pref, (2, M), f64)]
    want += [(a, (M,), f64) for a in (capacity, L_vpn, lease_cci, c_cci, theta1, theta2)]
    want += [(a, (M,), i32) for a in (h, D, T_cci, up_hold, down_hold)]
    want += _gate_operands("stream_chunk", gate, M)
    _check_operands("stream_chunk", block, want)
    code = launch_form(K, Kt, form)
    gate_ptrs, T_pred = _gate_args(gate)
    lib = _lib.load()
    out = torch.empty((8 * K + 4, M), dtype=f64, device=dev)
    fsm_out = torch.empty((4, M), dtype=i32, device=dev)
    nd = (2 if endo else 1) * K * M
    at = lambda off: block.data_ptr() + 8 * off   # element offset into the block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stream_chunk_f64(
            at(0), at(K * M) if endo else None, at(nd), at(nd + K * M),
            *(a.data_ptr() for a in (capacity, L_vpn, lease_cci, c_cci, bounds, rates,
                                     theta1, theta2, h, D, T_cci, up_hold, down_hold,
                                     cal, fsm, pref)),
            *gate_ptrs, int(bool(renew_in_chunks)), t0, hours_per_month, K, M, Kt, code,
            T_pred, out.data_ptr(), fsm_out.data_ptr(), stream,
        )
    _lib.check(status, "stream_chunk_f64")
    _lib.LAUNCHES["stream_chunk" if gate is None else "stream_chunk_gated"] += 1
    return out, fsm_out


def stream_chunk_routed(
    block: torch.Tensor,          # flat float64, block_size(K, M, endo, P)
    K: int,
    endo: bool,                   # the block holds a CCI demand plane
    pair_capacity: torch.Tensor,  # (P,) float64
    L_vpn: torch.Tensor,          # (P,) float64
    bounds: torch.Tensor,         # (P, Kt) float64 padded tier bounds (finite)
    rates: torch.Tensor,          # (P, Kt) float64
    lease_cci: torch.Tensor,      # (M,) float64: L_cci + V_cci * n_attach
    c_cci: torch.Tensor,          # (M,) float64
    port_capacity: torch.Tensor,  # (M,) float64
    theta1: torch.Tensor,         # (M,) float64
    theta2: torch.Tensor,         # (M,) float64
    h: torch.Tensor,              # (M,) int32 window
    D: torch.Tensor,              # (M,) int32
    T_cci: torch.Tensor,          # (M,) int32
    up_hold: torch.Tensor,        # (M,) int32 >= 1
    down_hold: torch.Tensor,      # (M,) int32 >= 1
    routing,                      # RoutingOperand with its port-major LegIndex
    cal: torch.Tensor,            # (2, P) float64: dcum, dcum_month
    fsm: torch.Tensor,            # (4, M) int32: state, t_state, up, down
    pref: torch.Tensor,           # (2, M) float64: vpn_pref, cci_pref
    t0: int,                      # the chunk's first hour
    hours_per_month: int,
    *,
    renew_in_chunks: bool = False,
    gate=None,                    # (p_vpn, p_cci (T_pred, M) f64, margin (M,) f64, T_pred)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed chunk on the card, one C call (a pair-stage and a
    port-stage kernel on the current stream; the wrapper owns their scratch,
    two pair-major (P, K) planes): the flat float64 result of
    :func:`routed_result_size` and the FSM carry after the chunk, (4, M)
    int32. With ``gate`` (per port) the port stage is its forecast-gated
    instance."""
    P, M = pair_capacity.shape[0], lease_cci.shape[0]
    f64, i32 = torch.float64, torch.int32
    if K < 1 or t0 < 0 or hours_per_month < 1:
        raise ValueError(f"stream_chunk_routed: K {K}, t0 {t0}, "
                         f"hours_per_month {hours_per_month}")
    n = block_size(K, M, endo, P)
    if block.dtype != f64 or block.shape != (n,):
        raise ValueError(f"stream_chunk_routed block: want flat float64 of {n}, "
                         f"got {tuple(block.shape)} {block.dtype}")
    idx = routing.index
    if idx is None or idx.n_ports != M:
        raise ValueError(f"stream_chunk_routed: the routing has no port-major leg index "
                         f"for {M} ports; build it with index_legs(op, {M})")
    if routing.n_rows != P:
        raise ValueError(f"stream_chunk_routed: routing has {routing.n_rows} rows, "
                         f"the chunk {P} pairs")
    Kt, E = bounds.shape[-1], routing.n_legs
    want = [(bounds, (P, Kt), f64), (rates, (P, Kt), f64), (cal, (2, P), f64),
            (fsm, (4, M), i32), (pref, (2, M), f64),
            (routing.leg_pair, (E,), i32), (routing.vpn_w, (E,), f64),
            (routing.attach_w, (E,), f64), (idx.order, (E,), i32), (idx.start, (M + 1,), i32)]
    want += [(a, (P,), f64) for a in (pair_capacity, L_vpn)]
    want += [(a, (M,), f64) for a in (lease_cci, c_cci, port_capacity, theta1, theta2)]
    want += [(a, (M,), i32) for a in (h, D, T_cci, up_hold, down_hold)]
    want += _gate_operands("stream_chunk_routed", gate, M)
    _check_operands("stream_chunk_routed", block, want)
    gate_ptrs, T_pred = _gate_args(gate)
    lib = _lib.load()
    dev = block.device
    out = torch.empty(routed_result_size(K, P, M), dtype=f64, device=dev)
    fsm_out = torch.empty((4, M), dtype=i32, device=dev)
    scratch = torch.empty(2 * K * P, dtype=f64, device=dev)
    nd = (2 if endo else 1) * K * P
    at = lambda off: block.data_ptr() + 8 * off   # element offset into the block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stream_chunk_routed_f64(
            at(0), at(K * P) if endo else None, at(nd), at(nd + K * M),
            *(a.data_ptr() for a in (
                pair_capacity, L_vpn, bounds, rates, lease_cci, c_cci, port_capacity,
                theta1, theta2, h, D, T_cci, up_hold, down_hold, routing.leg_pair,
                routing.vpn_w, routing.attach_w, idx.order, idx.start, cal, fsm, pref,
                scratch)),
            *gate_ptrs, int(bool(renew_in_chunks)), t0, hours_per_month, K, P, M, E, Kt,
            T_pred, out.data_ptr(), fsm_out.data_ptr(), stream,
        )
    _lib.check(status, "stream_chunk_routed_f64")
    _lib.LAUNCHES["stream_chunk_routed" if gate is None else "stream_chunk_routed_gated"] += 1
    return out, fsm_out
