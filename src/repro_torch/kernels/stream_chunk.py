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
  leg order, before the port FSMs run: ``csrc/stream_chunk_routed.cu``, one
  launch in one of two forms that the routing's index chose on the host
  (:func:`routed_form`): the port-block form (a block a port prices its own
  legs' pairs and walks a slice of the pairs' calendars), for few busy
  ports, or the small-port form (a warp a port, :data:`SMALL_PORTS` ports
  a block), for many ports of few legs, the gateway's large topology
  buckets.

Both take an optional ``gate=(p_vpn, p_cci, margin, T_pred)``: the
forecast-gated policy's hour-major (T_pred, M) predicted mode costs and its
(M,) margins. A gated call launches the kernels' gated instances, which
read the planes at hour ``min(t0 + k, T_pred − 1)`` and gate the raw
triggers as ``ForecastGatedPolicy.step`` does (``csrc/fsm_step.cuh``); it
counts under ``stream_chunk_gated`` / ``stream_chunk_routed_gated`` in
:data:`~repro_torch.kernels._lib.LAUNCHES`, an ungated one under
``stream_chunk`` / ``stream_chunk_routed``.

Or, instead of ``gate``, ``live=(h, pred, a, one_minus_a, w, bias, scale,
cost_coef, margin)``: the same policy in live mode, its forecast made inside
the chunk. ``h`` (M, S) float32 is the SSM forecaster's state and ``pred``
(M,) float64 the forecast carried into the chunk; ``a``, ``one_minus_a``,
``w`` (S,) and ``bias`` () float32 its operands
(:func:`repro_torch.models.ssm._operands`); ``scale`` (M,), ``cost_coef``
(M, 4) and ``margin`` (M,) float64. Each hour's gates read the predicted mode
costs of the forecast carried into it; after the hour's FSM step the
forecaster consumes ``u = log1p(float32(d_row / scale))`` (``d_row`` the
clipped demand, in topology mode the clipped pair demand folded onto the
port) and makes the next forecast, ``maximum(expm1(y), 0)·scale``. A live call
returns a third tensor, the state after the chunk, and its result holds a
ninth (K, M) plane, the forecasts made after each hour, after the state
plane. It launches the kernels' live instances, counted under
``stream_chunk_live`` / ``stream_chunk_routed_live``.

Both also have a *pooled* instance, the multi-tenant gateway's
(:mod:`repro_torch.gateway`): a bucket's slots stacked into one call whose
rows keep their own clocks, since tenants join at different gateway hours.
Passing the clocks as int32 tensors, ``clocks=`` in place of ``t0`` and
``hours_per_month`` (:func:`chunk_clocks`), selects it: each row's billing
calendar starts its
months at its own phase, and its window bases and replay gate columns
(``min(t0 + k, T_pred − 1)``) follow its own first hour. It has reactive,
hysteresis and replay-gated modes, counted under ``stream_chunk_pooled`` /
``stream_chunk_pooled_gated`` (``stream_chunk_routed_pooled`` /
``..._gated``); with one common clock on every row it gives the bits of the
scalar instance.

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
    demand), (K, P) hour-major in fleet mode (P == M) and (P, K) pair-major
    in topology mode, then the window reads pre_v, pre_c (K, M)."""
    return ((2 if endo else 1) * (M if P is None else P) + 2 * M) * K


def routed_result_size(K: int, P: int, M: int, live: bool = False) -> int:
    """Elements of the routed chunk's flat result: the 8 (K, M) planes (9 in
    live mode), then dcum, dcum_month (P each), then vpn_pref, cci_pref (M
    each)."""
    return (9 if live else 8) * K * M + 2 * P + 2 * M


#: The largest K the wrapper sends to the tick form, and its last
#: compile-time instance (K = 1..5, ``kTickMaxK`` in ``csrc/stream_chunk.cu``):
#: from K = 6 the chunk form was faster on the card (PERF.md, the K sweep of
#: both forms up to K = 8). Then the tiers its tables hold in registers.
TICK_MAX_K = 5
TICK_MAX_TIERS = 8
#: The live instance's last tick-form instance (``kTickMaxKLive``): from
#: K = 4 its chunk form was faster on the card (PERF.md, the live K sweep of
#: both forms).
TICK_MAX_K_LIVE = 3
#: Hours a chunk-form sub-tile, and sub-tiles a tile (five named barriers
#: each, of the 15 a block has besides ``__syncthreads``).
SUB_HOURS = 8
MAX_SUBS = 3
FORMS = ("auto", "tick", "chunk")
#: The routed chunk's hour tile (``kTile`` in ``csrc/stream_chunk_routed.cu``):
#: a chunk of more than ROUTED_TILE hours keeps each leg's calendar carry
#: between hour tiles in a (2, E) scratch the wrapper owns (the port-block
#: form; the small-port form keeps it in a lane's registers).
ROUTED_TILE = 32
#: The routed chunk's launch forms, for :func:`stream_chunk_routed`'s
#: private ``form=``.
ROUTED_FORMS = ("auto", "port_block", "small_port")
#: The small-port form's limits, as ``csrc/stream_chunk_routed.cu`` fixes
#: them: the most legs a port holds (``kSmallLegs``: a lane a leg), its port
#: warps a block (``kSmallPorts``) and the most dynamic shared memory a
#: block may take (``kMaxSmem``).
SMALL_PORT_MAX_LEGS = 32
SMALL_PORTS = 8
SMALL_PORT_MAX_SMEM = 227 * 1024
#: The selection rule, from the sweep of both forms on the H100
#: (``routed_forms.py``, PERF.md): the small-port form from
#: SMALL_PORT_MIN_PORTS ports on, when the hottest port holds at most
#: SMALL_PORT_LEGS_BELOW legs below SMALL_PORT_WIDE_PORTS ports and at most
#: SMALL_PORT_MAX_LEGS from there on. Up to 132 ports the port-block form
#: runs in one wave of a block an SM and is faster (1.0-2.4x at 4-32 legs);
#: from 133 ports (its second wave) to 256 the small-port form is faster up
#: to 16 legs (0.56-0.97 of its time), as fast at 24 (0.81-1.08) and slower
#: at 32 (0.96-1.36); from 384 ports on it is faster up to 32 legs
#: (0.53-0.88).
SMALL_PORT_MIN_PORTS = 133
SMALL_PORT_LEGS_BELOW = 16
SMALL_PORT_WIDE_PORTS = 384


def routed_form(max_legs: int, n_ports: int) -> str:
    """The routed chunk's launch form by the selection rule for a routing
    of ``n_ports`` ports whose busiest port holds ``max_legs`` legs (host
    ints, from the port-major index's runs; -1 when unknown):
    ``"small_port"`` from :data:`SMALL_PORT_MIN_PORTS` ports on when
    ``0 <= max_legs`` and ``max_legs`` is at most
    :data:`SMALL_PORT_LEGS_BELOW` (below :data:`SMALL_PORT_WIDE_PORTS`
    ports) or :data:`SMALL_PORT_MAX_LEGS` (from there on), else
    ``"port_block"``. Pure."""
    cap = SMALL_PORT_MAX_LEGS if n_ports >= SMALL_PORT_WIDE_PORTS else SMALL_PORT_LEGS_BELOW
    small = n_ports >= SMALL_PORT_MIN_PORTS and 0 <= max_legs <= cap
    return "small_port" if small else "port_block"


def small_port_geometry(P: int, M: int, K: int, Kt: int, endo: bool, max_legs: int) -> dict:
    """The small-port form's launch as its C entry sizes it: ``blocks`` of
    ``threads`` (a warp a port, :data:`SMALL_PORTS` ports a block) and
    ``smem`` bytes of dynamic shared memory: per port warp, the hour planes
    (two, three with CCI demand) of ``rows`` rows (the hottest port's legs,
    then as much of a port's slice of the calendars, ``ceil(P / M)`` pairs,
    as makes 32) of ``min(K, 32) | 1`` doubles, the legs' tier rows (padded
    to a multiple of four tiers), their three weights, the rows' capacities,
    eight hour arrays of a tile and 32 ints."""
    stride = min(K, ROUTED_TILE) | 1
    rows = min(SMALL_PORT_MAX_LEGS, max_legs + (-(-P // M) if M else 0))
    doubles = ((3 if endo else 2) * rows * stride + max_legs * 2 * (-(-Kt // 4) * 4)
               + 3 * max_legs + rows + 8 * ROUTED_TILE + 32 // 2)
    return {"blocks": -(-M // SMALL_PORTS), "threads": 32 * SMALL_PORTS,
            "smem": 8 * SMALL_PORTS * doubles, "rows": rows}


def small_port_fits(index, P: int, K: int, Kt: int, endo: bool) -> bool:
    """Whether the small-port form takes a call of ``P`` pairs, ``K`` hours
    and ``Kt`` tiers (``endo``: with CCI demand) over the port-major
    ``index``: its hottest port is known and holds at most
    :data:`SMALL_PORT_MAX_LEGS` legs, and the launch's shared memory
    (:func:`small_port_geometry`) is at most :data:`SMALL_PORT_MAX_SMEM`.
    Reads no device memory."""
    M = index.n_ports
    if not (0 <= index.max_legs <= SMALL_PORT_MAX_LEGS and M >= 1):
        return False
    return small_port_geometry(P, M, K, Kt, endo, index.max_legs)["smem"] <= SMALL_PORT_MAX_SMEM


def routed_launch_form(index, P: int, K: int, Kt: int, endo: bool, form: str = "auto",
                       live: bool = False) -> str:
    """The form a routed chunk call of ``P`` pairs, ``K`` hours, ``Kt``
    tiers and CCI demand or not (``endo``) launches over the port-major
    ``index``: ``"auto"`` takes :func:`routed_form` of the hottest port and
    the port count the index recorded on the host, and the port-block form
    where the small-port form does not take the call
    (:func:`small_port_fits`) and for a ``live`` call (the small-port form
    has no live instance); ``"port_block"`` and ``"small_port"`` force one,
    for the tests and ``chip_smoke.py``. Raises on an unknown name, and when
    the small-port form is forced on a live call or on a call it does not
    take. Reads no device memory."""
    if form not in ROUTED_FORMS:
        raise ValueError(f"stream_chunk_routed form {form!r}: want one of {ROUTED_FORMS}")
    if form == "port_block":
        return form
    fits = small_port_fits(index, P, K, Kt, endo)
    if form == "auto":
        small = not live and fits and routed_form(index.max_legs, index.n_ports) == "small_port"
        return "small_port" if small else "port_block"
    if live:
        raise ValueError("stream_chunk_routed form 'small_port': the small-port form has no "
                         "live instance")
    if not fits:
        smem = small_port_geometry(P, index.n_ports, K, Kt, endo, max(index.max_legs, 0))["smem"]
        raise ValueError(f"stream_chunk_routed form 'small_port': the routing's hottest port "
                         f"holds {index.max_legs} legs over {index.n_ports} ports (the form "
                         f"takes at most {SMALL_PORT_MAX_LEGS}, a lane each, and a port), and "
                         f"at {P} pairs, K = {K}, {Kt} tiers"
                         f"{' with CCI demand' if endo else ''} it takes {smem} bytes of shared "
                         f"memory a block (at most {SMALL_PORT_MAX_SMEM})")
    return form


def launch_form(K: int, Kt: int, form: str = "auto", live: bool = False) -> int:
    """The C entry's ``form`` code for a chunk of K hours against Kt-tier
    tables: 0 the tick form, S = 1..3 the chunk form with S sub-tiles of
    :data:`SUB_HOURS` hours a tile (``ceil(K / 8)``, at most
    :data:`MAX_SUBS`; a longer chunk walks several tiles). ``"auto"`` takes
    the tick form for K <= :data:`TICK_MAX_K` (:data:`TICK_MAX_K_LIVE` for
    the ``live`` instance) when the tables fit its registers; ``"tick"`` and
    ``"chunk"`` force one (the tick form raises past its instances), for
    :func:`_stream_chunk_launch`."""
    if form not in FORMS:
        raise ValueError(f"stream_chunk form {form!r}: want one of {FORMS}")
    if K < 1:
        raise ValueError(f"stream_chunk: K {K}")
    max_k = TICK_MAX_K_LIVE if live else TICK_MAX_K
    fits = K <= max_k and Kt <= TICK_MAX_TIERS
    if form == "tick" and not fits:
        raise ValueError(f"stream_chunk tick form: K {K} (at most {max_k}) or "
                         f"{Kt} tiers (at most {TICK_MAX_TIERS})")
    if form != "chunk" and fits:
        return 0
    return min(MAX_SUBS, -(-K // SUB_HOURS))


def chunk_clocks(name: str, t0, hours_per_month, clocks, live=None) -> tuple:
    """``(t0_pair, t0_row, hours_per_month, pooled)`` of a chunk call's
    clocks. A call of one stream passes ints ``t0`` (the chunk's first hour,
    then both ``t0``s) and ``hours_per_month``. A pooled call (the gateway's
    buckets, whose slots keep their own clocks) passes instead ``clocks``, a
    tuple of int32 tensors: ``(t0 (M,), hours_per_month (M,))`` in fleet
    mode, one clock per row; ``(t0_port (M,), hours_per_month (P,), t0_pair
    (P,))`` in topology mode (the window bases and gate columns run per
    port, the calendars per pair). Raises unless exactly one of the two is
    given, and for a pooled live call (there is no pooled live instance: the
    gateway refuses live-mode tenants)."""
    if clocks is None:
        if t0 is None or hours_per_month is None or torch.is_tensor(t0) or \
                torch.is_tensor(hours_per_month):
            raise ValueError(f"{name}: want int t0 and hours_per_month, or clocks= (the "
                             "pooled instance's int32 tensors)")
        return t0, t0, hours_per_month, False
    if t0 is not None or hours_per_month is not None:
        raise ValueError(f"{name}: clocks= (the pooled instance) replaces t0 and "
                         "hours_per_month; pass one or the other")
    if live is not None:
        raise ValueError(f"{name}: per-row clocks (the pooled instance) have no live mode")
    t0_row, hpm = clocks[0], clocks[1]
    return (clocks[2] if len(clocks) == 3 else t0_row), t0_row, hpm, True


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


def _live_operands(name: str, gate, live, M: int) -> list:
    """``_check_operands``' entries for a chunk's ``live=(h, pred, a,
    one_minus_a, w, bias, scale, cost_coef, margin)`` (none for None);
    raises if ``gate`` is given too or the state is not (M, S) with S >= 1."""
    if live is None:
        return []
    if gate is not None:
        raise ValueError(f"{name}: gate= (replay mode) and live= exclude each other")
    h, pred, a, oma, w, bias, scale, coef, margin = live
    S = h.shape[1] if h.dim() == 2 else -1
    if S < 1:
        raise ValueError(f"{name} live: the forecaster's state must be (M, S) with S >= 1, "
                         f"got {tuple(h.shape)}")
    f32, f64 = torch.float32, torch.float64
    return [(h, (M, S), f32), (pred, (M,), f64), (a, (S,), f32), (oma, (S,), f32),
            (w, (S,), f32), (bias.reshape(()), (), f32), (scale, (M,), f64),
            (coef, (M, 4), f64), (margin, (M,), f64)]


def _live_args(live) -> tuple:
    """The C entry's live arguments: the eight pointers (null for a call
    that is not live) and S (0)."""
    if live is None:
        return (None,) * 8, 0
    h, pred, a, oma, w, bias, scale, coef, _ = live
    return tuple(t.data_ptr() for t in (h, pred, a, oma, w, bias, scale, coef)), h.shape[1]


def _launch_name(base: str, gate, live, pooled: bool = False) -> str:
    return (base + ("_pooled" if pooled else "")
            + ("_live" if live is not None else "" if gate is None else "_gated"))


def _clock_args(name: str, t0, hours_per_month, clocks, live, rows) -> tuple:
    """The C entry's clock arguments and ``_check_operands``' entries for
    them: ``(pooled, scalar t0, scalar hours_per_month, pointers, want)``.
    ``rows`` gives the length of each tensor of ``clocks``, in its order
    (:func:`chunk_clocks`), which is the C entry's; a pooled call passes the
    scalars 0 and 1 (not read) and the tensors' pointers, a call of one
    stream null pointers."""
    _, t0, hpm, pooled = chunk_clocks(name, t0, hours_per_month, clocks, live)
    if not pooled:
        if t0 < 0 or hpm < 1:
            raise ValueError(f"{name}: t0 {t0}, hours_per_month {hpm}")
        return False, int(t0), int(hpm), (None,) * len(rows), []
    if len(clocks) != len(rows):
        raise ValueError(f"{name}: clocks= holds {len(clocks)} tensors, want {len(rows)}")
    want = [(c, (n,), torch.int32) for c, n in zip(clocks, rows)]
    return True, 0, 1, tuple(c.data_ptr() for c in clocks), want


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
    t0: Optional[int] = None,               # the chunk's first hour
    hours_per_month: Optional[int] = None,
    *,
    renew_in_chunks: bool = False,
    gate=None,                # (p_vpn, p_cci (T_pred, M) f64, margin (M,) f64, T_pred)
    live=None,                # (h, pred, a, one_minus_a, w, bias, scale, cost_coef, margin)
    clocks=None,              # pooled, for t0 and hours_per_month: (t0, hpm) (M,) int32
) -> Tuple[torch.Tensor, ...]:
    """The chunk on the card: the packed float64 (8K + 4, M) result (vpn, cci,
    r_vpn, r_cci, snap_v, snap_c, x, state, K rows each, then dcum,
    dcum_month, vpn_pref, cci_pref) and the FSM carry after the chunk, (4, M)
    int32, in the launch form :func:`launch_form` picks by K; with ``gate``,
    the forecast-gated instance of that form; with ``live``, the live
    instance: a (9K + 4, M) result (pred after state) and the forecaster's
    state after the chunk, (M, S) float32, third. With ``clocks`` (no live
    mode) the pooled instance of that form, each row on its own clock."""
    return _stream_chunk_launch(
        "auto", block, K, endo, capacity, L_vpn, lease_cci, c_cci, bounds, rates, theta1,
        theta2, h, D, T_cci, up_hold, down_hold, cal, fsm, pref, t0, hours_per_month,
        renew_in_chunks=renew_in_chunks, gate=gate, live=live, clocks=clocks)


def _stream_chunk_launch(form, block, K, endo, capacity, L_vpn, lease_cci, c_cci, bounds,
                         rates, theta1, theta2, h, D, T_cci, up_hold, down_hold, cal, fsm,
                         pref, t0=None, hours_per_month=None, *, renew_in_chunks=False,
                         gate=None, live=None, clocks=None):
    """:func:`stream_chunk` in the launch form ``form`` (``"auto"``,
    ``"tick"`` or ``"chunk"``, :func:`launch_form`): the tests and
    ``chip_smoke.py`` force each form with it; both give the same bits."""
    M = capacity.shape[0]
    dev = block.device
    f64, i32 = torch.float64, torch.int32
    if K < 1:
        raise ValueError(f"stream_chunk: K {K}")
    pooled, t0, hours_per_month, clock_ptrs, clock_want = _clock_args(
        "stream_chunk", t0, hours_per_month, clocks, live, (M, M))
    if block.dtype != f64 or block.shape != (block_size(K, M, endo),):
        raise ValueError(f"stream_chunk block: want flat float64 of {block_size(K, M, endo)}, "
                         f"got {tuple(block.shape)} {block.dtype}")
    Kt = bounds.shape[-1]
    want = [(bounds, (M, Kt), f64), (rates, (M, Kt), f64), (cal, (2, M), f64),
            (fsm, (4, M), i32), (pref, (2, M), f64)]
    want += [(a, (M,), f64) for a in (capacity, L_vpn, lease_cci, c_cci, theta1, theta2)]
    want += [(a, (M,), i32) for a in (h, D, T_cci, up_hold, down_hold)]
    want += _gate_operands("stream_chunk", gate, M)
    want += _live_operands("stream_chunk", gate, live, M) + clock_want
    _check_operands("stream_chunk", block, want)
    code = launch_form(K, Kt, form, live is not None)
    gate_ptrs, T_pred = _gate_args(gate)
    live_ptrs, S = _live_args(live)
    margin = None if live is None else live[8].data_ptr()
    lib = _lib.load()
    out = torch.empty(((9 if live is not None else 8) * K + 4, M), dtype=f64, device=dev)
    fsm_out = torch.empty((4, M), dtype=i32, device=dev)
    h_out = torch.empty((M, S), dtype=torch.float32, device=dev) if live is not None else None
    nd = (2 if endo else 1) * K * M
    at = lambda off: block.data_ptr() + 8 * off   # element offset into the block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stream_chunk_f64(
            at(0), at(K * M) if endo else None, at(nd), at(nd + K * M),
            *(a.data_ptr() for a in (capacity, L_vpn, lease_cci, c_cci, bounds, rates,
                                     theta1, theta2, h, D, T_cci, up_hold, down_hold,
                                     cal, fsm, pref)),
            *(gate_ptrs if live is None else (None, None, margin)), *live_ptrs, *clock_ptrs,
            int(bool(renew_in_chunks)), t0, hours_per_month, K, M, Kt, code, T_pred, S,
            out.data_ptr(), fsm_out.data_ptr(), None if h_out is None else h_out.data_ptr(),
            stream,
        )
    _lib.check(status, "stream_chunk_f64")
    _lib.LAUNCHES[_launch_name("stream_chunk", gate, live, pooled)] += 1
    return (out, fsm_out) if live is None else (out, fsm_out, h_out)


def stream_chunk_routed(
    block: torch.Tensor,          # flat float64, block_size(K, M, endo, P); demand (P, K)
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
    t0: Optional[int] = None,     # the chunk's first hour
    hours_per_month: Optional[int] = None,
    *,
    renew_in_chunks: bool = False,
    gate=None,                    # (p_vpn, p_cci (T_pred, M) f64, margin (M,) f64, T_pred)
    live=None,                    # (h, pred, a, one_minus_a, w, bias, scale, cost_coef, margin)
    clocks=None,                  # pooled: (t0_port (M,), hpm (P,), t0_pair (P,)) int32
    form: str = "auto",           # private: the tests and chip_smoke.py force a form
) -> Tuple[torch.Tensor, ...]:
    """The routed chunk on the card, one kernel launch on the current stream
    in the form :func:`routed_launch_form` takes from the routing's hottest
    port, which its index recorded on the host, and the call's shape
    (``form`` is private: the tests and
    ``chip_smoke.py`` force ``"port_block"`` or ``"small_port"`` with it,
    and both give the same bits; past :data:`ROUTED_TILE` hours the
    port-block form's wrapper owns its scratch, each leg's calendar carry,
    (2, E)): the flat float64 result of
    :func:`routed_result_size` and the FSM carry after the chunk, (4, M)
    int32. ``routing`` must carry its port-major :class:`LegIndex` with the
    leg descriptors (``leg_pair_pm``, ``vpn_w_pm``, ``attach_w_pm``, built by
    ``RoutingPlan.operand`` or ``index_legs``). With ``gate`` (per port) the
    kernel is its forecast-gated instance; with ``live`` (per port) its live
    instance, and the result holds a ninth (K, M) plane
    (``routed_result_size(K, P, M, live=True)``) and the forecaster's state
    after the chunk comes third. With ``clocks`` (no live mode) its pooled
    instance, each port and pair on its own clock."""
    P, M = pair_capacity.shape[0], lease_cci.shape[0]
    f64, i32 = torch.float64, torch.int32
    if K < 1:
        raise ValueError(f"stream_chunk_routed: K {K}")
    pooled, t0, hours_per_month, clock_ptrs, clock_want = _clock_args(
        "stream_chunk_routed", t0, hours_per_month, clocks, live, (M, P, P))
    n = block_size(K, M, endo, P)
    if block.dtype != f64 or block.shape != (n,):
        raise ValueError(f"stream_chunk_routed block: want flat float64 of {n}, "
                         f"got {tuple(block.shape)} {block.dtype}")
    idx = routing.index
    if idx is None or idx.n_ports != M or not idx.port_major:
        raise ValueError(f"stream_chunk_routed: the routing has no port-major leg index "
                         f"with its leg descriptors for {M} ports; build it with "
                         f"index_legs(op, {M})")
    if routing.n_rows != P:
        raise ValueError(f"stream_chunk_routed: routing has {routing.n_rows} rows, "
                         f"the chunk {P} pairs")
    Kt, E = bounds.shape[-1], routing.n_legs
    small = routed_launch_form(idx, P, K, Kt, endo, form, live is not None) == "small_port"
    want = [(bounds, (P, Kt), f64), (rates, (P, Kt), f64), (cal, (2, P), f64),
            (fsm, (4, M), i32), (pref, (2, M), f64),
            (idx.leg_pair_pm, (E,), i32), (idx.vpn_w_pm, (E,), f64),
            (idx.attach_w_pm, (E,), f64), (idx.start, (M + 1,), i32)]
    want += [(a, (P,), f64) for a in (pair_capacity, L_vpn)]
    want += [(a, (M,), f64) for a in (lease_cci, c_cci, port_capacity, theta1, theta2)]
    want += [(a, (M,), i32) for a in (h, D, T_cci, up_hold, down_hold)]
    want += _gate_operands("stream_chunk_routed", gate, M)
    want += _live_operands("stream_chunk_routed", gate, live, M) + clock_want
    _check_operands("stream_chunk_routed", block, want)
    gate_ptrs, T_pred = _gate_args(gate)
    live_ptrs, S = _live_args(live)
    margin = None if live is None else live[8].data_ptr()
    lib = _lib.load()
    dev = block.device
    out = torch.empty(routed_result_size(K, P, M, live is not None), dtype=f64, device=dev)
    fsm_out = torch.empty((4, M), dtype=i32, device=dev)
    h_out = torch.empty((M, S), dtype=torch.float32, device=dev) if live is not None else None
    leg_cal = (torch.empty(2 * E, dtype=f64, device=dev)
               if K > ROUTED_TILE and E > 0 and not small else None)
    nd = (2 if endo else 1) * K * P
    at = lambda off: block.data_ptr() + 8 * off   # element offset into the block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stream_chunk_routed_f64(
            at(0), at(K * P) if endo else None, at(nd), at(nd + K * M),
            *(a.data_ptr() for a in (
                pair_capacity, L_vpn, bounds, rates, lease_cci, c_cci, port_capacity,
                theta1, theta2, h, D, T_cci, up_hold, down_hold, idx.leg_pair_pm,
                idx.vpn_w_pm, idx.attach_w_pm, idx.start, cal, fsm, pref)),
            None if leg_cal is None else leg_cal.data_ptr(),
            *(gate_ptrs if live is None else (None, None, margin)), *live_ptrs, *clock_ptrs,
            int(bool(renew_in_chunks)), t0, hours_per_month, K, P, M, E, Kt, T_pred, S,
            idx.max_legs if small else 0, int(small),
            out.data_ptr(), fsm_out.data_ptr(), None if h_out is None else h_out.data_ptr(),
            stream,
        )
    _lib.check(status, "stream_chunk_routed_f64")
    _lib.LAUNCHES[_launch_name("stream_chunk_routed", gate, live, pooled)] += 1
    if small:
        _lib.LAUNCHES["stream_chunk_routed_small_port"] += 1
    return (out, fsm_out) if live is None else (out, fsm_out, h_out)


#: The transcendentals of the live instances, by the C entry's code.
LIVE_MATH = ("log1p", "exp", "expm1", "log1pf")


def live_math(x: torch.Tensor, fn: str) -> torch.Tensor:
    """``fn`` (one of :data:`LIVE_MATH`) elementwise over a contiguous CUDA
    tensor, as the live instances' build computes it (float64; float32 for
    ``log1pf``): the card's check that these give torch's ops' bits. Not a
    path kernel; it counts no launch."""
    if fn not in LIVE_MATH:
        raise ValueError(f"live_math: {fn!r} is not one of {LIVE_MATH}")
    dt = torch.float32 if fn == "log1pf" else torch.float64
    if x.dtype != dt or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"live_math {fn}: takes a contiguous CUDA {dt} tensor")
    y = torch.empty_like(x)
    lib = _lib.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stream_chunk_live_math(x.data_ptr(), y.data_ptr(), x.numel(),
                                            LIVE_MATH.index(fn), stream)
    _lib.check(status, "stream_chunk_live_math")
    return y
