"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Port of :mod:`repro.kernels.ref` for the kernels of the fleet planner's,
the LM serving and the actuation path (int8 quantization, the static
tiered cost), and the MoE layer's routing, dispatch and combine. Each function computes what its CUDA kernel computes, in the same
order of operations where that order decides the bits. They run wherever a
tensor lies; :mod:`repro_torch.kernels.ops` sends CPU tensors here, and the
chip checks hold each kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.costmodel import tiered_marginal_cost_tables
from repro_torch.core.togglecci import ToggleParams, window_sums

from .forecaster import BWD_TILE
from .moe import MoERouting, aux_scale, check_router
from .stream_chunk import block_size, chunk_clocks
from .tiered_cost import tier_table


def tiered_cost_batched_ref(
    month_cum: torch.Tensor, demand: torch.Tensor, bounds: torch.Tensor,
    rates: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.tiered_cost.tiered_cost_batched`
    (float64 or float32; the left fold over tiers of the kernel)."""
    return tiered_marginal_cost_tables(month_cum, demand, bounds, rates)


def _gated_triggers(raw_req: torch.Tensor, raw_rel: torch.Tensor, theta1: torch.Tensor,
                   theta2: torch.Tensor, p_vpn: torch.Tensor, p_cci: torch.Tensor,
                   margin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ForecastGatedPolicy.step``'s request and release from the raw trigger
    planes and the hours' predicted mode costs
    (``src/repro/fleet/policy.py:290-300``): each row's ``θ ± m`` formed
    once, then multiplied by the hour's predicted VPN cost; ``<`` and ``>``,
    so a NaN prediction makes every comparison false. ``theta1``,
    ``theta2`` and ``margin`` come shaped to broadcast against the planes'
    row axis; ``fsm_step.cuh::fsm_gate`` and ``fsm_gated_triggers`` are the
    kernels' form of the same arithmetic."""
    req = (p_cci < (theta1 - margin) * p_vpn) | (raw_req & (p_cci < (theta1 + margin) * p_vpn))
    rel = (p_cci > (theta2 + margin) * p_vpn) | (raw_rel & (p_cci > (theta2 - margin) * p_vpn))
    return req, rel


def fsm_scan_ref(
    vpn: torch.Tensor, cci: torch.Tensor,
    theta1: torch.Tensor, theta2: torch.Tensor,
    h: torch.Tensor, D: torch.Tensor, T_cci: torch.Tensor,
    up_hold: torch.Tensor, down_hold: torch.Tensor,
    *,
    renew_in_chunks: bool = False,
    gate: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.fsm_scan.fsm_scan`.

    ``gate=(pred, coef, margin)`` forms the predicted mode costs with
    :func:`repro_torch.fleet.policy.predicted_mode_costs` on ``pred``'s
    device (the kernel forms them with CUDA's ``log1p`` and ``exp``, which
    give torch's CUDA ops' bits), then gates as :func:`fsm_scan_planes_ref`.
    """
    planes = None
    if gate is not None:
        from repro_torch.fleet.policy import predicted_mode_costs

        pred, coef, margin = gate
        planes = predicted_mode_costs(pred, coef, torch.float64) + (margin,)
    return fsm_scan_planes_ref(vpn, cci, theta1, theta2, h, D, T_cci, up_hold, down_hold,
                               renew_in_chunks=renew_in_chunks, planes=planes)


def fsm_scan_planes_ref(
    vpn: torch.Tensor, cci: torch.Tensor,
    theta1: torch.Tensor, theta2: torch.Tensor,
    h: torch.Tensor, D: torch.Tensor, T_cci: torch.Tensor,
    up_hold: torch.Tensor, down_hold: torch.Tensor,
    *,
    renew_in_chunks: bool = False,
    planes: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """:func:`fsm_scan_ref` from predicted mode costs formed elsewhere (the
    card's, to hold the kernel to the plain gating on them).

    Window sums from a float64 ``torch.cumsum`` prefix
    (:func:`repro_torch.core.togglecci.window_sums`), then one
    :func:`repro_torch.fleet.policy._fsm_cascade` step per hour, vectorised
    over rows, with the hysteresis hold counters (hold 1 is the reactive
    rule). ``planes=(p_vpn, p_cci, margin)`` first turns the raw trigger
    planes into ``ForecastGatedPolicy.step``'s gated ones
    (``src/repro/fleet/policy.py:290-300``: each row's ``θ ± m`` formed
    once, then multiplied by the hour's predicted VPN cost). ``total_cost``
    is the last entry of a cumsum of the served costs, so on the CPU, where
    cumsum is sequential, every output equals the kernel's bit for bit.
    """
    from repro_torch.fleet.policy import _fsm_cascade

    tp = ToggleParams(theta1, theta2, h, D, T_cci)
    r_vpn = window_sums(vpn, h)
    r_cci = window_sums(cci, h)
    raw_req = r_cci < theta1[:, None] * r_vpn      # (N, T) trigger planes
    raw_rel = r_cci > theta2[:, None] * r_vpn
    if planes is not None:
        p_vpn, p_cci, m = planes
        raw_req, raw_rel = _gated_triggers(raw_req, raw_rel, theta1[:, None], theta2[:, None],
                                          p_vpn, p_cci, m[:, None])
    N, T = vpn.shape
    zero = torch.zeros(N, dtype=torch.int32, device=vpn.device)
    carry = (zero, zero)
    up, down = zero, zero
    xs, states = [], []
    for t in range(T):
        up = torch.where(raw_req[:, t], up + 1, 0)
        down = torch.where(raw_rel[:, t], down + 1, 0)
        req = raw_req[:, t] & (up >= up_hold)
        rel = raw_rel[:, t] & (down >= down_hold)
        carry, (x_t, s_t) = _fsm_cascade(tp, renew_in_chunks, carry, req, rel)
        xs.append(x_t)
        states.append(s_t)
    x = torch.stack(xs, dim=1)
    state = torch.stack(states, dim=1)
    served = torch.where(x == 1, cci.to(torch.float64), vpn.to(torch.float64))
    return {"x": x, "state": state, "total_cost": torch.cumsum(served, dim=1)[:, -1]}


def gate_masks_ref(p_vpn: torch.Tensor, p_cci: torch.Tensor, margin: torch.Tensor,
                   theta1: torch.Tensor, theta2: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.fsm_scan.gate_masks` from
    the (N, T) predicted mode costs: the four gate bits of every hour
    (``p_cci < (θ₁ − m)·p_vpn``, ``p_cci < (θ₁ + m)·p_vpn``,
    ``p_cci > (θ₂ + m)·p_vpn``, ``p_cci > (θ₂ − m)·p_vpn``, as
    :func:`_gated_triggers` forms them) packed into 64-bit masks a 64-hour
    tile, (N, ceil(T / 64), 4) int64."""
    m = margin[:, None]
    t1, t2 = theta1[:, None], theta2[:, None]
    bits = torch.stack([p_cci < (t1 - m) * p_vpn, p_cci < (t1 + m) * p_vpn,
                        p_cci > (t2 + m) * p_vpn, p_cci > (t2 - m) * p_vpn], dim=-1)
    N, T = p_vpn.shape
    n_tiles = -(-T // 64)
    bits = torch.nn.functional.pad(bits.to(torch.int64), (0, 0, 0, n_tiles * 64 - T))
    weight = torch.bitwise_left_shift(torch.ones(64, dtype=torch.int64, device=bits.device),
                                      torch.arange(64, device=bits.device))
    return (bits.view(N, n_tiles, 64, 4) * weight[:, None]).sum(dim=2)


def forecaster_scan_ref(
    u: torch.Tensor, a: torch.Tensor, one_minus_a: torch.Tensor, w: torch.Tensor,
    bias: torch.Tensor, h0: Optional[torch.Tensor] = None, *, write_y: bool = True,
    ckpt: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.forecaster.forecaster_scan`
    (``demand_forecaster_step`` under the JAX package's ``lax.scan``), any S.

    Hour by hour, ``h = a·h + (1−a)·u_t``, each product and the sum a torch op
    of its own (so rounded alone, as the kernel's ``_rn`` intrinsics are);
    the driving terms ``(1−a)·u_t`` of every hour are formed at once
    (elementwise, so with the same bits). The readout is elementwise too, so
    it runs over all hours after the scan: ``p_s = (h_s − u_t)·w_s``, folded
    left in index order from ``p_0``, then ``y = (u + acc) + bias``.
    Returns ``(y (N, T) or None, h (N, S))`` in float32. ``ckpt``, when
    given (``checkpoint_shape(N, T, S)``), receives the state before hour
    ``j · BWD_TILE`` in tile ``j``, as the walk passes it.
    """
    N, T = u.shape
    S = a.shape[0]
    h = (torch.zeros((N, S), dtype=torch.float32, device=u.device) if h0 is None
         else h0.clone())
    drive = one_minus_a * u[:, :, None]                  # (N, T, S)
    hs = torch.empty((N, T, S), dtype=torch.float32, device=u.device) if write_y else None
    for t in range(T):
        if ckpt is not None and t % BWD_TILE == 0:
            ckpt[t // BWD_TILE] = h
        h = a * h + drive[:, t]
        if write_y:
            hs[:, t] = h
    if not write_y:
        return None, h
    p = (hs - u[:, :, None]) * w
    acc = p[..., 0]
    for s in range(1, S):
        acc = acc + p[..., s]
    return (u + acc) + bias, h


def forecaster_scan_bwd_ref(
    u: torch.Tensor, dy: torch.Tensor, a: torch.Tensor, one_minus_a: torch.Tensor,
    w: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
    ckpt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.forecaster.forecaster_scan_bwd`
    (XLA autodiff of the forecaster's ``lax.scan`` in the JAX package), any S.

    The forward chain as :func:`forecaster_scan_ref` walks it, every state
    kept; then, hours backwards from T − 1 on (N, S) tensors, each product
    and sum a torch op of its own: ``lam = dy·w + a·lam``, ``dA += lam·h_{t−1}``,
    ``dB += lam·u``, ``dW += dy·(h − u)``, ``dbias += dy`` (from zeros; the
    elementwise products that need no ``lam`` formed for every hour at once,
    with the same bits); then each sum folded over the rows in index order,
    left from row 0. Returns ``(da (S,), d_one_minus_a (S,), dw (S,), dbias
    ())`` in float32, the gradients with respect to ``a``, ``1 − a``, ``w``
    and ``bias``. Given the forward's checkpoints ``ckpt`` (see
    :func:`forecaster_scan_ref`) instead of ``h0``, the walk starts from
    their first tile, ``h0``, and passes the others on its way.
    """
    N, T = u.shape
    S = a.shape[0]
    z = dict(dtype=torch.float32, device=u.device)
    if ckpt is not None:
        if h0 is not None:
            raise ValueError("forecaster_scan_bwd: ckpt's first tile is the forward's h0; "
                             "give ckpt or h0, not both")
        if T > 0:
            h0 = ckpt[0]
    h = torch.zeros((N, S), **z) if h0 is None else h0.clone()
    drive = one_minus_a * u[:, :, None]                  # (N, T, S)
    hs = torch.empty((N, T + 1, S), **z)                 # hs[:, t + 1] = h after hour t
    hs[:, 0] = h
    for t in range(T):
        h = a * h + drive[:, t]
        hs[:, t + 1] = h
    gw = dy[:, :, None] * w                              # dy·w
    dev_terms = dy[:, :, None] * (hs[:, 1:] - u[:, :, None])   # dy·(h − u)
    lam, dA, dB, dW = (torch.zeros((N, S), **z) for _ in range(4))
    db = torch.zeros((N,), **z)
    for t in range(T - 1, -1, -1):
        lam = gw[:, t] + a * lam
        dA = dA + lam * hs[:, t]
        dB = dB + lam * u[:, t, None]
        dW = dW + dev_terms[:, t]
        db = db + dy[:, t]
    rows = torch.cat([dA, dB, dW, db[:, None]], dim=1)  # (N, 3S + 1)
    if N == 0:
        acc = torch.zeros((3 * S + 1,), **z)
    else:
        acc = rows[0]
        for n in range(1, N):
            acc = acc + rows[n]
    return acc[:S], acc[S:2 * S], acc[2 * S:3 * S], acc[3 * S]


def tiered_cost_scan_ref(
    cum0: torch.Tensor, demand: torch.Tensor, bounds: torch.Tensor,
    rates: torch.Tensor, reset: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.tiered_cost_scan.tiered_cost_scan`:
    the TPU kernel's contract (``tiered_cost.py:225-242``). Carry the
    month-to-date volume through the K hour columns, zeroing it where
    ``reset[k] != 0``, and price each hour at the carry; returns ``(costs
    (N, K), cum_out (N,))`` in the inputs' float dtype. The carry is one add
    per hour in order, then one tier fold over the (N, K) plane (elementwise,
    so it rounds as a fold per hour would)."""
    lo = torch.empty_like(demand)
    cum = cum0
    zero = torch.zeros((), dtype=cum0.dtype, device=cum0.device)
    for k in range(demand.shape[1]):
        cum = torch.where(reset[k] != 0, zero, cum)
        lo[:, k] = cum
        cum = cum + demand[:, k]
    return tiered_marginal_cost_tables(lo, demand, bounds, rates), cum


def tiered_cost_calendar_ref(
    carry: torch.Tensor, demand: torch.Tensor, bounds: torch.Tensor,
    rates: torch.Tensor, t0: int, hours_per_month: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.tiered_cost_scan.tiered_cost_calendar`:
    the JAX runtime's billing calendar (``runtime.py:427-464``). ``carry``
    (2, N) holds ``dcum`` and ``dcum_month``; at every month start
    ``dcum_month`` takes ``dcum``, each hour is priced at ``dcum −
    dcum_month`` (the offline ``monthly_cumsum`` formula) and ``dcum`` adds
    the hour's volume. ``demand`` and the costs are hour-major (K, N).
    ``t0`` and ``hours_per_month`` are ints, or (N,) int32 tensors of one
    clock per row (the pooled chunks': each row starts its own months)."""
    dcum, month = carry[0], carry[1]
    lo = torch.empty_like(demand)
    per_row = torch.is_tensor(t0)
    for k in range(demand.shape[0]):
        if per_row:
            month = torch.where((t0 + k) % hours_per_month == 0, dcum, month)
        elif (t0 + k) % hours_per_month == 0:
            month = dcum
        lo[k] = dcum - month
        dcum = dcum + demand[k]
    costs = tiered_marginal_cost_tables(lo.T, demand.T, bounds, rates).T
    return costs.contiguous(), torch.stack([dcum, month])


def fsm_chunk_ref(
    vpn: torch.Tensor, cci: torch.Tensor, pre_v: torch.Tensor, pre_c: torch.Tensor,
    theta1: torch.Tensor, theta2: torch.Tensor,
    h: torch.Tensor, D: torch.Tensor, T_cci: torch.Tensor,
    up_hold: torch.Tensor, down_hold: torch.Tensor,
    carry: torch.Tensor, pref: torch.Tensor, t0: int,
    *,
    renew_in_chunks: bool = False,
    gate: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
    live: Optional[tuple] = None,
) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.fsm_scan.fsm_chunk`: K
    hours of the FSM from a carry, on hour-major (K, M) planes.

    The prefix snapshots first (``snap[k]`` is the prefix before hour
    ``t0 + k``, added in order from ``pref``), then the window sums
    ``snap[k] − pref[lo]`` with ``lo = max(0, t0 + k − h)`` read from the
    snapshots when ``lo ≥ t0`` and from the host's ring reads ``pre_v``/
    ``pre_c`` otherwise (``runtime.py:501-515``), then one
    :func:`repro_torch.fleet.policy._fsm_cascade` step per hour with the
    hold counters, as :func:`fsm_scan_ref` steps. ``gate=(p_vpn, p_cci,
    margin)``, the chunk's (K, M) predicted mode costs and the (M,) margins,
    gates the raw triggers (:func:`_gated_triggers`) for the streaming
    chunks' forecast-gated instances; the ``fsm_chunk`` kernel has none.
    ``t0`` is an int, or an (M,) int32 tensor of one first hour per row (the
    pooled chunks').

    ``live=(d_row, h, pred, a, 1 − a, w, bias, scale, cost_coef, margin)``
    runs the chunks' live instances instead (``src/repro/fleet/runtime.py:541-575``):
    ``d_row`` (K, M) the hours' clipped row demand, ``h`` (M, S) float32 the
    forecaster's state and ``pred`` (M,) float64 the forecast carried into
    the chunk. Each hour, in order: the predicted mode costs of ``pred``
    (:func:`repro_torch.fleet.policy.predicted_mode_costs`, the call the
    replay planes come from) gate the hour's raw triggers, the FSM steps,
    then ``u = log1p(float32(d_row / scale))`` steps the forecaster
    (:func:`forecaster_scan_ref` with T = 1) and ``pred = maximum(expm1(y),
    0)·scale``. The result then also holds ``pred`` (K, M), the forecast
    made after each hour, and ``h``, the state after the chunk.
    """
    from repro_torch.fleet.policy import _fsm_cascade, predicted_mode_costs

    K, M = vpn.shape
    tp = ToggleParams(theta1, theta2, h, D, T_cci)
    snap_v, snap_c = torch.empty_like(vpn), torch.empty_like(cci)
    pv, pc = pref[0], pref[1]
    for k in range(K):
        snap_v[k], snap_c[k] = pv, pc
        pv, pc = pv + vpn[k], pc + cci[k]
    ks = torch.arange(K, device=vpn.device)
    t0r = t0[None, :].long() if torch.is_tensor(t0) else t0        # a row's clock
    lo = torch.clamp(t0r + ks[:, None] - h[None, :].long(), min=0)  # (K, M)
    in_chunk = lo >= t0r
    jj = torch.clamp(lo - t0r, 0, K - 1)
    r_vpn = snap_v - torch.where(in_chunk, snap_v.gather(0, jj), pre_v)
    r_cci = snap_c - torch.where(in_chunk, snap_c.gather(0, jj), pre_c)
    raw_req = r_cci < theta1[None, :] * r_vpn
    raw_rel = r_cci > theta2[None, :] * r_vpn
    if gate is not None:
        p_vpn, p_cci, m = gate
        raw_req, raw_rel = _gated_triggers(raw_req, raw_rel, theta1[None, :], theta2[None, :],
                                          p_vpn, p_cci, m[None, :])
    if live is not None:
        d_row, h_ssm, pred, a, oma, w, bias, scale, coef, margin = live
        f64 = torch.float64
        zero = torch.zeros((), dtype=f64, device=vpn.device)
        preds = []
    state, t_state, up, down = carry
    xs, states = [], []
    for k in range(K):
        rq, rl = raw_req[k], raw_rel[k]
        if live is not None:
            p_vpn, p_cci = predicted_mode_costs(pred[:, None], coef, f64)
            rq, rl = _gated_triggers(rq, rl, theta1, theta2, p_vpn[:, 0], p_cci[:, 0], margin)
        up = torch.where(rq, up + 1, 0)
        down = torch.where(rl, down + 1, 0)
        req = rq & (up >= up_hold)
        rel = rl & (down >= down_hold)
        (state, t_state), (x_k, s_k) = _fsm_cascade(
            tp, renew_in_chunks, (state, t_state), req, rel)
        xs.append(x_k)
        states.append(s_k)
        if live is not None:
            u = torch.log1p((d_row[k] / scale).to(torch.float32))
            y, h_ssm = forecaster_scan_ref(u[:, None], a, oma, w, bias, h_ssm)
            pred = torch.maximum(torch.expm1(y[:, 0].to(f64)), zero) * scale
            preds.append(pred)
    i32 = torch.int32
    out = {
        "x": torch.stack(xs).to(i32), "state": torch.stack(states).to(i32),
        "r_vpn": r_vpn, "r_cci": r_cci, "snap_v": snap_v, "snap_c": snap_c,
        "carry": torch.stack([state, t_state, up, down]).to(i32),
        "pref": torch.stack([pv, pc]),
    }
    if live is not None:
        out.update(pred=torch.stack(preds), h=h_ssm)
    return out


def _split_block(block: torch.Tensor, K: int, P: int, M: int, endo: bool,
                 pair_major: bool = False):
    """The runtime's packed chunk block as views: demand (K, P), the CCI
    demand (K, P) or None, then the window reads pre_v, pre_c (K, M). With
    ``pair_major`` (topology mode) the block holds the demand planes (P, K);
    they come back transposed, (K, P) all the same."""
    if block.shape != (block_size(K, M, endo, P),):
        raise ValueError(f"stream chunk block: want ({block_size(K, M, endo, P)},), "
                         f"got {tuple(block.shape)}")
    nd = (2 if endo else 1) * K * P
    plane = (lambda x: x.view(P, K).T) if pair_major else (lambda x: x.view(K, P))
    cci = plane(block[K * P:nd]) if endo else None
    return (plane(block[:K * P]), cci, block[nd:nd + K * M].view(K, M),
            block[nd + K * M:].view(K, M))


def _chunk_pair_half(demand, cci_demand, capacity, L_vpn, bounds, rates, cal, t0: int,
                     hours_per_month: int):
    """The chunk's per-row pricing (``runtime.py:417-464``): clip the demand
    (and the CCI demand) at the capacity with ``torch.minimum``, price it on
    the billing calendar (:func:`tiered_cost_calendar_ref`) and add the VPN
    lease. Returns ``(d_pair, d_cci, vpn (K, rows), calendar carry (2,
    rows))``: the clipped demand, the clipped CCI demand (``d_pair`` itself
    without one), the VPN plane and the carry."""
    cap = capacity[None, :]
    d_pair = torch.minimum(demand, cap)
    d_cci = d_pair if cci_demand is None else torch.minimum(cci_demand, cap)
    transfer, cal_out = tiered_cost_calendar_ref(cal, d_pair, bounds, rates, t0,
                                                 hours_per_month)
    return d_pair, d_cci, L_vpn[None, :] + transfer, cal_out


def _gate_columns(gate, t0: int, K: int):
    """The chunk's gate from the runtime's ``(p_vpn, p_cci, margin, T_pred)``
    (hour-major (T_pred, M) predicted-cost planes, (M,) margins): the (K, M)
    rows of hours ``min(t0 + k, T_pred − 1)`` (the JAX runtime's clipped
    column index, ``src/repro/fleet/runtime.py:519-521``) and the margins;
    None for None. With an (M,) tensor ``t0`` each row reads its own hours
    (the pooled chunks', whose planes are edge-replicated to ``T_pred``)."""
    if gate is None:
        return None
    p_vpn, p_cci, margin, T_pred = gate
    ks = torch.arange(K, device=p_vpn.device)
    if torch.is_tensor(t0):
        hours = torch.clamp(t0[None, :].long() + ks[:, None], max=T_pred - 1)   # (K, M)
        return p_vpn.gather(0, hours), p_cci.gather(0, hours), margin
    hours = torch.clamp(t0 + ks, max=T_pred - 1)
    return p_vpn[hours], p_cci[hours], margin


def _chunk_port_half(vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold,
                     down_hold, fsm, pref, t0: int, renew_in_chunks: bool, gate=None,
                     live=None, d_row=None):
    """The chunk's per-decision-row half on its (K, M) cost planes:
    :func:`fsm_chunk_ref`, its raw triggers gated by the predicted costs
    when ``gate`` (:func:`_gate_columns`) is given, or by the live forecast
    stepped on ``d_row`` (K, M) when ``live`` (the chunk wrappers' tuple) is.
    Returns the (8, K, M) float64 planes (vpn, cci, r_vpn, r_cci, snap_v,
    snap_c, x, state; a ninth, pred, in live mode), the prefixes after the
    chunk (2, M), the FSM carry (4, M) int32 and, in live mode, the
    forecaster's state after the chunk (else None)."""
    out = fsm_chunk_ref(vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold,
                        down_hold, fsm, pref, t0, renew_in_chunks=renew_in_chunks,
                        gate=_gate_columns(gate, t0, vpn.shape[0]),
                        live=None if live is None else (d_row, *live))
    f64 = torch.float64
    planes = [vpn, cci, out["r_vpn"], out["r_cci"], out["snap_v"], out["snap_c"],
              out["x"].to(f64), out["state"].to(f64)]
    if live is not None:
        planes.append(out["pred"])
    return torch.stack(planes), out["pref"], out["carry"], out.get("h")


def _chunk_result(result: torch.Tensor, carry: torch.Tensor, h_out):
    """A chunk's return: ``(result, FSM carry)``, and the forecaster's state
    after the chunk in live mode."""
    return (result, carry) if h_out is None else (result, carry, h_out)


def stream_chunk_ref(
    block: torch.Tensor, K: int, endo: bool,
    capacity: torch.Tensor, L_vpn: torch.Tensor, lease_cci: torch.Tensor,
    c_cci: torch.Tensor, bounds: torch.Tensor, rates: torch.Tensor,
    theta1: torch.Tensor, theta2: torch.Tensor,
    h: torch.Tensor, D: torch.Tensor, T_cci: torch.Tensor,
    up_hold: torch.Tensor, down_hold: torch.Tensor,
    cal: torch.Tensor, fsm: torch.Tensor, pref: torch.Tensor,
    t0: Optional[int] = None, hours_per_month: Optional[int] = None,
    *,
    renew_in_chunks: bool = False,
    gate=None,
    live=None,
    clocks=None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`repro_torch.kernels.stream_chunk.stream_chunk`:
    the streaming runtime's chunk in fleet mode (``runtime.py:405-577``).

    The flat ``block`` holds the demand (and, when ``endo``, the CCI demand)
    hour-major (K, M), then the host's window reads ``pre_v``/``pre_c`` (K, M).
    Clip at the capacity with ``torch.minimum``, price on the billing calendar
    (:func:`tiered_cost_calendar_ref`), build the VPN plane and the CCI plane
    (product, then sum: two roundings, never ``addcmul``), run
    :func:`fsm_chunk_ref`, and pack. Returns the (8K + 4, M) float64 result
    (vpn, cci, r_vpn, r_cci, snap_v, snap_c, x, state, K rows each, then dcum,
    dcum_month, vpn_pref, cci_pref) and the FSM carry (4, M) int32.
    ``gate=(p_vpn, p_cci, margin, T_pred)`` runs the forecast-gated
    instance: the hour-major (T_pred, M) predicted mode costs, read at hour
    ``min(t0 + k, T_pred − 1)``, gate the raw triggers (:func:`_gated_triggers`).
    ``live=(h, pred, a, 1 − a, w, bias, scale, cost_coef, margin)`` runs the
    live instance (:func:`fsm_chunk_ref`'s ``live``, its ``d_row`` the
    clipped demand): the result is then (9K + 4, M), the pred plane after
    the state plane, and the forecaster's state after the chunk (M, S)
    float32 comes third.

    The pooled instance (the gateway's, no live mode): ``clocks=(t0,
    hours_per_month)``, (M,) int32 tensors in place of the ints, one clock
    per row; each row's calendar, window bases and gate columns follow its
    own clock, and a ``gate``'s ``T_pred`` is the pool's column count.
    """
    M = capacity.shape[0]
    _, t0, hpm, _ = chunk_clocks("stream_chunk", t0, hours_per_month, clocks, live)
    demand, cci_demand, pre_v, pre_c = _split_block(block, K, M, M, endo)
    d_pair, d_cci, vpn, cal_out = _chunk_pair_half(demand, cci_demand, capacity, L_vpn,
                                                   bounds, rates, cal, t0, hpm)
    cci = lease_cci[None, :] + c_cci[None, :] * d_cci
    planes, pref_out, carry, h_out = _chunk_port_half(
        vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold, down_hold, fsm, pref,
        t0, renew_in_chunks, gate, live, d_pair)
    return _chunk_result(torch.cat([planes.reshape(-1, M), cal_out, pref_out]), carry, h_out)


def stream_chunk_routed_ref(
    block: torch.Tensor, K: int, endo: bool,
    pair_capacity: torch.Tensor, L_vpn: torch.Tensor, bounds: torch.Tensor,
    rates: torch.Tensor, lease_cci: torch.Tensor, c_cci: torch.Tensor,
    port_capacity: torch.Tensor, theta1: torch.Tensor, theta2: torch.Tensor,
    h: torch.Tensor, D: torch.Tensor, T_cci: torch.Tensor,
    up_hold: torch.Tensor, down_hold: torch.Tensor, routing,
    cal: torch.Tensor, fsm: torch.Tensor, pref: torch.Tensor,
    t0: Optional[int] = None, hours_per_month: Optional[int] = None,
    *,
    renew_in_chunks: bool = False,
    gate=None,
    live=None,
    clocks=None,
) -> Tuple[torch.Tensor, ...]:
    """Plain version of :func:`repro_torch.kernels.stream_chunk.stream_chunk_routed`:
    the streaming runtime's chunk in topology mode (``runtime.py:391-515``
    with ``topology=True``).

    The block holds the demand (and the CCI demand) per PAIR, pair-major
    (P, K), then the window reads per PORT, (K, M). Each pair is clipped and
    priced on its billing calendar as :func:`stream_chunk_ref` prices a link;
    then, hour by
    hour, the pairs fold onto the ports over the routing's padded leg list in
    leg order (:func:`leg_segment_sum_ref`): ``vpn = seg(vpn_pair[lp]·vpn_w)``
    and ``d_bill = minimum(seg(d_cci[lp]·attach_w), port_capacity)``; the CCI
    plane is ``lease_cci + c_cci·d_bill`` (``lease_cci = L_cci +
    V_cci·n_attach``, summed once per routing). The port half is
    :func:`stream_chunk_ref`'s, gated as there when ``gate`` (per port) is
    given. Returns the flat float64 result (the 8 (K, M) planes, then dcum,
    dcum_month (P each), vpn_pref, cci_pref (M each)) and the FSM carry (4,
    M) int32. ``live`` (per port) runs the live instance as
    :func:`stream_chunk_ref` does, its ``d_row`` the clipped pair demand
    folded onto the ports with ``attach_w`` in leg order, then
    ``minimum``'d with ``port_capacity`` (``src/repro/fleet/runtime.py:485-488``;
    with endogenous demand the VPN-path demand, not the CCI demand the bill
    folds): a ninth (K, M) plane and the state come back as there.

    The pooled instance: ``clocks=(t0_port (M,), hours_per_month (P,),
    t0_pair (P,))``, int32 tensors in place of the ints: each pair's
    calendar follows its own clock, each port's window bases and gate
    columns its port's.
    """
    P, M = pair_capacity.shape[0], lease_cci.shape[0]
    t0_pair, t0, hpm, _ = chunk_clocks("stream_chunk_routed", t0, hours_per_month, clocks,
                                       live)
    demand, cci_demand, pre_v, pre_c = _split_block(block, K, P, M, endo, pair_major=True)
    d_pair, d_cci, vpn_pair, cal_out = _chunk_pair_half(
        demand, cci_demand, pair_capacity, L_vpn, bounds, rates, cal, t0_pair, hpm)
    lp, lm = routing.leg_pair, routing.leg_port
    seg = lambda plane, w: leg_segment_sum_ref(plane.T, lp, lm, w, M).T    # (K, M)
    vpn = seg(vpn_pair, routing.vpn_w)
    cap = port_capacity[None, :]
    d_bill = torch.minimum(seg(d_cci, routing.attach_w), cap)
    cci = lease_cci[None, :] + c_cci[None, :] * d_bill
    d_row = None
    if live is not None:
        d_row = d_bill if cci_demand is None else torch.minimum(seg(d_pair, routing.attach_w),
                                                                cap)
    planes, pref_out, carry, h_out = _chunk_port_half(
        vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold, down_hold, fsm, pref,
        t0, renew_in_chunks, gate, live, d_row)
    flat = torch.cat([planes.reshape(-1), cal_out.reshape(-1), pref_out.reshape(-1)])
    return _chunk_result(flat, carry, h_out)


def leg_segment_sum_ref(src: torch.Tensor, leg_pair: torch.Tensor, leg_port: torch.Tensor,
                        w: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.leg_segment_sum.leg_segment_sum`
    for one plane: the legs in order, ``out[lm[e]] += src[lp[e]] * w[e]``,
    from +0.0 (one IEEE product and one add a leg and hour, as the kernel and
    XLA's sequential scatter-add)."""
    out = torch.zeros((num_segments,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    for e, (i, m) in enumerate(zip(leg_pair.tolist(), leg_port.tolist())):
        out[m] += src[i] * w[e]
    return out


def oracle_dp_ref(vpn: torch.Tensor, cci: torch.Tensor, D: torch.Tensor,
                  T_cci: torch.Tensor, *, allow_head_start: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.oracle_dp.oracle_dp`:
    every row's offline-optimal DP (:func:`repro_torch.core.oracle.offline_optimal`'s
    backward pass) at once, over (N, S_max) states with per-row index maps,
    in a Python loop over the hours backwards. Each hour is one IEEE add a
    state, the same adds as the numpy DP's; the OFF and ON-free choices are
    its ``req < stay`` and ``stay_on <= release`` (false on NaN). A row's
    states past its own ``D + T_cci + 2`` are padding no real state reads.
    Returns ``(total (N,) float64, start_on (N,) bool)``."""
    N, T = vpn.shape
    dev = vpn.device
    if N == 0:
        return (torch.empty(0, dtype=torch.float64, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev))
    Dc = D.long()[:, None]
    Tc = T_cci.long()[:, None]
    on0, on_free = Dc + 1, Dc + Tc + 1
    on_fresh = on0 + Tc - 1
    s = torch.arange(int(on_free.max()) + 1, device=dev)[None, :]
    # Each state's chain step reads one state of the next hour: WAITING j from
    # j - 1 (1 from fresh ON), ON j from j - 1 (1 from ON free); OFF and ON
    # free read themselves (their "stay"), padding reads OFF.
    src = torch.where(s <= Dc, torch.where(s == 1, on_fresh, s - 1),
                      torch.where(s == on0, on_free, s - 1))
    src = torch.where((s == 0) | (s > on_free), 0, torch.where(s == on_free, on_free, src))
    serve_cci = (s > Dc) & (s <= on_free)
    req_next = torch.where(Dc > 1, Dc - 1, torch.where(
        Dc == 1, on_fresh, torch.where(Tc > 1, on0 + Tc - 2, on_free)))
    req_cci = Dc == 0
    V = torch.zeros(src.shape, dtype=torch.float64, device=dev)
    for t in range(T - 1, -1, -1):
        cv, cc = vpn[:, t:t + 1], cci[:, t:t + 1]
        nV = torch.where(serve_cci, cc, cv) + V.gather(1, src)
        stay = nV[:, :1].clone()            # vpn + V[OFF], also ON free's release
        req = torch.where(req_cci, cc, cv) + V.gather(1, req_next)
        stay_on = nV.gather(1, on_free)
        nV[:, :1] = torch.where(req < stay, req, stay)
        nV.scatter_(1, on_free, torch.where(stay_on <= stay, stay_on, stay))
        V = nV
    off, on = V[:, 0], V.gather(1, on_free)[:, 0]
    start_on = (on < off) & bool(allow_head_start)
    return torch.where(start_on, on, off), start_on


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, Dv)
    *,
    causal: bool = True,
    window: int = 0,          # sliding-window size; 0 = unlimited
    q_offset: int = 0,        # global position of q[0]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.flash_attention.flash_attention`
    (port of ``repro.kernels.ref.attention``): full float32 softmax over the
    materialised (Sq, Skv) scores, GQA by repeating K/V per query head,
    causal and sliding-window masks from global positions; rows with no
    valid key come out 0. Output in q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    assert Hq % Hkv == 0
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    kr = torch.repeat_interleave(k, group, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) * scale
    rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(-1)[:, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.rmsnorm.rmsnorm`:
    ``x·rsqrt(mean(x²)+eps)·w`` per row in float32, cast to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(torch.float32)).to(x.dtype)


def int8_quantize(x: torch.Tensor, *, guard: str = "pallas"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.int8_quant.int8_quantize`:
    per-row symmetric int8 in float32, ``q = clamp(round(x / scale), -127,
    127)`` rounding half to even; returns ``(q (N, d) int8, scale (N, 1)
    float32)``. ``guard="pallas"`` is ``scale = max(amax, 1e-30) / 127``
    (port of ``repro.kernels.ref.int8_quantize``); ``guard="collectives"``
    is ``scale = max(amax / 127, 1e-30)`` (port of
    ``repro.dist.collectives._quantize``, whose unclipped round the clip
    leaves unchanged). A row that holds NaN gets scale NaN, one that holds
    ±inf scale inf, and both q = 0 where ``x / scale`` is NaN, as XLA's
    float-to-int convert gives."""
    if guard not in ("pallas", "collectives"):
        raise ValueError(f"guard must be 'pallas' or 'collectives', got {guard!r}")
    if x.ndim != 2:
        raise ValueError(f"int8_quantize takes (N, d), got {tuple(x.shape)}")
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # Divide by a tensor, not the Python number: on CUDA PyTorch turns a
    # division by a CPU scalar into a product with its reciprocal, which
    # rounds differently from the true division of the kernel and the CPU.
    c127 = torch.full_like(amax, 127.0)
    if guard == "pallas":
        scale = amax.clamp_min(1e-30) / c127
    else:
        scale = (amax / c127).clamp_min(1e-30)
    # amax and clamp propagate NaN; the int8 cast of NaN is left undefined by
    # PyTorch, so NaN is set to 0 first, on every device alike.
    q = torch.round(xf / scale).clamp(-127, 127).nan_to_num(nan=0.0).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.int8_quant.int8_dequantize`:
    ``q · scale`` in float32, cast to ``dtype``."""
    return (q.to(torch.float32) * scale).to(dtype)


def tiered_cost(month_cum: torch.Tensor, demand: torch.Tensor,
                bounds: Sequence[float], rates: Sequence[float]) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.tiered_cost.tiered_cost`:
    the Pallas ``_tiered_kernel``'s left fold over one static tier table in
    float32, ``total = total + clip(min(hi, b) - max(lo, prev), 0) · rate``
    (an infinite bound is ``1e30``). The JAX ``ref.tiered_cost`` sums over a
    tier axis instead, so it agrees to rounding, not bit for bit."""
    bounds, rates = tier_table(bounds, rates)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=month_cum.device)
    lo = month_cum.to(torch.float32)
    hi = lo + demand.to(torch.float32)
    total = torch.zeros_like(lo)
    prev = f32(0.0)
    for b, r in zip(bounds, rates):
        b = f32(b)
        seg = (torch.minimum(hi, b) - torch.maximum(lo, prev)).clamp_min(0.0)
        total = total + seg * f32(r)
        prev = b
    return total


def moe_scores_ref(logits: torch.Tensor, router: str = "softmax") -> torch.Tensor:
    """The router's scores of (G, N, E) float32 logits: softmax over the
    experts, or the sigmoid (``src/repro/models/ffn.py:84``, ``:89``)."""
    check_router(router)
    return torch.sigmoid(logits) if router == "sigmoid" else torch.softmax(logits, dim=-1)


def moe_decide_ref(probs: torch.Tensor, top_k: int, capacity: int, *, router: str = "softmax",
                   aux_coef: float = 0.0) -> MoERouting:
    """The decisions of :func:`moe_route_ref` from given (G, N, E) scores:
    the top-k by a stable descending sort (equal scores: the lower expert
    first, as ``jax.lax.top_k``), ``gate_w`` the top scores over their sum
    taken in choice order (at least 1e-9), each slot's position from the
    in-order one-hot cumsum of ``src/repro/models/ffn.py:95-100`` (slots
    token-major, then choice), ``keep = pos < capacity``, the capacity map
    and the Switch aux loss (``:87-92``) over the first choices."""
    G, N, E = probs.shape
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, gate_idx = vals[..., :top_k], idx[..., :top_k]
    s = top[..., 0]
    for j in range(1, top_k):
        s = s + top[..., j]
    gate_w = top / s.clamp_min(1e-9)[..., None]
    slot_e = gate_idx.reshape(G, N * top_k)
    onehot = torch.nn.functional.one_hot(slot_e, E).to(torch.int32)
    pos = (onehot.cumsum(1) - onehot).gather(2, slot_e[..., None])[..., 0].to(torch.int32)
    keep = pos < capacity
    src = torch.full((G, E, capacity), -1, dtype=torch.int32, device=probs.device)
    g, sl = keep.nonzero(as_tuple=True)
    src[g, slot_e[g, sl], pos[g, sl].long()] = sl.to(torch.int32)
    scale = aux_scale(router, aux_coef, E)
    if router == "sigmoid":
        aux = torch.zeros((G,), dtype=torch.float32, device=probs.device)
    else:
        density = torch.nn.functional.one_hot(gate_idx[..., 0], E).to(torch.float32).mean(1)
        aux = scale * (density * probs.mean(1)).sum(-1)
    return MoERouting(probs, gate_idx.to(torch.int32), gate_w, pos, keep, src, aux)


def moe_route_ref(logits: torch.Tensor, top_k: int, capacity: int, *, router: str = "softmax",
                  aux_coef: float = 0.0) -> MoERouting:
    """Plain version of :func:`repro_torch.kernels.moe.moe_route`:
    :func:`moe_decide_ref` of :func:`moe_scores_ref`."""
    return moe_decide_ref(moe_scores_ref(logits.to(torch.float32), router), top_k, capacity,
                          router=router, aux_coef=aux_coef)


def moe_dispatch_ref(x: torch.Tensor, src: torch.Tensor, top_k: int) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.moe.moe_dispatch`: the
    (E, G, C, d) buffer whose row (e, g, c) is ``x[g, src // top_k]``, zeros
    where ``src < 0``. It holds what the reference's scatter-add into zeros
    holds (``src/repro/models/ffn.py:110-115``; at most one kept slot lands
    on a row, a dropped one adds zeros)."""
    G = x.shape[0]
    tok = (src.clamp_min(0) // top_k).long()
    rows = x[torch.arange(G, device=x.device)[:, None, None], tok]          # (G, E, C, d)
    rows = torch.where((src >= 0)[..., None], rows, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))
    return rows.transpose(0, 1).contiguous()


def moe_combine_ref(out: torch.Tensor, gate_idx: torch.Tensor, pos: torch.Tensor,
                    keep: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.moe.moe_combine`
    (``src/repro/models/ffn.py:128-131``): ``w = (gate_w · keep)`` in out's
    dtype, each slot's row ``out[e, g, min(pos, C - 1)] · w`` rounded to that
    dtype, summed over the k choices in order in float32 and rounded once."""
    E, G, C, d = out.shape
    _, N, k = gate_idx.shape
    g = torch.arange(G, device=out.device)[:, None, None]
    rows = out[gate_idx.long(), g, pos.reshape(G, N, k).clamp_max(C - 1).long()]   # (G, N, k, d)
    w = (gate_w * keep.reshape(G, N, k)).to(out.dtype)
    acc = torch.zeros((G, N, d), dtype=torch.float32, device=out.device)
    for j in range(k):
        acc = acc + (rows[:, :, j] * w[:, :, j, None]).to(torch.float32)
    return acc.to(out.dtype)
