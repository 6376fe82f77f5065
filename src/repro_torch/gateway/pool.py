"""Tenant packing: capacity buckets, inert padding, pooled device operands.

Port of :mod:`repro.gateway.pool`. A gateway pool stacks the operands of
many tenant runtimes along the row axis, one run of rows per SLOT, shaped so
that ONE call of the pooled chunk kernel (``stream_chunk`` or
``stream_chunk_routed`` with per-row clocks, :mod:`repro_torch.kernels.stream_chunk`)
serves every tenant of the bucket, whatever each tenant's real size, and so
that membership churn never changes a shape. Two mechanisms make that work:

**Capacity bucketing.** Tenants are grouped by a :class:`BucketKey`: the
padded row/pair capacities (next power of two), the padded leg bound, the
exact tier depth ``K``, the policy's class and ``renew_in_chunks``, and the
forecast-replay column capacity. Everything in the key fixes a launch shape;
everything not in it (thresholds, windows, prices, routings, calendars,
demand) is operand data or host state, so any two tenants sharing a key
share one pool and one launch. ``K`` is exact, not padded: the tier fold's
rounding depends on the table depth.

**Inert padding.** Padded rows are frozen FSMs: ``θ₁ = θ₂ = 1`` over zero
window costs makes the reactive/hysteresis triggers compare ``0 < 0`` /
``0 > 0`` (both false), and a zero ``cost_coef`` with zero margin makes the
forecast gates compare ``exp(0)`` with ``1·exp(0)`` (false both ways), so
padded FSMs stay OFF, add zero to every cost and volume sum, and touch no
real tenant's counters (the realized-cost histogram's zero bin, which counts
them, is corrected at drain: :mod:`repro_torch.gateway.gateway`). Padded
routing LEGS point at an inert (pad pair, pad port) slot with zero weights
and padded PAIRS carry no legs, so the pooled leg fold sees each real port's
legs in the standalone leg order.

Forecast ``pred_demand`` columns are padded by EDGE-REPLICATING the last
column: the pooled gate reads column ``min(t + k, pred_cap − 1)``, which is
the standalone runtime's ``min(t + k, T_pred − 1)``, and the predicted mode
costs are elementwise, so the bits agree.

The pool's device layout is flat: slot ``s`` holds rows ``s·cap .. (s +
1)·cap − 1`` of every pooled tensor (:func:`stack_slots`, :func:`set_slot`),
as the chunk kernels take one flat row axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.togglecci import ToggleParams
from repro_torch.fleet.policy import (
    ForecastGatedPolicy,
    HysteresisPolicy,
    ReactivePolicy,
    predicted_mode_costs,
)
from repro_torch.fleet.routing import RoutingOperand, RoutingPlan, padded_operand_np
from repro_torch.fleet.runtime import ResolvedRuntime
from repro_torch.fleet.spec import PAD_BOUND, FleetArrays
from repro_torch.fleet.topology import TopologyArrays

_LIVE = ("live SSM forecasting is not poolable (per-tenant carried forecaster "
         "state defeats the shared mega-tick); stream forecast tenants in "
         "replay mode, or standalone")


def ceil_pow2(n: int) -> int:
    """The smallest power of two ≥ n (≥ 1)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"ceil_pow2: {n} < 1")
    return 1 << (n - 1).bit_length()


#: Minimum pooled prefix-ring depth (hours). A ring only costs host memory
#: (rows_cap x hbuf float64 per slot), so quantizing every tenant up to one
#: generous depth trades kilobytes for pool consolidation.
HBUF_FLOOR = 512


class BucketKey(NamedTuple):
    """Everything that fixes a pool's launch shapes and host layout.

    Two tenants share a bucket iff their keys are equal. ``policy_class``
    and ``renew_in_chunks`` stand for the reference's policy treedef (its
    kind and static knob), so mixed-kind tenants never share a pool.
    ``hbuf_cap`` (the prefix-ring depth, ``max(pow2(max(h) + 1),
    HBUF_FLOOR)``) shapes only HOST state and is left out of
    :meth:`compile_key`.
    """

    topology: bool
    rows_cap: int        # decision rows (ports/links), padded
    pairs_cap: int       # demand rows (pairs; == rows_cap in fleet mode)
    legs_cap: int        # padded routing-leg bound (0 in fleet mode)
    n_tiers: int         # EXACT tier depth K (never padded cross-tenant)
    policy_class: type
    renew_in_chunks: bool
    pred_source: Optional[str]   # None | "replay" (live is not poolable)
    pred_cap: int        # replay pred_demand column capacity (0 when unused)
    hbuf_cap: int        # host prefix-ring depth (pow2)

    def compile_key(self, *, n_slots: int, obs: bool, chunk: int = 1) -> tuple:
        """The launch shape a bucket of this key prepares for a chunk of
        ``chunk`` hours (a ``tick()`` is ``chunk=1``). The reference keys a
        drain variant too; the port's ring is host work, so a drain hour
        launches the same shape."""
        return (self.topology, self.rows_cap, self.pairs_cap, self.legs_cap,
                self.n_tiers, self.policy_class, self.renew_in_chunks, self.pred_source,
                self.pred_cap, n_slots, obs, int(chunk))


@dataclasses.dataclass(frozen=True)
class PackedTenant:
    """One tenant's operands padded to bucket capacity, ready for a slot."""

    key: BucketKey
    arrays: object                     # padded FleetArrays / TopologyArrays (the
                                       # topology routing field is not read)
    policy: object                     # padded policy (rows_cap rows)
    routing: Optional[RoutingOperand]  # numpy-field leg operand padded to
                                       # (legs_cap, pairs_cap), topology only
    gate: Optional[tuple]              # replay: (p_vpn, p_cci) (pred_cap, rows_cap)
                                       # hour-major predicted mode costs
    h_np: np.ndarray                   # (rows_cap,) int64 padded window lengths
    hours_per_month: int
    n_rows: int                        # real decision rows
    n_pairs: int                       # real demand rows


def _pad_rows(x: torch.Tensor, cap: int, value) -> torch.Tensor:
    """Pad the leading axis to ``cap`` with a constant fill."""
    n = x.shape[0]
    if n > cap:
        raise ValueError(f"{n} rows over the capacity {cap}")
    if n == cap:
        return x
    fill = torch.full((cap - n,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill])


def _pad_toggle(tp: ToggleParams, cap: int) -> ToggleParams:
    """Inert FSM rows: θ₁ = θ₂ = 1 over zero window costs never fires."""
    return ToggleParams(
        theta1=_pad_rows(tp.theta1, cap, 1.0),
        theta2=_pad_rows(tp.theta2, cap, 1.0),
        h=_pad_rows(tp.h, cap, 1),
        D=_pad_rows(tp.D, cap, 0),
        T_cci=_pad_rows(tp.T_cci, cap, 1),
    )


def _pad_pred(pred: torch.Tensor, rows_cap: int, pred_cap: int) -> torch.Tensor:
    """(rows, T) → (rows_cap, pred_cap): zero rows, edge-replicated columns
    (the standalone replay's clamped column index)."""
    t = pred.shape[1]
    if not 1 <= t <= pred_cap:
        raise ValueError(f"pred_demand of {t} columns against the capacity {pred_cap}")
    cols = torch.cat([pred, pred[:, -1:].expand(-1, pred_cap - t)], dim=1)
    return _pad_rows(cols, rows_cap, 0.0)


def _pad_policy(policy, rows_cap: int, pred_cap: int):
    """Pad a policy's per-row fields to bucket capacity with values that keep
    the padded FSMs inert (module docstring)."""
    if isinstance(policy, ReactivePolicy):
        return policy._replace(toggle=_pad_toggle(policy.toggle, rows_cap))
    if isinstance(policy, HysteresisPolicy):
        return policy._replace(
            toggle=_pad_toggle(policy.toggle, rows_cap),
            up_hold=_pad_rows(policy.up_hold, rows_cap, 1),
            down_hold=_pad_rows(policy.down_hold, rows_cap, 1),
        )
    if isinstance(policy, ForecastGatedPolicy):
        if policy.cost_coef is None:
            raise ValueError("a pooled ForecastGatedPolicy needs its cost_coef")
        return policy._replace(
            toggle=_pad_toggle(policy.toggle, rows_cap),
            margin=_pad_rows(policy.margin, rows_cap, 0.0),
            pred_demand=_pad_pred(policy.pred_demand, rows_cap, pred_cap),
            cost_coef=_pad_rows(policy.cost_coef, rows_cap, 0.0),
        )
    raise TypeError(
        f"cannot pool policy type {type(policy).__name__}: the gateway "
        "pads reactive/hysteresis/forecast policies only"
    )


def bucket_key_for(resolved: ResolvedRuntime) -> BucketKey:
    """Derive the capacity bucket of one resolved tenant runtime. A
    live-mode tenant raises ``ValueError`` (the reference's text)."""
    if resolved.pred_source == "live":
        raise ValueError(_LIVE)
    arrays = resolved.arrays
    k = arrays.tier_bounds.shape[1]
    if resolved.topology:
        m, p = arrays.n_ports, arrays.n_pairs
    else:
        m = p = arrays.n_links
    rows_cap = ceil_pow2(m)
    pairs_cap = ceil_pow2(p) if resolved.topology else rows_cap
    if resolved.topology and pairs_cap > p and rows_cap == m:
        # Padded pairs need a padded port to route to (a real port's
        # n_pairs count must not see them): reserve one by doubling.
        rows_cap *= 2
    legs_cap = ceil_pow2(int(arrays.routing.n_legs)) if resolved.topology else 0
    pred_cap = 0
    if resolved.pred_source == "replay":
        pred_cap = ceil_pow2(resolved.policy.pred_demand.shape[1])
    hbuf = int(arrays.toggle.h.max()) + 1
    return BucketKey(
        topology=resolved.topology,
        rows_cap=rows_cap,
        pairs_cap=pairs_cap,
        legs_cap=legs_cap,
        n_tiers=int(k),
        policy_class=type(resolved.policy),
        renew_in_chunks=bool(resolved.policy.renew_in_chunks),
        pred_source=resolved.pred_source,
        pred_cap=pred_cap,
        hbuf_cap=max(ceil_pow2(hbuf), HBUF_FLOOR),
    )


def pack_tenant(resolved: ResolvedRuntime, key: Optional[BucketKey] = None) -> PackedTenant:
    """Pad one resolved tenant to its bucket capacities, on its device; a
    replay-mode policy's predicted mode costs are formed here, once, over the
    padded prediction (``predicted_mode_costs``, as the standalone runtime
    forms its own)."""
    if key is None:
        key = bucket_key_for(resolved)
    arrays = resolved.arrays
    mc, pc = key.rows_cap, key.pairs_cap
    if resolved.topology:
        m, p = arrays.n_ports, arrays.n_pairs
        plan = resolved.routing_plan
        if plan is None:
            plan = RoutingPlan.from_operand(arrays.routing, m, provenance="from_operand:gateway")
        # Padding legs point at the pool's inert (pad_pair, pad_port) slot
        # with zero weights (exact +0.0 in every leg sum), and padded PAIRS
        # carry no legs: real ports fold exactly the standalone leg list in
        # the standalone (leg) order. The padded primary maps padded pairs to
        # the pad port for the metrics ring.
        pad_port = mc - 1
        assert p == pc or pad_port >= m, (m, p, key)
        routing = padded_operand_np(plan, n_legs=key.legs_cap, n_rows=pc, pad_pair=pc - 1,
                                    pad_port=pad_port)
        padded = TopologyArrays(
            L_cci=_pad_rows(arrays.L_cci, mc, 0.0),
            V_cci=_pad_rows(arrays.V_cci, mc, 0.0),
            c_cci=_pad_rows(arrays.c_cci, mc, 0.0),
            port_capacity=_pad_rows(arrays.port_capacity, mc, PAD_BOUND),
            toggle=_pad_toggle(arrays.toggle, mc),
            L_vpn=_pad_rows(arrays.L_vpn, pc, 0.0),
            tier_bounds=_pad_rows(arrays.tier_bounds, pc, PAD_BOUND),
            tier_rates=_pad_rows(arrays.tier_rates, pc, 0.0),
            pair_capacity=_pad_rows(arrays.pair_capacity, pc, PAD_BOUND),
            routing=None,   # the pool folds over its own block-diagonal leg list
        )
    else:
        m = p = arrays.n_links
        routing = None
        padded = FleetArrays(
            L_cci=_pad_rows(arrays.L_cci, mc, 0.0),
            V_cci=_pad_rows(arrays.V_cci, mc, 0.0),
            c_cci=_pad_rows(arrays.c_cci, mc, 0.0),
            L_vpn=_pad_rows(arrays.L_vpn, mc, 0.0),
            tier_bounds=_pad_rows(arrays.tier_bounds, mc, PAD_BOUND),
            tier_rates=_pad_rows(arrays.tier_rates, mc, 0.0),
            toggle=_pad_toggle(arrays.toggle, mc),
            capacity=_pad_rows(arrays.capacity, mc, PAD_BOUND),
        )
    policy = _pad_policy(resolved.policy, mc, key.pred_cap)
    gate = None
    if key.pred_source == "replay":
        p_vpn, p_cci = predicted_mode_costs(policy.pred_demand, policy.cost_coef, torch.float64)
        gate = (p_vpn.T.contiguous(), p_cci.T.contiguous())
    return PackedTenant(
        key=key,
        arrays=padded,
        policy=policy,
        routing=routing,
        gate=gate,
        h_np=np.concatenate([arrays.toggle.h.cpu().numpy().astype(np.int64),
                             np.ones(mc - m, np.int64)]),
        hours_per_month=int(resolved.hours_per_month),
        n_rows=m,
        n_pairs=p,
    )


def stack_slots(per_slot, dim: int = 0):
    """Stack per-slot tensors (or tuples of them, field by field) along
    their row axis ``dim``: the pool's flat device layout, slot ``s`` the
    ``s``-th run of rows."""
    first = per_slot[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(list(per_slot), dim=dim).contiguous()
    fields = [stack_slots([v[i] for v in per_slot], dim) for i in range(len(first))]
    return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)


def set_slot(pool, slot: int, value, dim: int = 0) -> None:
    """Write one slot's rows of a pooled tensor (or tuple of them, field by
    field) in place: an operand write, never a shape change."""
    if isinstance(pool, torch.Tensor):
        n = value.shape[dim]
        pool.narrow(dim, slot * n, n).copy_(value)
        return
    for p, v in zip(pool, value):
        set_slot(p, slot, v, dim)
