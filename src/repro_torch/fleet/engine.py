"""The routed planning engine in PyTorch: price, fold, then toggle.

Port of :mod:`repro.fleet.engine`. A plan runs three stages on one device:

  pair stage    demand (P, T) --clip at pair/link capacity--> d
                d --monthly_cumsum + tiered pricing kernel--> hourly VPN cost
  route stage   fleet mode (:class:`FleetArrays`): identity routing, one link
                is one pair on a private port, CCI cost ``L + V·1 + c·d``;
                topology mode (:class:`TopologyArrays`): pairs fold onto
                ports over the routing's leg list with the leg-ordered
                segment-sum kernel (the VPN plane with ``vpn_w``, the demand
                plane with ``attach_w``, one launch), then ``d_row`` is
                clipped at port capacity and ``cci = L + V·n + c·d_row``
  policy stage  both cost planes (and, for the forecast-gated policy, its
                predicted demand and cost coefficients) --FSM scan kernel-->
                x, state, toggle cost

On CUDA the tiered pricing, the segment sum and the FSM scan are the
hand-written kernels of :mod:`repro_torch.kernels`; on the CPU
(``device="cpu"``) their plain PyTorch versions. Everything is float64,
except that ``use_pallas=True`` prices tiers in float32, as the JAX
package's Pallas path does.

:func:`plan_topology` co-optimizes routing (:func:`optimize_routing` on the
host when no routing is given) and leasing; :func:`replay_plan_topology`
replays a piecewise-constant routing schedule, and
:func:`offline_stream_oracle` is the offline twin of a stream. The numpy
references (:func:`plan_fleet_reference`, :func:`topology_port_costs_reference`,
:func:`plan_topology_reference`) are copies of the JAX package's.

The reports' OPT column, :func:`fleet_oracle` and :func:`topology_oracle`,
builds every row's hourly cost series on the host as the JAX package does,
then runs every row's offline-optimal DP in one ``oracle_dp`` launch on
CUDA (its plain version on the CPU).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.costmodel import (
    HourlyCosts,
    hourly_cost_series,
    monthly_cumsum,
    tiered_marginal_cost_np,
)
from repro_torch.core.togglecci import run_togglecci
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

from .policy import make_policy, policy_scan, policy_to
from .routing import RoutingOperand, as_routing_plan, index_legs
from .spec import FleetArrays, FleetSpec
from .topology import TopologyArrays, TopologySpec, optimize_routing


def _plan_outputs(policy, d, vpn, cci) -> Dict[str, torch.Tensor]:
    """Run the policy on the rows' demand and cost planes and add the static
    comparators. ALWAYS-CCI still pays the provisioning delay: the first D
    hours ride VPN."""
    out = policy_scan(policy, vpn, cci, demand=d)
    T = d.shape[1]
    cci_live = torch.arange(T, device=d.device)[None, :] >= policy.toggle.D[:, None]
    static_cci = torch.sum(torch.where(cci_live, cci, vpn), dim=1)
    return {
        "x": out["x"],                     # (rows, T) 0/1 decision sequences
        "state": out["state"],             # (rows, T) FSM states
        "toggle_cost": out["total_cost"],  # (rows,)
        "static_vpn": torch.sum(vpn, dim=1),
        "static_cci": static_cci,
        "vpn_hourly": vpn,
        "cci_hourly": cci,
    }


class RoutedSeries(NamedTuple):
    """The pricing output the policy toggles on. ``pair_demand`` is per
    pair/link (P rows); everything else is per DECISION row (M ports in
    topology mode; in fleet mode M == P, ``row_demand is pair_demand`` and
    ``n_pairs`` is all ones)."""

    pair_demand: torch.Tensor  # (P, T) capacity-clipped demand
    row_demand: torch.Tensor   # (M, T) demand the decision rows see
    vpn: torch.Tensor          # (M, T) hourly VPN counterfactual
    cci: torch.Tensor          # (M, T) hourly CCI counterfactual
    n_pairs: torch.Tensor      # (M,) pairs attached per row


def _pair_stage(arrays, demand: torch.Tensor, *, hours_per_month: int,
                use_pallas: bool = False):
    """Per-pair clip + tiered VPN pricing, the same for both routings (a
    fleet's link is a pair on a private port)."""
    f = torch.float64
    cap = arrays.pair_capacity if isinstance(arrays, TopologyArrays) else arrays.capacity
    d = torch.minimum(demand.to(f), cap[:, None])                      # (P, T)
    month_cum = monthly_cumsum(d, hours_per_month)
    if use_pallas:
        # The float32 tier path of the JAX package's use_pallas=True.
        f32 = torch.float32
        vpn_transfer = ops.tiered_cost_batched(
            month_cum.to(f32), d.to(f32),
            arrays.tier_bounds.to(f32), arrays.tier_rates.to(f32),
        ).to(f)
    else:
        vpn_transfer = ops.tiered_cost_batched(
            month_cum, d, arrays.tier_bounds, arrays.tier_rates
        )
    return d, arrays.L_vpn[:, None] + vpn_transfer


def _route_stage(arrays, routing: Optional[RoutingOperand], d_pair, vpn_pair):
    """Fold pairs onto decision rows and price the CCI counterfactual.

    ``routing=None`` is fleet mode's identity routing: one pair per row.
    Topology mode folds over the padded leg list (a multi-hop row has a leg
    per hop, a forwarding tree one per edge) with ``ops.leg_segment_sum``,
    each port's legs in ascending leg index from +0.0, as the JAX package's
    ``segment_sum`` scatter adds: ``vpn = seg(vpn_pair[lp]·vpn_w)``, ``d_row
    = min(seg(d_pair[lp]·attach_w), port_capacity)``. ``n_pairs =
    seg(attach_w)`` is the routing index's ``n_attach``, summed on the host
    when the operand was stacked. Only the CCI volume sees the port's hard
    capacity; the lease is paid once, attachments per pair.
    """
    if routing is None:
        d_row, vpn = d_pair, vpn_pair
        n_pairs = torch.ones_like(arrays.L_cci)
    else:
        M = arrays.L_cci.shape[0]
        if routing.index is None or routing.index.n_ports != M:
            raise ValueError("the routing operand has no port-major leg index for "
                             f"{M} ports; build it with index_legs(op, {M})")
        if routing.n_rows != d_pair.shape[0]:
            raise ValueError(f"routing has {routing.n_rows} rows, demand {d_pair.shape[0]}")
        idx = routing.index
        vpn, d_sum = ops.leg_segment_sum(
            (vpn_pair, d_pair), routing.leg_pair, routing.leg_port,
            (routing.vpn_w, routing.attach_w), M, index=(idx.order, idx.start),
        )
        d_row = torch.minimum(d_sum, arrays.port_capacity[:, None])
        n_pairs = idx.n_attach
    cci = (
        arrays.L_cci[:, None]
        + (arrays.V_cci * n_pairs)[:, None]
        + arrays.c_cci[:, None] * d_row
    )
    return d_row, vpn, cci, n_pairs


def routed_cost_series(
    arrays: Union[FleetArrays, TopologyArrays],
    demand: torch.Tensor,
    *,
    hours_per_month: int,
    use_pallas: bool = False,
    device: DeviceLike = None,
) -> RoutedSeries:
    """The pricing stage on ``device`` (CUDA unless the caller says
    otherwise): per-link cost planes for :class:`FleetArrays`, per-port
    planes folded through the routing for :class:`TopologyArrays`."""
    dev = resolve_device(device)
    arrays = arrays.to(dev)
    demand = torch.as_tensor(demand, dtype=torch.float64, device=dev)
    d_pair, vpn_pair = _pair_stage(
        arrays, demand, hours_per_month=hours_per_month, use_pallas=use_pallas
    )
    routing = arrays.routing if isinstance(arrays, TopologyArrays) else None
    d_row, vpn, cci, n_pairs = _route_stage(arrays, routing, d_pair, vpn_pair)
    return RoutedSeries(d_pair, d_row, vpn, cci, n_pairs)


def plan_fleet(
    fleet: Union[FleetSpec, FleetArrays],
    demand,
    *,
    policy=None,
    hours_per_month: int = 730,
    renew_in_chunks: bool = False,
    use_pallas: bool = False,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Plan the whole portfolio on ``device``: price every link-hour, then run
    every link's FSM, each in one kernel launch on CUDA.

    Args:
      fleet: a :class:`FleetSpec` (stacked here) or :class:`FleetArrays`
        (moved to ``device`` if they lie elsewhere).
      demand: (N, T) hourly GB per link, numpy or tensor (clipped at each
        link's capacity).
      policy: a :mod:`repro_torch.fleet.policy` policy with per-link
        tensors (e.g. :func:`~repro_torch.fleet.policy.forecast_gated_policy`
        on (N, T) predictions), moved to ``device``; ``None`` builds the
        spec's kind (default ``"reactive"``; ``"forecast"`` raises
        ``ValueError``, as in the JAX package).
      hours_per_month: billing calendar (taken from the spec when given).
      use_pallas: price tiers in float32, the path the JAX package's
        ``use_pallas=True`` selects; costs stay float64 after pricing.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` runs
        the plain PyTorch versions of the kernels.
    Returns:
      dict of per-link tensors on ``device``: ``x``, ``state``,
      ``toggle_cost``, ``static_vpn``, ``static_cci``, ``vpn_hourly``,
      ``cci_hourly``, ``pair_demand``/``demand``, ``port_demand`` and
      ``n_pairs``.
    """
    dev = resolve_device(device)
    kind = "reactive"
    if isinstance(fleet, FleetSpec):
        hours_per_month = fleet.hours_per_month
        kind = fleet.policy
        arrays = fleet.stack(torch.float64, dev)
    else:
        arrays = fleet.to(dev)
    policy = (make_policy(kind, arrays.toggle, renew_in_chunks=renew_in_chunks)
              if policy is None else policy_to(policy, dev))
    s = routed_cost_series(
        arrays, demand, hours_per_month=hours_per_month, use_pallas=use_pallas,
        device=dev,
    )
    out = _plan_outputs(policy, s.row_demand, s.vpn, s.cci)
    out.update(
        pair_demand=s.pair_demand, port_demand=s.row_demand, n_pairs=s.n_pairs,
        demand=s.pair_demand,
    )
    return out


def plan_fleet_reference(
    fleet: FleetSpec, demand, *, renew_in_chunks: bool = False
) -> Dict[str, np.ndarray]:
    """Per-link pure-Python reference (numpy float64): :func:`run_togglecci`
    link by link on capacity-clipped demand."""
    demand = np.asarray(demand, dtype=np.float64)
    xs, states, totals = [], [], []
    for i, link in enumerate(fleet.links):
        d = np.minimum(demand[i], link.capacity_gb_hr)
        res = run_togglecci(link.params, d, renew_in_chunks=renew_in_chunks)
        xs.append(res.x)
        states.append(res.state)
        totals.append(res.total_cost)
    return {
        "x": np.stack(xs),
        "state": np.stack(states),
        "toggle_cost": np.array(totals),
    }


# ---------------------------------------------------------------------------
# Topology-aware planning: routing + leasing over shared ports
# ---------------------------------------------------------------------------


def plan_topology(
    topo: Union[TopologySpec, TopologyArrays],
    demand,
    *,
    routing=None,
    policy=None,
    hours_per_month: int = 730,
    renew_in_chunks: bool = False,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Co-optimized routing + leasing plan on ``device``: on CUDA one
    ``tiered_cost_batched``, one ``leg_segment_sum`` and one ``fsm_scan``
    launch.

    Args:
      topo: a :class:`TopologySpec` (stacked here) or :class:`TopologyArrays`
        (their ``routing`` is baked in; moved to ``device`` if need be).
      demand: (P, T) hourly GB per region pair / multicast group.
      routing: a :class:`~repro_torch.fleet.routing.RoutingPlan` (legacy (P,)
        indices / (M, P) one-hot matrices work through the
        ``DeprecationWarning`` shim). ``None`` with a spec runs
        :func:`~repro_torch.fleet.topology.optimize_routing` on the host
        first: the "co-optimize" entry point.
      policy: per-PORT policy, moved to ``device`` (``None`` builds the
        spec's kind, default reactive; ``"forecast"`` raises ``ValueError``,
        as in the JAX package: pass a
        :func:`~repro_torch.fleet.policy.forecast_gated_policy` instead).
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` runs
        the plain PyTorch versions of the kernels.
    Returns:
      dict of per-port tensors: ``x``, ``state``, ``toggle_cost``,
      ``static_vpn``, ``static_cci``, ``vpn_hourly``, ``cci_hourly``,
      ``port_demand``, ``n_pairs``, and the per-pair ``pair_demand``.
    """
    dev = resolve_device(device)
    kind = "reactive"
    if isinstance(topo, TopologySpec):
        hours_per_month = topo.hours_per_month
        kind = topo.policy
        if routing is None:
            routing = optimize_routing(topo, np.asarray(demand))
        routing = as_routing_plan(routing, n_ports=topo.n_ports, context="plan_topology")
        arrays = topo.stack(routing, torch.float64, dev)
    else:
        if routing is not None:
            raise ValueError("pre-stacked arrays already carry a routing")
        arrays = topo.to(dev)
    policy = (make_policy(kind, arrays.toggle, renew_in_chunks=renew_in_chunks)
              if policy is None else policy_to(policy, dev))
    s = routed_cost_series(arrays, demand, hours_per_month=hours_per_month, device=dev)
    out = _plan_outputs(policy, s.row_demand, s.vpn, s.cci)
    out.update(pair_demand=s.pair_demand, port_demand=s.row_demand, n_pairs=s.n_pairs)
    return out


def replay_plan_topology(
    arrays: TopologyArrays,
    demand,
    schedule: Sequence[Tuple[int, object]],
    *,
    policy=None,
    hours_per_month: int = 730,
    renew_in_chunks: bool = False,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Offline replay of a PIECEWISE-CONSTANT routing schedule.

    ``schedule`` is ``[(start_hour, routing), ...]`` with the first start at
    hour 0 and strictly increasing starts; each ``routing`` is a
    :class:`~repro_torch.fleet.routing.RoutingPlan` (padded to the arrays'
    leg bound when it fits, as in the JAX package) or a
    :class:`~repro_torch.fleet.routing.RoutingOperand`. The pair stage runs
    once (it does not depend on the routing); each segment's hours are
    folded through its own routing, and ONE policy scan runs over the
    stitched series, so the FSM carry rides across each swap (a
    forecast-gated policy's in-scan cost fit sees the stitched port
    demand). A one-segment schedule ``[(0, routing)]`` gives
    :func:`plan_topology` on that routing bit for bit.
    """
    if not isinstance(arrays, TopologyArrays):
        raise TypeError("replay_plan_topology replays shared-port routings; fleet "
                        "mode has no routing to swap")
    starts = [int(s) for s, _ in schedule]
    if not starts or starts[0] != 0:
        raise ValueError("schedule must start at hour 0")
    if not all(a < b for a, b in zip(starts, starts[1:])):
        raise ValueError("schedule starts must be strictly increasing")
    dev = resolve_device(device)
    arrays = arrays.to(dev)
    demand = torch.as_tensor(demand, dtype=torch.float64, device=dev)
    T = demand.shape[1]
    M = arrays.n_ports
    policy = (make_policy("reactive", arrays.toggle, renew_in_chunks=renew_in_chunks)
              if policy is None else policy_to(policy, dev))
    E = arrays.routing.n_legs
    d_pair, vpn_pair = _pair_stage(arrays, demand, hours_per_month=hours_per_month)
    segs = []
    for (a, b), (_, r) in zip(zip(starts, starts[1:] + [T]), schedule):
        if isinstance(r, RoutingOperand):
            op = index_legs(r.to(dev), M)
        else:
            plan = as_routing_plan(r, n_ports=M, context="replay_plan_topology")
            if plan.total_hops <= E:
                plan = plan.pad_to(E)
            op = plan.operand(torch.float64, dev)
        segs.append(_route_stage(arrays, op, d_pair[:, a:b], vpn_pair[:, a:b])[:3])
    d_row, vpn, cci = (torch.cat(parts, dim=1) for parts in zip(*segs))
    return _plan_outputs(policy, d_row, vpn, cci)


def offline_stream_oracle(
    arrays: Union[FleetArrays, TopologyArrays],
    demand,
    *,
    policy=None,
    schedule: Optional[Sequence[Tuple[int, object]]] = None,
    hours_per_month: int = 730,
    renew_in_chunks: bool = False,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """The offline twin of a streamed prefix — the divergence monitor's oracle.

    Dispatches on the arrays: :class:`TopologyArrays` replay through
    :func:`replay_plan_topology` with the recorded routing ``schedule``
    (defaulting to one segment of the arrays' own routing — so a stream that
    never rerouted replays against exactly ``plan_topology``);
    :class:`FleetArrays` run straight through :func:`plan_fleet`
    (``schedule`` must be ``None`` — a fleet has no routing to swap).
    Decisions match a :class:`~repro_torch.fleet.runtime.FleetRuntime`
    stream of the same demand prefix bit for bit. Runs on ``device`` (CUDA
    unless the caller says otherwise).
    """
    if isinstance(arrays, TopologyArrays):
        if schedule is None:
            schedule = [(0, arrays.routing)]
        return replay_plan_topology(
            arrays, demand, schedule,
            policy=policy, hours_per_month=hours_per_month,
            renew_in_chunks=renew_in_chunks, device=device,
        )
    if schedule is not None:
        raise ValueError("fleet mode has no routing schedule")
    return plan_fleet(
        arrays, demand,
        policy=policy, hours_per_month=hours_per_month,
        renew_in_chunks=renew_in_chunks, device=device,
    )


def _month_cum_np(d: np.ndarray, hours_per_month: int) -> np.ndarray:
    """Exclusive within-month prefix volume of one (T,) demand row."""
    T = d.shape[0]
    t_idx = np.arange(T)
    month_start = (t_idx // hours_per_month) * hours_per_month
    full = np.concatenate([[0.0], np.cumsum(d)])
    return full[:-1] - full[month_start]


def topology_port_costs_reference(
    topo: TopologySpec, demand, routing
) -> Dict[str, np.ndarray]:
    """Float64 numpy port-aggregated cost series (reference / oracle input).

    Returns ``vpn``/``cci`` (M, T) hourly counterfactuals plus the clipped
    ``pair_demand``/``port_demand``. ``routing`` is anything
    :meth:`TopologySpec.plan` normalizes (plans, indices, path lists);
    multi-hop rows contribute demand and an attachment at EVERY hop and a
    ``1/n_hops`` share of their VPN counterfactual.
    """
    plan = topo.plan(routing)
    demand = np.asarray(demand, dtype=np.float64)
    P, T = demand.shape
    assert P == topo.n_pairs
    d = np.minimum(demand, topo.row_capacities()[:, None])
    vpn_pair = np.zeros((P, T))
    for i in range(P):
        cum = _month_cum_np(d[i], topo.hours_per_month)
        vpn_pair[i] = topo.row_vpn_lease(i) + tiered_marginal_cost_np(
            topo.row_vpn_tier(i), cum, d[i]
        )

    M = topo.n_ports
    vpn = np.zeros((M, T))
    cci = np.zeros((M, T))
    d_port = np.zeros((M, T))
    for m, po in enumerate(topo.ports):
        idx = [i for i, path in enumerate(plan.paths) if m in path]
        agg = d[idx].sum(axis=0) if idx else np.zeros(T)
        d_port[m] = np.minimum(agg, po.capacity_gb_hr)
        if idx:
            w = np.array([1.0 / len(plan.paths[i]) for i in idx])
            vpn[m] = (vpn_pair[idx] * w[:, None]).sum(axis=0)
        cci[m] = po.L_cci + po.V_cci * len(idx) + po.c_cci * d_port[m]
    return {"vpn": vpn, "cci": cci, "pair_demand": d, "port_demand": d_port}


def plan_topology_reference(
    topo: TopologySpec,
    demand,
    routing,
    *,
    renew_in_chunks: bool = False,
    port_costs: Optional[Dict[str, np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Per-port pure-Python reference (numpy float64) for :func:`plan_topology`
    with the reactive policy: aggregate pair costs onto ports, then
    :func:`run_togglecci` port by port.

    The FSM is bit-exact given identical (M, T) port series; this independent
    aggregation agrees with the engine's leg-ordered fold to float64 ulps, so
    decisions agree unless a window sum straddles a threshold within ~1e-15
    relative. ``port_costs={"vpn": ..., "cci": ...}`` pins the series.
    """
    series = (
        port_costs
        if port_costs is not None
        else topology_port_costs_reference(topo, demand, routing)
    )
    T = series["vpn"].shape[1]
    zeros = np.zeros(T)
    xs, states, totals = [], [], []
    for m, po in enumerate(topo.ports):
        costs = HourlyCosts(
            vpn_lease=zeros,
            vpn_transfer=series["vpn"][m],
            cci_lease=zeros,
            cci_transfer=series["cci"][m],
        )
        res = run_togglecci(
            po.toggle_cost_params(topo.hours_per_month),
            None,
            costs=costs,
            renew_in_chunks=renew_in_chunks,
        )
        xs.append(res.x)
        states.append(res.state)
        totals.append(res.total_cost)
    return {
        "x": np.stack(xs),
        "state": np.stack(states),
        "toggle_cost": np.array(totals),
        "vpn_hourly": series["vpn"],
        "cci_hourly": series["cci"],
    }


def _oracle_rows(vpn: np.ndarray, cci: np.ndarray, params, dev: torch.device) -> np.ndarray:
    """Every row's offline-optimal total in one ``ops.oracle_dp`` call on
    ``dev``: the (N, T) float64 planes and the rows' ``D``/``T_cci`` copied
    in once, the totals copied back."""
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    total, _ = ops.oracle_dp(f(vpn), f(cci), i32([p.D for p in params]),
                             i32([p.T_cci for p in params]))
    return total.cpu().numpy()


def topology_oracle(topo: TopologySpec, demand, routing, *,
                    device: DeviceLike = None) -> np.ndarray:
    """Offline-optimal (DP) cost per port for a FIXED routing — the report's
    leasing-oracle column (routing itself is not oracle-optimized).

    The port-aggregated series are :func:`topology_port_costs_reference`'s
    (host numpy, as the JAX package builds them); every port's DP then runs
    in one ``oracle_dp`` launch on ``device`` (CUDA by default; the plain
    version on the CPU), each total bit-equal to
    :func:`repro_torch.core.oracle.offline_optimal` on the port's series.
    """
    dev = resolve_device(device)
    series = topology_port_costs_reference(topo, demand, routing)
    zeros = np.zeros(series["vpn"].shape)
    params = [po.toggle_cost_params(topo.hours_per_month) for po in topo.ports]
    # HourlyCosts(vpn_lease=0, vpn_transfer=series, ...).vpn, as the reference sums it.
    return _oracle_rows(zeros + series["vpn"], zeros + series["cci"], params, dev)


def fleet_oracle(fleet: FleetSpec, demand, *, device: DeviceLike = None) -> np.ndarray:
    """Offline-optimal (DP) total cost per link — the report's OPT column.

    Each link's hourly VPN and CCI series are built on the host from its
    capacity-clipped demand (:func:`hourly_cost_series`, as the JAX package
    does), stacked into (N, T) planes and run in one ``oracle_dp`` launch on
    ``device`` (CUDA by default; the plain version on the CPU), each total
    bit-equal to :func:`repro_torch.core.oracle.offline_optimal` on the link.
    """
    dev = resolve_device(device)
    vpn, cci = _fleet_cost_planes(fleet, demand)
    return _oracle_rows(vpn, cci, [link.params for link in fleet.links], dev)


def _fleet_cost_planes(fleet: FleetSpec, demand) -> Tuple[np.ndarray, np.ndarray]:
    """The (N, T) float64 hourly VPN and CCI series of every link on the
    host, from its capacity-clipped demand: :func:`fleet_oracle`'s input."""
    demand = np.asarray(demand, dtype=np.float64)
    N, T = len(fleet), demand.shape[1]
    vpn, cci = np.empty((N, T)), np.empty((N, T))
    for i, link in enumerate(fleet.links):
        costs = hourly_cost_series(link.params, np.minimum(demand[i], link.capacity_gb_hr))
        vpn[i], cci[i] = costs.vpn, costs.cci
    return vpn, cci
