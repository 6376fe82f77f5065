"""Port/facility topology: shared CCI leases over a facility graph (§VII-A).

Port of :mod:`repro.fleet.topology`. A CCI lease is a pair of physical
ports at ONE colocation facility; every region pair whose clouds meet
there can attach a VLAN to it, so the ``L_CCI`` lease is paid once and
shared and only the ``V_CCI`` attachment is per pair. Planning couples
**routing** (which candidate port path serves each demand row) and
**leasing** (when each port's ToggleCCI keeps its lease).

Demand rows may be 1-hop unicast pairs (:class:`PairSpec`), multi-hop
relay pairs (:class:`PathSpec`: pricing, capacity and window costs compose
per hop) or multicast groups (:class:`MulticastSpec`: a forwarding tree
whose shared edges are charged once). Each is a set of legs of the padded
leg-list :class:`~repro_torch.fleet.routing.RoutingOperand`, which the
engine folds onto ports with the ``leg_segment_sum`` kernel.

The specs, the routing heuristics (:func:`optimize_routing`,
:func:`multicast_unicast_expansion`) and the bridges to the per-link
planner (:func:`identity_topology`, :func:`dedicated_fleet`) are numpy and
copied from the JAX package, so with the same inputs both packages route
alike. :meth:`TopologySpec.stack` builds :class:`TopologyArrays` as float64
tensors on a device (CUDA by default). :func:`refine_routing`'s local search
is host numpy too, and evaluates each iteration's candidate port replans in
one :func:`~repro_torch.fleet.policy.policy_scan` call: one ``fsm_scan``
launch on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.core.pricing import HOURS_PER_MONTH, CostParams, TieredRate, flat_rate
from repro_torch.core.togglecci import ToggleParams
from repro_torch.device import DeviceLike, resolve_device

from .routing import RoutingOperand, RoutingPlan, as_routing_plan, index_legs
from .spec import PAD_BOUND, FleetSpec, LinkSpec, pad_tier_tables


@dataclasses.dataclass(frozen=True)
class PortSpec:
    """One candidate CCI port pair at a colocation facility.

    ``L_cci`` is the shared hourly lease (both physical ports), paid once
    however many pairs attach; ``V_cci`` is the per-pair VLAN attachment;
    ``c_cci`` the flat per-GB rate of the dedicated link. The toggle fields
    are this port's ToggleCCI operating point — the FSM decides per *port*,
    driven by port-aggregated window costs.
    """

    name: str
    facility: str
    cloud: str                        # non-GCP side of the cross-connect
    L_cci: float                      # $/hr shared lease
    V_cci: float                      # $/hr per attached pair
    c_cci: float                      # $/GB flat transfer
    capacity_gb_hr: float = math.inf  # hard CCI ceiling (linksim F1)
    D: int = 72                       # provisioning delay, hours
    T_cci: int = 168                  # minimum commitment, hours
    h: int = 168                      # sliding window, hours
    theta1: float = 0.9
    theta2: float = 1.1

    def __post_init__(self) -> None:
        assert self.capacity_gb_hr > 0
        assert self.D >= 0 and self.T_cci >= 1 and self.h >= 1
        assert 0 < self.theta1 <= self.theta2

    def toggle_cost_params(
        self, hours_per_month: int = HOURS_PER_MONTH
    ) -> CostParams:
        """This port's FSM/pricing constants as a :class:`CostParams`.

        The VPN side is zeroed — callers (reference planner, oracle) supply
        precomputed port-aggregated cost series instead of deriving them
        from these params.
        """
        return CostParams(
            L_cci=self.L_cci,
            V_cci=self.V_cci,
            c_cci=self.c_cci,
            L_vpn=0.0,
            vpn_tier=flat_rate(0.0),
            D=self.D,
            T_cci=self.T_cci,
            h=self.h,
            theta1=self.theta1,
            theta2=self.theta2,
            hours_per_month=hours_per_month,
        )


@dataclasses.dataclass(frozen=True)
class PairSpec:
    """One region pair: demand source, VPN pricing, candidate ports."""

    name: str
    src: str
    dst: str
    L_vpn: float                      # $/hr tunnel lease (both ends)
    vpn_tier: TieredRate              # tiered $/GB internet egress
    capacity_gb_hr: float = math.inf  # VLAN access ceiling (linksim F3)
    candidates: Tuple[int, ...] = ()  # indices into TopologySpec.ports
    family: str = "constant"          # demand-trace family (metadata)

    def __post_init__(self) -> None:
        assert self.capacity_gb_hr > 0
        assert len(self.candidates) >= 1, f"pair {self.name} has no candidate port"

    def path_options(self) -> List[Tuple[int, ...]]:
        """Ordered candidate paths: the 1-hop candidates, in declared order."""
        return [(int(c),) for c in self.candidates]


@dataclasses.dataclass(frozen=True)
class PathSpec(PairSpec):
    """A region pair that may ALSO route over declared multi-hop relay paths.

    ``relays`` are ordered port sequences (2+ hops) through intermediate
    regions (CloudCast/Pied Piper-style overlay routing: a third region is
    often cheaper than the direct cross-connect). Each hop pays its port's
    attachment + per-GB rate and contributes the row's demand to that
    port's aggregate and toggle window — pricing composes per hop. A
    :class:`PathSpec` with no relays IS a :class:`PairSpec` (the
    degeneration property test pins this bit-for-bit).
    """

    relays: Tuple[Tuple[int, ...], ...] = ()

    def __post_init__(self) -> None:
        super().__post_init__()
        relays = tuple(tuple(int(m) for m in p) for p in self.relays)
        object.__setattr__(self, "relays", relays)
        for p in relays:
            assert len(p) >= 2, (
                f"pair {self.name}: relay path {p} must have 2+ hops (1-hop "
                "routes belong in candidates)"
            )
            assert len(set(p)) == len(p), (
                f"pair {self.name}: relay path {p} visits a port twice"
            )

    def path_options(self) -> List[Tuple[int, ...]]:
        return [(int(c),) for c in self.candidates] + list(self.relays)


@dataclasses.dataclass(frozen=True)
class MulticastSpec:
    """One point-to-multipoint demand row: a source replicating the same
    bytes to ``leaves`` destinations (model-weight distribution, CDN fill).

    Routing assigns the row a *forwarding tree*: an ordered tuple of
    distinct ports such that every leaf has at least one of its candidate
    ports in the tree. Leaves sharing a port share that edge — the edge's
    demand, attachment and lease contribution are charged ONCE (DCCast-style
    edge sharing), which is what the per-leaf unicast expansion cannot do.
    The VPN counterfactual is ``n_leaves`` independent tunnels, so the
    stacked row scales ``L_vpn`` and the tier *rates* by ``n_leaves`` (each
    leaf sees the same cumulative volume, so the scaled row is exactly the
    per-leaf sum). A 1-leaf group with one candidate degenerates bit-for-bit
    to the equivalent :class:`PairSpec`.
    """

    name: str
    src: str
    leaves: Tuple[str, ...]
    leaf_candidates: Tuple[Tuple[int, ...], ...]
    L_vpn: float                      # $/hr per-leaf tunnel lease
    vpn_tier: TieredRate              # per-leaf tiered $/GB internet egress
    capacity_gb_hr: float = math.inf  # per-edge access ceiling
    family: str = "broadcast"

    def __post_init__(self) -> None:
        assert self.capacity_gb_hr > 0
        leaves = tuple(self.leaves)
        cands = tuple(tuple(int(c) for c in cs) for cs in self.leaf_candidates)
        object.__setattr__(self, "leaves", leaves)
        object.__setattr__(self, "leaf_candidates", cands)
        assert len(leaves) >= 1, f"group {self.name} has no leaves"
        assert len(cands) == len(leaves), (
            f"group {self.name}: need one candidate tuple per leaf"
        )
        assert all(len(cs) >= 1 for cs in cands), (
            f"group {self.name}: every leaf needs a candidate port"
        )

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    def validate_tree(self, path: Sequence[int]) -> None:
        """A tree is feasible iff every leaf can attach to one of its edges
        and every edge serves at least one leaf."""
        tree = set(int(m) for m in path)
        assert len(tree) == len(tuple(path)) >= 1, (
            f"group {self.name}: tree {tuple(path)} has duplicate/no edges"
        )
        for leaf, cs in zip(self.leaves, self.leaf_candidates):
            assert tree & set(cs), (
                f"group {self.name}: leaf {leaf} has no candidate port in "
                f"tree {tuple(path)}"
            )
        served = set()
        for cs in self.leaf_candidates:
            served |= tree & set(cs)
        assert served == tree, (
            f"group {self.name}: tree edges {sorted(tree - served)} serve "
            "no leaf"
        )

    def path_options(self) -> List[Tuple[int, ...]]:
        """Deterministic bounded tree candidates: every port shared by ALL
        leaves as a single-edge tree (maximal sharing), then the first- and
        cheapest-ranked per-leaf assignments deduplicated into trees."""
        opts: List[Tuple[int, ...]] = []
        common = set(self.leaf_candidates[0])
        for cs in self.leaf_candidates[1:]:
            common &= set(cs)
        for c in sorted(common):
            opts.append((c,))

        def dedup_tree(choice: Sequence[int]) -> Tuple[int, ...]:
            seen: Dict[int, None] = {}
            for m in choice:
                seen.setdefault(int(m), None)
            return tuple(seen)

        first = dedup_tree([cs[0] for cs in self.leaf_candidates])
        if first not in opts:
            opts.append(first)
        last = dedup_tree([cs[-1] for cs in self.leaf_candidates])
        if last not in opts:
            opts.append(last)
        return opts


class TopologyArrays(NamedTuple):
    """Struct-of-arrays view of a topology: the engine's operands, float64
    tensors (int32 for the toggle windows and the legs) on one device.

    Port fields are (M,); demand-row fields (P,)/(P, K), where ``P`` counts
    unicast pairs AND multicast groups. ``routing`` is the padded
    :class:`~repro_torch.fleet.routing.RoutingOperand` leg list with its
    port-major index.
    """

    L_cci: torch.Tensor          # (M,) shared port lease $/hr
    V_cci: torch.Tensor          # (M,) per-attachment $/hr
    c_cci: torch.Tensor          # (M,) flat CCI $/GB
    port_capacity: torch.Tensor  # (M,) hard CCI ceiling GB/hr (PAD_BOUND = inf)
    toggle: ToggleParams         # fields (M,): per-port FSM operating points
    L_vpn: torch.Tensor          # (P,) per-row VPN lease $/hr (groups: x n_leaves)
    tier_bounds: torch.Tensor    # (P, K) padded cumulative-volume bounds
    tier_rates: torch.Tensor     # (P, K) marginal $/GB (groups: x n_leaves)
    pair_capacity: torch.Tensor  # (P,) access ceiling GB/hr
    routing: RoutingOperand      # padded leg list (see repro_torch.fleet.routing)

    @property
    def n_ports(self) -> int:
        return self.L_cci.shape[0]

    @property
    def n_pairs(self) -> int:
        return self.L_vpn.shape[0]

    def to(self, device) -> "TopologyArrays":
        """The same arrays on ``device`` (no copy where they already lie there)."""
        return TopologyArrays(*(f.to(device) for f in self))


_PORT_FIELDS = ("L_cci", "V_cci", "c_cci", "port_capacity")
_ROW_FIELDS = ("L_vpn", "tier_bounds", "tier_rates", "pair_capacity")
_TOGGLE_DTYPES = {"theta1": np.float64, "theta2": np.float64, "h": np.int32,
                  "D": np.int32, "T_cci": np.int32}
_LEG_DTYPES = {"leg_pair": np.int32, "leg_port": np.int32, "vpn_w": np.float64,
               "attach_w": np.float64, "primary": np.int32}


def topology_arrays_from_numpy(d: Mapping[str, np.ndarray],
                               device: DeviceLike = None) -> TopologyArrays:
    """Build :class:`TopologyArrays` on ``device`` from a dict of numpy arrays.

    ``d`` holds the fields of a stacked topology (for example ``np.asarray``
    of each field of the JAX package's ``TopologyArrays``), with the toggle
    parameters flattened to ``theta1``/``theta2``/``h``/``D``/``T_cci`` and
    the routing operand to ``leg_pair``/``leg_port``/``vpn_w``/``attach_w``/
    ``primary``. The port-major leg index is built here, on the host.
    """
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(d[name], dtype=dtype), device=dev)

    toggle = ToggleParams(**{k: t(k, dt) for k, dt in _TOGGLE_DTYPES.items()})
    routing = RoutingOperand(**{k: t(k, dt) for k, dt in _LEG_DTYPES.items()})
    M = int(np.asarray(d["L_cci"]).shape[0])
    return TopologyArrays(
        **{k: t(k, np.float64) for k in _PORT_FIELDS + _ROW_FIELDS},
        toggle=toggle, routing=index_legs(routing, M),
    )


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """Candidate ports + demand rows (pairs and groups) sharing one billing
    calendar.

    ``policy`` names the per-port toggle decision rule the engine resolves
    when no policy object is passed (:mod:`repro_torch.fleet.policy`). Demand
    rows are ordered ``pairs`` first, then ``groups``.
    """

    ports: Tuple[PortSpec, ...]
    pairs: Tuple[PairSpec, ...]
    hours_per_month: int = HOURS_PER_MONTH
    policy: str = "reactive"
    groups: Tuple[MulticastSpec, ...] = ()

    def __post_init__(self) -> None:
        assert len(self.ports) >= 1 and len(self.pairs) + len(self.groups) >= 1
        from .policy import POLICY_KINDS

        assert self.policy in POLICY_KINDS, (
            f"unknown toggle policy {self.policy!r} (known: {POLICY_KINDS})"
        )
        m = len(self.ports)
        for pr in self.pairs:
            assert all(0 <= c < m for c in pr.candidates), (
                f"pair {pr.name}: candidate index out of range [0, {m})"
            )
            for path in getattr(pr, "relays", ()):
                assert all(0 <= c < m for c in path), (
                    f"pair {pr.name}: relay port out of range [0, {m})"
                )
        for g in self.groups:
            for cs in g.leaf_candidates:
                assert all(0 <= c < m for c in cs), (
                    f"group {g.name}: candidate index out of range [0, {m})"
                )

    @property
    def n_ports(self) -> int:
        return len(self.ports)

    @property
    def n_pairs(self) -> int:
        """Total demand rows (unicast pairs + multicast groups) — the ``P``
        every (P, T) demand array and routing plan must match."""
        return len(self.pairs) + len(self.groups)

    @property
    def n_unicast(self) -> int:
        return len(self.pairs)

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def facilities(self) -> Tuple[str, ...]:
        seen: dict = {}
        for p in self.ports:
            seen.setdefault(p.facility, None)
        return tuple(seen)

    # -- per-row views (rows are pairs then groups) -----------------------
    def row_spec(self, i: int):
        return (
            self.pairs[i] if i < len(self.pairs)
            else self.groups[i - len(self.pairs)]
        )

    def row_names(self) -> Tuple[str, ...]:
        return tuple(r.name for r in self.pairs + self.groups)

    def row_families(self) -> Tuple[str, ...]:
        return tuple(r.family for r in self.pairs + self.groups)

    def row_capacities(self) -> np.ndarray:
        return np.array(
            [r.capacity_gb_hr for r in self.pairs + self.groups]
        )

    def row_vpn_lease(self, i: int) -> float:
        r = self.row_spec(i)
        if isinstance(r, MulticastSpec):
            return r.n_leaves * r.L_vpn
        return r.L_vpn

    def row_vpn_tier(self, i: int) -> TieredRate:
        r = self.row_spec(i)
        if isinstance(r, MulticastSpec) and r.n_leaves != 1:
            return TieredRate(
                r.vpn_tier.bounds_gb,
                tuple(rate * r.n_leaves for rate in r.vpn_tier.rates),
            )
        return r.vpn_tier

    def row_options(
        self, i: int, *, max_hops: Optional[int] = None
    ) -> List[Tuple[int, ...]]:
        """Candidate paths/trees of row ``i`` in deterministic order."""
        opts = self.row_spec(i).path_options()
        if max_hops is not None and i < len(self.pairs):
            opts = [p for p in opts if len(p) <= max_hops]
        return opts

    def tree_row_indices(self) -> Tuple[int, ...]:
        return tuple(range(len(self.pairs), self.n_pairs))

    def candidate_matrix(self) -> np.ndarray:
        """(n_unicast, M) bool — which ports each PAIR may route through
        1-hop (relay/tree membership is validated per path, not here)."""
        mask = np.zeros((len(self.pairs), self.n_ports), dtype=bool)
        for i, pr in enumerate(self.pairs):
            mask[i, list(pr.candidates)] = True
        return mask

    def validate_plan(self, plan: RoutingPlan) -> RoutingPlan:
        assert plan.n_rows == self.n_pairs, (
            f"plan has {plan.n_rows} rows, topology has {self.n_pairs}"
        )
        assert plan.n_ports == self.n_ports, (
            f"plan counts {plan.n_ports} ports, topology has {self.n_ports}"
        )
        for i, path in enumerate(plan.paths):
            r = self.row_spec(i)
            if isinstance(r, MulticastSpec):
                r.validate_tree(path)
            elif len(path) == 1:
                assert path[0] in r.candidates, (
                    f"pair {r.name} routed to non-candidate port {path[0]}"
                )
            else:
                assert path in getattr(r, "relays", ()), (
                    f"pair {r.name} routed over undeclared relay path {path}"
                )
        return plan

    def validate_routing(self, routing) -> np.ndarray:
        """Validate a routing; returns the legacy ``(P,)`` index view when
        given one (or a 1-hop plan), else validates the plan and returns
        its primary ports. Accepts both forms WITHOUT deprecation noise —
        this is the validator the shims themselves use."""
        if isinstance(routing, RoutingPlan):
            self.validate_plan(routing)
            return routing.primary
        r = np.asarray(routing, dtype=np.int64)
        assert r.shape == (self.n_pairs,), (
            f"routing must be ({self.n_pairs},), got {r.shape}"
        )
        self.validate_plan(RoutingPlan.from_indices(r, self.n_ports))
        return r

    def plan(self, routing, **kw) -> RoutingPlan:
        """Ergonomic constructor: indices / matrix / list-of-paths → a
        validated :class:`RoutingPlan` (no deprecation warning — this IS
        the migration target for callers holding bare arrays)."""
        if isinstance(routing, RoutingPlan):
            return self.validate_plan(routing)
        if (
            isinstance(routing, (list, tuple))
            and routing
            and isinstance(routing[0], (list, tuple))
        ):
            p = RoutingPlan(
                paths=tuple(tuple(q) for q in routing),
                n_ports=self.n_ports,
                tree_rows=self.tree_row_indices(),
                **kw,
            )
            return self.validate_plan(p)
        r = np.asarray(routing)
        if r.ndim == 2:
            p = RoutingPlan.from_matrix(r, **kw)
        else:
            p = RoutingPlan.from_indices(r, self.n_ports, **kw)
        if self.groups:
            p = dataclasses.replace(p, tree_rows=self.tree_row_indices())
        return self.validate_plan(p)

    def stack(self, routing, dtype=torch.float64, device: DeviceLike = None
              ) -> TopologyArrays:
        """Stack the spec + a routing into :class:`TopologyArrays` on
        ``device`` (CUDA by default), the leg list with its port-major index.

        ``routing`` is a :class:`RoutingPlan`; the legacy bare-array forms
        are still accepted through the deprecation shim."""
        dev = resolve_device(device)
        plan = as_routing_plan(
            routing, n_ports=self.n_ports, context="TopologySpec.stack"
        )
        self.validate_plan(plan)
        P = self.n_pairs
        bounds, rates = pad_tier_tables(
            [self.row_vpn_tier(i) for i in range(P)]
        )
        fin = lambda v: v if math.isfinite(v) else PAD_BOUND
        f = lambda values: torch.tensor(values, dtype=dtype, device=dev)
        i32 = lambda values: torch.tensor(values, dtype=torch.int32, device=dev)
        toggle = ToggleParams(
            theta1=f([p.theta1 for p in self.ports]),
            theta2=f([p.theta2 for p in self.ports]),
            h=i32([p.h for p in self.ports]),
            D=i32([p.D for p in self.ports]),
            T_cci=i32([p.T_cci for p in self.ports]),
        )
        return TopologyArrays(
            L_cci=f([p.L_cci for p in self.ports]),
            V_cci=f([p.V_cci for p in self.ports]),
            c_cci=f([p.c_cci for p in self.ports]),
            port_capacity=f([fin(p.capacity_gb_hr) for p in self.ports]),
            toggle=toggle,
            L_vpn=f([self.row_vpn_lease(i) for i in range(P)]),
            tier_bounds=f(bounds),
            tier_rates=f(rates),
            pair_capacity=f([fin(c) for c in self.row_capacities()]),
            routing=plan.operand(dtype, dev),
        )

    def combined_params(self, pair_idx: int, port_idx: int) -> CostParams:
        """CostParams of pair ``pair_idx`` riding port ``port_idx`` ALONE —
        exactly the per-link (``plan_fleet``) view of that (pair, port) choice."""
        return self.combined_params_path(pair_idx, (port_idx,))

    def combined_params_path(
        self, row_idx: int, path: Sequence[int]
    ) -> CostParams:
        """CostParams of row ``row_idx`` riding ``path`` ALONE: per-hop
        leases/attachments/rates SUM (pricing composes per hop); the FSM
        operating point is the primary (first-hop) port's."""
        path = tuple(int(m) for m in path)
        po = self.ports[path[0]]
        return CostParams(
            L_cci=sum(self.ports[m].L_cci for m in path),
            V_cci=sum(self.ports[m].V_cci for m in path),
            c_cci=sum(self.ports[m].c_cci for m in path),
            L_vpn=self.row_vpn_lease(row_idx),
            vpn_tier=self.row_vpn_tier(row_idx),
            D=po.D,
            T_cci=po.T_cci,
            h=po.h,
            theta1=po.theta1,
            theta2=po.theta2,
            hours_per_month=self.hours_per_month,
        )


def routing_matrix(routing: np.ndarray, n_ports: int, dtype=torch.float64,
                   device: DeviceLike = None) -> torch.Tensor:
    """(P,) port indices -> padded one-hot (M, P) float routing matrix.

    Kept for the legacy-matrix interop surface; the engine itself consumes
    :class:`~repro_torch.fleet.routing.RoutingOperand` leg lists."""
    r = np.asarray(routing, dtype=np.int64)
    R = np.zeros((n_ports, r.shape[0]))
    R[r, np.arange(r.shape[0])] = 1.0
    return torch.tensor(R, dtype=dtype, device=resolve_device(device))


# ---------------------------------------------------------------------------
# Routing optimization (the "co-optimize routing + leasing" heuristic)
# ---------------------------------------------------------------------------


def _clipped_mean(topo: TopologySpec, demand) -> np.ndarray:
    d = np.asarray(demand, dtype=np.float64)
    assert d.shape[0] == topo.n_pairs
    d = np.minimum(d, topo.row_capacities()[:, None])
    return d.mean(axis=1)


def optimize_routing(
    topo: TopologySpec,
    demand: Optional[np.ndarray] = None,
    *,
    mean_demand: Optional[np.ndarray] = None,
    headroom: float = 0.8,
    max_hops: Optional[int] = None,
) -> RoutingPlan:
    """Greedy lease-sharing routing: first-fit decreasing with incremental
    hourly-cost scoring, hop-aware.

    Rows are placed in decreasing order of mean demand. Each row picks the
    candidate path/tree minimizing its *incremental* steady-state hourly
    cost, summed over the path's hops

        Σ_hops [(L_cci  if the port is not opened yet else 0)
                + V_cci + c_cci * mean],

    i.e. already-opened ports look ``L_cci`` cheaper — that is the lease
    sharing the per-link planner cannot see, and it is exactly what makes a
    relay through two already-hot hub ports beat a cold direct port, or a
    shared forwarding-tree edge beat per-leaf unicast. A path is feasible
    only while EVERY hop's mean load stays under ``headroom`` x capacity;
    when no option has room, the row falls back to the option minimizing
    the worst relative hop load (ToggleCCI will keep such an overloaded
    port on VPN more of the time anyway).

    ``max_hops=1`` restricts pairs to their 1-hop candidates — the
    pre-relay planner, used as the report's relay-savings baseline.

    Returns a :class:`RoutingPlan`; on a pure 1-hop topology it reproduces
    the 1-hop greedy placement exactly (same order, scores and
    tie-breaks — the degeneration property test pins this).
    """
    assert demand is not None or mean_demand is not None
    if mean_demand is None:
        mean_demand = _clipped_mean(topo, demand)
    mean = np.asarray(mean_demand, dtype=np.float64)
    assert mean.shape == (topo.n_pairs,)

    load = np.zeros(topo.n_ports)
    opened = np.zeros(topo.n_ports, dtype=bool)
    paths: List[Optional[Tuple[int, ...]]] = [None] * topo.n_pairs
    cap = np.array([p.capacity_gb_hr for p in topo.ports])

    for i in np.argsort(-mean):
        options = topo.row_options(int(i), max_hops=max_hops)
        best, best_cost = None, np.inf
        for path in options:
            if any(load[m] + mean[i] > headroom * cap[m] for m in path):
                continue
            incr = 0.0
            for m in path:
                po = topo.ports[m]
                incr += (
                    (0.0 if opened[m] else po.L_cci)
                    + po.V_cci + po.c_cci * mean[i]
                )
            if incr < best_cost:
                best, best_cost = path, incr
        if best is None:  # every option full: least worst relative load wins
            best = min(
                options, key=lambda p: max(load[m] / cap[m] for m in p)
            )
        paths[int(i)] = best
        for m in best:
            load[m] += mean[i]
            opened[m] = True
    return RoutingPlan(
        paths=tuple(paths),  # type: ignore[arg-type]
        n_ports=topo.n_ports,
        tree_rows=topo.tree_row_indices(),
        provenance=(
            "optimize_routing" if max_hops is None
            else f"optimize_routing(max_hops={max_hops})"
        ),
    )


def refine_routing(
    topo: TopologySpec,
    demand,
    routing,
    *,
    max_moves: int = 8,
    headroom: float = 0.8,
    renew_in_chunks: bool = False,
    tol: float = 1e-6,
    swap_moves: bool = True,
    swap_cap: int = 256,
    device: DeviceLike = None,
) -> Tuple[RoutingPlan, dict]:
    """Local search on top of the greedy routing: single-pair moves,
    pair-swap (2-exchange) moves AND relay moves.

    Repeatedly evaluates every re-pathing of a row to an alternative
    option — a *single* move when both paths are 1-hop, a *relay* move
    when either side is a multi-hop path or forwarding tree — and every
    pair SWAP (two 1-hop rows on different ports exchange ports — the
    2-exchange move single moves cannot express when both ports sit at
    their capacity headroom) by REPLANNING ONLY THE AFFECTED PORTS on
    their exact aggregated cost series, applies the best realized-cost
    improvement, and stops after ``max_moves`` moves or when no move helps.
    All candidate port replans of one iteration run as ONE reactive
    :func:`policy_scan` batch over rows (one ``fsm_scan`` launch on the
    card): each re-path move owns a fixed ``W``-slot block (``W`` = the
    structural worst-case affected-port count, 2 on a pure 1-hop topology)
    and the swap block is padded to a fixed ``min(|structural swaps|,
    swap_cap)`` slots, as in the JAX package, whose jitted eval needs a
    fixed shape. The series are numpy float64 on the host; ``device``
    (CUDA by default) is where the scan runs.

    ``routing`` is a :class:`RoutingPlan` (bare arrays go through the
    deprecation shim). Returns ``(refined_plan, info)`` with ``info``
    carrying ``cost_before``/``cost_after`` (sum of per-port FSM toggle
    costs — the report's ``togglecci`` total), the applied ``moves`` —
    single moves as ``(row, from_port, to_port, saving)``, relay moves as
    ``(row, from_path, to_path, saving)`` with tuple paths, swaps as
    ``((row_a, row_b), (port_a, port_b), (port_b, port_a), saving)``,
    saving always at index 3 — and ``move_mix`` counting applied moves per
    kind (``single`` / ``swap`` / ``relay``).
    """
    from repro_torch.core.costmodel import tiered_marginal_cost_np

    # Engine sits above this module — import its reference helper lazily.
    from .engine import _month_cum_np
    from .policy import policy_scan, reactive_policy

    dev = resolve_device(device)

    plan = as_routing_plan(
        routing, n_ports=topo.n_ports, context="refine_routing"
    )
    topo.validate_plan(plan)
    cur: List[Tuple[int, ...]] = list(plan.paths)
    hpm = topo.hours_per_month
    demand = np.asarray(demand, dtype=np.float64)
    P, T = demand.shape
    M = topo.n_ports
    d = np.minimum(demand, topo.row_capacities()[:, None])
    mean_d = d.mean(axis=1)
    cap = np.array([po.capacity_gb_hr for po in topo.ports])

    # Per-row VPN counterfactuals (exactly the reference aggregation
    # inputs; group rows already carry the n_leaves scaling).
    vpn_pair = np.zeros((P, T))
    for i in range(P):
        cum = _month_cum_np(d[i], hpm)
        vpn_pair[i] = topo.row_vpn_lease(i) + tiered_marginal_cost_np(
            topo.row_vpn_tier(i), cum, d[i]
        )

    def port_series(
        m: int, members_m: Set[int], hops: Dict[int, int]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Aggregated (vpn, cci) series of port ``m`` with rows
        ``members_m`` attached; ``hops`` overrides a row's hop count for
        hypothetical states (default: its current path length)."""
        po = topo.ports[m]
        idx = sorted(members_m)
        agg = d[idx].sum(axis=0) if idx else np.zeros(T)
        d_p = np.minimum(agg, cap[m] if math.isfinite(cap[m]) else np.inf)
        if idx:
            w = np.array(
                [1.0 / hops.get(i, len(cur[i])) for i in idx]
            )
            vpn = (vpn_pair[idx] * w[:, None]).sum(axis=0)
        else:
            vpn = np.zeros(T)
        cci = po.L_cci + po.V_cci * len(idx) + po.c_cci * d_p
        return vpn, cci

    def toggle_rows(port_ids: Sequence[int]) -> ToggleParams:
        ps = [topo.ports[m] for m in port_ids]
        f = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        return ToggleParams(
            theta1=f([p.theta1 for p in ps]),
            theta2=f([p.theta2 for p in ps]),
            h=i32([p.h for p in ps]),
            D=i32([p.D for p in ps]),
            T_cci=i32([p.T_cci for p in ps]),
        )

    def run_batch(port_ids, series):
        """Reactive total cost of every (port, series) slot: one
        ``policy_scan`` over the stacked rows (one ``fsm_scan`` launch
        on the card)."""
        f = lambda a: torch.tensor(np.stack(a), dtype=torch.float64, device=dev)
        pol = reactive_policy(toggle_rows(port_ids), renew_in_chunks=renew_in_chunks)
        out = policy_scan(pol, f([s[0] for s in series]), f([s[1] for s in series]))
        return out["total_cost"].cpu().numpy()

    members: Dict[int, Set[int]] = {m: set() for m in range(M)}
    for i, path in enumerate(cur):
        for m in path:
            members[m].add(i)
    port_cost = run_batch(
        range(M), [port_series(m, members[m], {}) for m in range(M)]
    )
    cost_before = float(port_cost.sum())

    # Structural move set: every (row, alternative option) of rows with
    # a choice — constant across iterations (the batch keeps one shape).
    # W is the structural worst-case affected-port count of one move (2 on
    # a pure 1-hop topology).
    row_options = [topo.row_options(i) for i in range(P)]
    move_set = [
        (i, opt)
        for i in range(P)
        for opt in row_options[i]
        if len(row_options[i]) > 1
    ]
    W = 2
    for i, opt in move_set:
        longest = max(len(o) for o in row_options[i])
        W = max(W, len(opt) + longest)

    # Structural swap slots: a 2-exchange (p, q) is only ever valid when
    # both are 1-hop rows whose current ports lie in cand(p) ∩ cand(q),
    # which needs at least two common 1-hop candidates. The slot COUNT
    # is fixed (padded with no-op evals) so one compiled batch serves
    # every iteration; which valid swaps fill the slots is re-decided
    # per iteration.
    cand_sets = [
        {o[0] for o in row_options[i] if len(o) == 1} for i in range(P)
    ]
    n_swap_slots = 0
    if swap_moves:
        n_structural = sum(
            1
            for p in range(P)
            for q in range(p + 1, P)
            if len(cand_sets[p] & cand_sets[q]) >= 2
        )
        n_swap_slots = min(n_structural, swap_cap)

    def port_loads() -> np.ndarray:
        return np.array(
            [sum(mean_d[q] for q in members[m]) for m in range(M)]
        )

    def fits(m: int, load: float) -> bool:
        return not math.isfinite(cap[m]) or load <= headroom * cap[m]

    pad_series = None  # port-0 as-is replan, refreshed per iteration

    moves_applied = []
    move_mix = {"single": 0, "swap": 0, "relay": 0}
    iterations = 0
    evaluated = 0
    for _ in range(max_moves):
        if not move_set and not n_swap_slots:
            break
        iterations += 1
        # Currently-valid swaps (both rows 1-hop, exchangeable, and the
        # exchange must respect the packer's capacity rule on BOTH
        # ends). Port loads are precomputed once per iteration — the
        # O(P²) combination scan only does O(1) work per pair.
        swaps = []
        if n_swap_slots:
            loads = port_loads()
            for p in range(P):
                if len(swaps) == n_swap_slots:
                    break
                if len(cur[p]) != 1:
                    continue
                for q in range(p + 1, P):
                    if len(cur[q]) != 1:
                        continue
                    m1, m2 = cur[p][0], cur[q][0]
                    if m1 == m2 or m2 not in cand_sets[p] or m1 not in cand_sets[q]:
                        continue
                    if not fits(m1, loads[m1] - mean_d[p] + mean_d[q]):
                        continue
                    if not fits(m2, loads[m2] - mean_d[q] + mean_d[p]):
                        continue
                    swaps.append((p, q))
                    if len(swaps) == n_swap_slots:
                        break
        if not move_set and not swaps:
            break
        # Two cached batch shapes only: re-paths-only (no swap currently
        # valid — the common post-convergence case) and re-paths + the
        # fixed padded swap block. Padding replans port 0 as-is so the
        # shape stays constant; its delta stays inf.
        swap_block = n_swap_slots if swaps else 0
        pad_series = port_series(0, members[0], {})
        port_ids, series = [], []
        affected_sets: List[List[int]] = []
        for i, opt in move_set:
            curp = cur[i]
            affected = list(curp) + [m for m in opt if m not in curp]
            affected_sets.append(affected)
            hops = {i: len(opt)}
            for m in affected:
                mem = set(members[m])
                if m in curp and m not in opt:
                    mem.discard(i)
                elif m in opt and m not in curp:
                    mem.add(i)
                port_ids.append(m)
                series.append(port_series(m, mem, hops))
            for _pad in range(W - len(affected)):
                port_ids.append(0)
                series.append(pad_series)
        for k in range(swap_block):
            if k < len(swaps):
                p, q = swaps[k]
                m1, m2 = cur[p][0], cur[q][0]
                port_ids += [m1, m2]
                series.append(port_series(m1, members[m1] - {p} | {q}, {}))
                series.append(port_series(m2, members[m2] - {q} | {p}, {}))
            else:  # padding slot
                port_ids += [0, 0]
                series.append(pad_series)
                series.append(pad_series)
        totals = run_batch(port_ids, series)
        loads = port_loads()
        n_moves = len(move_set)
        deltas = np.full(n_moves + swap_block, np.inf)
        for k, (i, opt) in enumerate(move_set):
            curp = cur[i]
            if opt == curp:
                continue  # structural no-op slot (keeps the batch fixed)
            if not all(
                fits(m, loads[m] + mean_d[i])
                for m in opt if m not in curp
            ):
                continue  # respect the greedy packer's capacity rule
            affected = affected_sets[k]
            s0 = W * k
            deltas[k] = sum(
                totals[s0 + j] for j in range(len(affected))
            ) - sum(port_cost[m] for m in affected)
        for j, (p, q) in enumerate(swaps):
            k = n_moves + j
            m1, m2 = cur[p][0], cur[q][0]
            deltas[k] = (
                totals[W * n_moves + 2 * j]
                + totals[W * n_moves + 2 * j + 1]
            ) - (port_cost[m1] + port_cost[m2])
        evaluated += n_moves + len(swaps)
        best = int(np.argmin(deltas))
        if not np.isfinite(deltas[best]) or deltas[best] >= -tol:
            break
        if best < n_moves:
            i, opt = move_set[best]
            curp = cur[i]
            affected = affected_sets[best]
            for m in curp:
                if m not in opt:
                    members[m].discard(i)
            for m in opt:
                members[m].add(i)
            cur[i] = opt
            saving = float(-deltas[best])
            if len(curp) == 1 and len(opt) == 1:
                moves_applied.append((i, curp[0], opt[0], saving))
                move_mix["single"] += 1
            else:
                moves_applied.append((i, curp, opt, saving))
                move_mix["relay"] += 1
            s0 = W * best
            for j, m in enumerate(affected):
                port_cost[m] = totals[s0 + j]
        else:
            p, q = swaps[best - n_moves]
            m1, m2 = cur[p][0], cur[q][0]
            members[m1].discard(p)
            members[m1].add(q)
            members[m2].discard(q)
            members[m2].add(p)
            cur[p], cur[q] = (m2,), (m1,)
            moves_applied.append(
                ((p, q), (m1, m2), (m2, m1), float(-deltas[best]))
            )
            move_mix["swap"] += 1
            s0 = W * n_moves + 2 * (best - n_moves)
            port_cost[m1] = totals[s0]
            port_cost[m2] = totals[s0 + 1]

    tight = sum(len(p) for p in cur)
    refined = RoutingPlan(
        paths=tuple(cur),
        n_ports=topo.n_ports,
        n_legs=max(plan.n_legs, tight),
        tree_rows=plan.tree_rows or topo.tree_row_indices(),
        provenance="refine_routing",
    )
    return refined, {
        "cost_before": cost_before,
        "cost_after": float(port_cost.sum()),
        "moves": moves_applied,
        "move_mix": move_mix,
        "evaluated_moves": evaluated,
    }


def multicast_unicast_expansion(
    topo: TopologySpec,
) -> Tuple[TopologySpec, np.ndarray]:
    """The per-leaf UNICAST view of a topology with multicast groups.

    Every :class:`MulticastSpec` becomes ``n_leaves`` independent
    :class:`PairSpec` rows (one tunnel per leaf, candidates = that leaf's
    ports, UNSCALED per-leaf VPN pricing) — what a planner without
    forwarding trees would have to buy. Returns ``(expanded_topo,
    row_map)`` where ``row_map[j]`` is the original row index expanded row
    ``j`` reads its demand from (``demand[row_map]`` expands a (P, T)
    demand to the unicast rows). The report's ``tree_sharing_savings``
    compares the tree plan against a reactive replan of this expansion.
    """
    pairs: List[PairSpec] = list(topo.pairs)
    row_map = list(range(len(topo.pairs)))
    for gi, g in enumerate(topo.groups):
        for j, (leaf, cs) in enumerate(zip(g.leaves, g.leaf_candidates)):
            pairs.append(
                PairSpec(
                    name=f"{g.name}->{leaf}",
                    src=g.src,
                    dst=leaf,
                    L_vpn=g.L_vpn,
                    vpn_tier=g.vpn_tier,
                    capacity_gb_hr=g.capacity_gb_hr,
                    candidates=cs,
                    family=g.family,
                )
            )
            row_map.append(len(topo.pairs) + gi)
    expanded = TopologySpec(
        ports=topo.ports,
        pairs=tuple(pairs),
        hours_per_month=topo.hours_per_month,
        policy=topo.policy,
    )
    return expanded, np.asarray(row_map, dtype=np.int64)


# ---------------------------------------------------------------------------
# Bridges to the per-link planner (plan_fleet)
# ---------------------------------------------------------------------------


def identity_topology(fleet: FleetSpec) -> Tuple[TopologySpec, RoutingPlan]:
    """Degenerate topology: one private port per fleet link, identity routing.

    Port capacity is left unbounded so the only demand clip is the pair's
    (= the link's) — :func:`repro_torch.fleet.engine.plan_topology` on this
    topology reproduces :func:`repro_torch.fleet.engine.plan_fleet` bit-for-bit
    (held in ``tests/test_torch_topology.py``).
    """
    ports, pairs = [], []
    for i, link in enumerate(fleet.links):
        p = link.params
        ports.append(
            PortSpec(
                name=f"port-{link.name}",
                facility=f"fac-{i:03d}",
                cloud="aws",
                L_cci=p.L_cci,
                V_cci=p.V_cci,
                c_cci=p.c_cci,
                D=p.D,
                T_cci=p.T_cci,
                h=p.h,
                theta1=p.theta1,
                theta2=p.theta2,
            )
        )
        pairs.append(
            PairSpec(
                name=link.name,
                src="gcp",
                dst="aws",
                L_vpn=p.L_vpn,
                vpn_tier=p.vpn_tier,
                capacity_gb_hr=link.capacity_gb_hr,
                candidates=(i,),
                family=link.family,
            )
        )
    topo = TopologySpec(
        ports=tuple(ports),
        pairs=tuple(pairs),
        hours_per_month=fleet.hours_per_month,
    )
    plan = RoutingPlan.from_indices(
        np.arange(len(fleet), dtype=np.int64),
        topo.n_ports,
        provenance="identity_topology",
    )
    return topo, plan


def dedicated_fleet(topo: TopologySpec, routing) -> FleetSpec:
    """The per-link (no lease sharing) view of a routed topology.

    Every row pays the FULL ``L_cci`` of every port on its routed path —
    what the per-link planner would charge this portfolio. Planning this fleet
    with :func:`repro_torch.fleet.engine.plan_fleet` gives the topology report's
    lease-sharing baseline.
    """
    plan = as_routing_plan(
        routing, n_ports=topo.n_ports, context="dedicated_fleet"
    )
    topo.validate_plan(plan)
    links = []
    for i, path in enumerate(plan.paths):
        r = topo.row_spec(i)
        cap = min(
            r.capacity_gb_hr,
            min(topo.ports[m].capacity_gb_hr for m in path),
        )
        links.append(
            LinkSpec(
                name=r.name,
                params=topo.combined_params_path(i, path),
                capacity_gb_hr=cap,
                family=r.family,
            )
        )
    return FleetSpec(tuple(links))
