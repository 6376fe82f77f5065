"""Fleet report: per-link and aggregate economics of a planned portfolio.

Port of :mod:`repro.fleet.report`. Consumes the outputs of
:func:`repro_torch.fleet.engine.plan_fleet` (tensors on any device, or numpy
arrays; each plane is copied to the host once) and renders the paper's
single-link comparisons (ToggleCCI vs static-VPN / static-CCI / offline
oracle, Figs. 10-12) at portfolio scale: one row per link, one aggregate
line, and toggle-event timelines per link.

The topology report (:func:`build_topology_report`) adds the §VII-A
portfolio metrics:

* **lease-sharing savings** — the same routed (pair, port) choices priced
  per-link (every pair paying its full ``L_cci``) vs shared;
* **oracle gap** — per-port ToggleCCI vs the offline DP on the same
  port-aggregated cost series (routing held fixed);
* **relay** and **tree-sharing savings** — multi-hop relays vs 1-hop-only
  routing, forwarding trees vs per-leaf unicast (both reactive replans);
* **forecast_gain** — a forecast-gated plan's cost (any plan's outputs
  passed as ``forecast_plan``) vs reactive vs the oracle; and
* **routing_improvement** — realized-cost saving of the pair-move local
  search (:func:`repro_torch.fleet.topology.refine_routing`) over the
  greedy routing.

The OPT columns run every row's DP in one ``oracle_dp`` launch, and the
baselines' replans through ``plan_fleet``/``plan_topology``, on ``device``
(CUDA unless the caller passes ``device="cpu"``); routing heuristics run on
the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.togglecci import OFF, ON
from repro_torch.device import DeviceLike, resolve_device, to_host

from .engine import (
    fleet_oracle,
    plan_fleet,
    plan_topology,
    topology_oracle,
)
from .routing import RoutingPlan, as_routing_plan
from .scenario import FleetScenario, TopologyScenario
from .spec import FleetSpec
from .topology import (
    dedicated_fleet,
    multicast_unicast_expansion,
    optimize_routing,
)


@dataclasses.dataclass(frozen=True)
class LinkReport:
    name: str
    family: str
    toggle_cost: float
    static_vpn: float
    static_cci: float
    oracle_cost: Optional[float]
    on_fraction: float
    requests: Tuple[int, ...]   # hours a CCI provisioning request fired
    releases: Tuple[int, ...]   # hours the CCI lease was released

    @property
    def best_static(self) -> float:
        return min(self.static_vpn, self.static_cci)

    @property
    def savings_vs_best_static(self) -> float:
        """Fractional saving of ToggleCCI vs the best static policy."""
        return 1.0 - self.toggle_cost / self.best_static if self.best_static else 0.0

    @property
    def competitive_ratio(self) -> Optional[float]:
        if self.oracle_cost is None or self.oracle_cost <= 0:
            return None
        return self.toggle_cost / self.oracle_cost


@dataclasses.dataclass(frozen=True)
class FleetReport:
    links: Tuple[LinkReport, ...]
    horizon: int

    @property
    def totals(self) -> Dict[str, float]:
        agg = {
            "togglecci": sum(l.toggle_cost for l in self.links),
            "static_vpn": sum(l.static_vpn for l in self.links),
            "static_cci": sum(l.static_cci for l in self.links),
            "best_static_per_link": sum(l.best_static for l in self.links),
        }
        oracles = [l.oracle_cost for l in self.links if l.oracle_cost is not None]
        if oracles and len(oracles) == len(self.links):
            agg["oracle"] = sum(oracles)
        return agg

    def render_text(self, max_rows: int = 20) -> str:
        hdr = (
            f"{'link':<16}{'family':<10}{'toggle $':>12}{'vpn $':>12}"
            f"{'cci $':>12}{'save%':>8}{'on%':>6}{'tog':>5}"
        )
        lines = [hdr, "-" * len(hdr)]
        for l in self.links[:max_rows]:
            lines.append(
                f"{l.name:<16}{l.family:<10}{l.toggle_cost:>12.0f}"
                f"{l.static_vpn:>12.0f}{l.static_cci:>12.0f}"
                f"{100 * l.savings_vs_best_static:>7.1f}%"
                f"{100 * l.on_fraction:>5.0f}%"
                f"{len(l.requests) + len(l.releases):>5d}"
            )
        if len(self.links) > max_rows:
            lines.append(f"... ({len(self.links) - max_rows} more links)")
        t = self.totals
        save = 1.0 - t["togglecci"] / t["best_static_per_link"]
        lines.append("-" * len(hdr))
        lines.append(
            f"fleet total: toggle ${t['togglecci']:.0f}  "
            f"vpn ${t['static_vpn']:.0f}  cci ${t['static_cci']:.0f}  "
            f"vs best-static {100 * save:+.1f}%"
            + (f"  oracle ${t['oracle']:.0f}" if "oracle" in t else "")
        )
        return "\n".join(lines)


def toggle_events(state_row: np.ndarray) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(requests, releases) hour indices from one link's FSM state trace.

    A request fires when the link leaves OFF (into WAITING, or straight to
    ON when D=0); a release when it returns to OFF from ON.
    """
    s = np.asarray(state_row)
    prev = np.concatenate([[OFF], s[:-1]])
    requests = np.where((prev == OFF) & (s != OFF))[0]
    releases = np.where((prev == ON) & (s == OFF))[0]
    return tuple(int(t) for t in requests), tuple(int(t) for t in releases)


def lease_intervals(
    state_row: np.ndarray,
) -> Tuple[Tuple[int, Optional[int], Optional[int]], ...]:
    """Full lease lifecycles from one row's FSM state trace.

    Returns ``(request_hour, activate_hour, release_hour)`` triples in
    stream order — the offline twin of the observability layer's live trace
    slices (the JAX package's ``repro.obs.trace.TraceRecorder`` renders the
    same intervals from streamed states). ``activate_hour`` is ``None`` when
    the stream ended while the row was still WAITING out its provisioning
    delay; ``release_hour`` is ``None`` when it ended leased.
    """
    s = np.asarray(state_row)
    prev = np.concatenate([[OFF], s[:-1]])
    requests = np.where((prev == OFF) & (s != OFF))[0]
    activates = np.where((prev != ON) & (s == ON))[0]
    releases = np.where((prev == ON) & (s == OFF))[0]
    out = []
    for r in requests:
        ia = np.searchsorted(activates, r)
        a = int(activates[ia]) if ia < activates.size else None
        rel = None
        if a is not None:
            ir = np.searchsorted(releases, a)
            rel = int(releases[ir]) if ir < releases.size else None
        out.append((int(r), a, rel))
    return tuple(out)


def build_report(
    scenario: FleetScenario,
    plan: Dict[str, np.ndarray],
    *,
    include_oracle: bool = False,
    oracle_links: Optional[int] = None,
    device: DeviceLike = None,
) -> FleetReport:
    """Assemble a :class:`FleetReport` from engine outputs.

    ``include_oracle`` runs the per-link DP (:func:`fleet_oracle`: the cost
    series on the host, every link's DP in one ``oracle_dp`` launch on
    ``device``, CUDA by default); ``oracle_links`` caps how many links get
    an OPT column (None = all).
    """
    fleet: FleetSpec = scenario.fleet
    state = to_host(plan["state"])
    x = to_host(plan["x"])
    toggle_cost = to_host(plan["toggle_cost"], np.float64)
    static_vpn = to_host(plan["static_vpn"], np.float64)
    static_cci = to_host(plan["static_cci"], np.float64)
    T = state.shape[1]

    oracle = None
    if include_oracle:
        k = len(fleet) if oracle_links is None else min(oracle_links, len(fleet))
        sub = FleetSpec(fleet.links[:k])
        oracle = fleet_oracle(sub, np.asarray(scenario.demand)[:k], device=device)

    rows: List[LinkReport] = []
    for i, link in enumerate(fleet.links):
        requests, releases = toggle_events(state[i])
        rows.append(
            LinkReport(
                name=link.name,
                family=link.family,
                toggle_cost=float(toggle_cost[i]),
                static_vpn=float(static_vpn[i]),
                static_cci=float(static_cci[i]),
                oracle_cost=(
                    float(oracle[i]) if oracle is not None and i < len(oracle) else None
                ),
                on_fraction=float(np.mean(x[i])),
                requests=requests,
                releases=releases,
            )
        )
    return FleetReport(links=tuple(rows), horizon=T)


# ---------------------------------------------------------------------------
# Topology report: shared-port economics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PortReport:
    """One CCI port's planned economics (aggregated over attached pairs)."""

    name: str
    facility: str
    n_pairs: int
    toggle_cost: float
    static_vpn: float
    static_cci: float
    oracle_cost: Optional[float]
    on_fraction: float
    requests: Tuple[int, ...]
    releases: Tuple[int, ...]
    forecast_cost: Optional[float] = None  # forecast-gated policy, same routing

    @property
    def best_static(self) -> float:
        return min(self.static_vpn, self.static_cci)

    @property
    def savings_vs_best_static(self) -> float:
        return 1.0 - self.toggle_cost / self.best_static if self.best_static else 0.0

    @property
    def competitive_ratio(self) -> Optional[float]:
        if self.oracle_cost is None or self.oracle_cost <= 0:
            return None
        return self.toggle_cost / self.oracle_cost

    @property
    def forecast_gain(self) -> Optional[float]:
        """Fraction of this port's reactive-vs-oracle gap that forecast
        gating closed (1.0 = matched the offline DP, < 0 = made it worse)."""
        if self.forecast_cost is None or self.oracle_cost is None:
            return None
        gap = self.toggle_cost - self.oracle_cost
        if gap <= 0:
            return None  # reactive already at the oracle: nothing to close
        return (self.toggle_cost - self.forecast_cost) / gap


@dataclasses.dataclass(frozen=True)
class TopologyReport:
    ports: Tuple[PortReport, ...]
    horizon: int
    routing: RoutingPlan
    dedicated_cost: Optional[float]  # same routing, no lease sharing (per-link view)
    refined_routing: Optional[RoutingPlan] = None      # local-search output
    refined_cost: Optional[float] = None               # reactive replan, refined routing
    refine_base_cost: Optional[float] = None           # reactive cost, input routing
    refine_move_mix: Optional[Dict[str, int]] = None   # applied single/swap/relay moves
    relay_baseline_cost: Optional[float] = None        # reactive replan, 1-hop-only routing
    tree_unicast_cost: Optional[float] = None          # reactive replan, per-leaf unicast

    @property
    def totals(self) -> Dict[str, float]:
        # Static comparators count ROUTED ports only: an idle candidate port
        # still has static_cci = a full-horizon lease nobody would buy, and
        # summing it would flatter ToggleCCI vs the static-CCI baseline.
        used = [p for p in self.ports if p.n_pairs > 0]
        agg = {
            "togglecci": sum(p.toggle_cost for p in self.ports),
            "static_vpn": sum(p.static_vpn for p in used),
            "static_cci": sum(p.static_cci for p in used),
            "best_static_per_port": sum(p.best_static for p in used),
        }
        oracles = [p.oracle_cost for p in self.ports if p.oracle_cost is not None]
        if oracles and len(oracles) == len(self.ports):
            agg["oracle"] = sum(oracles)
            agg["oracle_gap"] = (
                agg["togglecci"] / agg["oracle"] if agg["oracle"] > 0 else float("nan")
            )
        if self.dedicated_cost is not None:
            agg["dedicated_per_link"] = self.dedicated_cost
            agg["lease_sharing_savings"] = (
                1.0 - agg["togglecci"] / self.dedicated_cost
                if self.dedicated_cost
                else 0.0
            )
        forecasts = [p.forecast_cost for p in self.ports if p.forecast_cost is not None]
        if forecasts and len(forecasts) == len(self.ports):
            agg["forecast"] = sum(forecasts)
            if "oracle" in agg:
                gap = agg["togglecci"] - agg["oracle"]
                agg["forecast_gain"] = (
                    (agg["togglecci"] - agg["forecast"]) / gap
                    if gap > 0
                    else float("nan")
                )
        if self.relay_baseline_cost is not None:
            # Realized-cost saving of multi-hop relay routing over the same
            # planner restricted to 1-hop candidates (both reactive).
            agg["one_hop_cost"] = self.relay_baseline_cost
            agg["relay_savings"] = (
                1.0 - agg["togglecci"] / self.relay_baseline_cost
                if self.relay_baseline_cost
                else 0.0
            )
        if self.tree_unicast_cost is not None:
            # Edge sharing: the tree plan vs the per-leaf unicast expansion
            # of every multicast group (both reactive).
            agg["unicast_expansion_cost"] = self.tree_unicast_cost
            agg["tree_sharing_savings"] = (
                1.0 - agg["togglecci"] / self.tree_unicast_cost
                if self.tree_unicast_cost
                else 0.0
            )
        if self.refined_cost is not None:
            # Baseline is the REACTIVE cost of the input routing (the metric
            # refine_routing optimizes) — the passed-in plan may have run a
            # different policy, and mixing them would misattribute policy
            # effects to routing.
            base = self.refine_base_cost or agg["togglecci"]
            agg["refined_cost"] = self.refined_cost
            agg["routing_improvement"] = (
                1.0 - self.refined_cost / base if base else 0.0
            )
        return agg

    @property
    def ports_used(self) -> int:
        """Ports with at least one routed pair."""
        return sum(1 for p in self.ports if p.n_pairs > 0)

    def render_text(self, max_rows: int = 20) -> str:
        hdr = (
            f"{'port':<20}{'facility':<10}{'pairs':>6}{'toggle $':>12}"
            f"{'vpn $':>12}{'cci $':>12}{'save%':>8}{'on%':>6}{'tog':>5}"
        )
        lines = [hdr, "-" * len(hdr)]
        for p in self.ports[:max_rows]:
            lines.append(
                f"{p.name:<20}{p.facility:<10}{p.n_pairs:>6d}"
                f"{p.toggle_cost:>12.0f}{p.static_vpn:>12.0f}"
                f"{p.static_cci:>12.0f}"
                f"{100 * p.savings_vs_best_static:>7.1f}%"
                f"{100 * p.on_fraction:>5.0f}%"
                f"{len(p.requests) + len(p.releases):>5d}"
            )
        if len(self.ports) > max_rows:
            lines.append(f"... ({len(self.ports) - max_rows} more ports)")
        t = self.totals
        lines.append("-" * len(hdr))
        tail = (
            f"topology total: toggle ${t['togglecci']:.0f}  "
            f"vpn ${t['static_vpn']:.0f}  cci ${t['static_cci']:.0f}  "
            f"ports used {self.ports_used}/{len(self.ports)}"
        )
        if "lease_sharing_savings" in t:
            tail += (
                f"  vs per-link ${t['dedicated_per_link']:.0f} "
                f"({100 * t['lease_sharing_savings']:+.1f}% shared-lease saving)"
            )
        if "oracle_gap" in t:
            tail += f"  oracle gap {t['oracle_gap']:.3f}x"
        lines.append(tail)
        if "forecast" in t:
            line = f"forecast-gated: ${t['forecast']:.0f}"
            if "forecast_gain" in t:
                line += (
                    f"  ({100 * t['forecast_gain']:+.1f}% of the "
                    "reactive-vs-oracle gap closed)"
                )
            lines.append(line)
        if "relay_savings" in t:
            lines.append(
                f"multi-hop relays: {100 * t['relay_savings']:+.2f}% vs "
                f"1-hop-only routing (${t['one_hop_cost']:.0f}), "
                f"hop depth {self.routing.hop_depth}"
            )
        if "tree_sharing_savings" in t:
            lines.append(
                f"forwarding trees: {100 * t['tree_sharing_savings']:+.2f}% vs "
                f"per-leaf unicast (${t['unicast_expansion_cost']:.0f})"
            )
        if "refined_cost" in t:
            line = (
                f"refined routing: ${t['refined_cost']:.0f}  "
                f"({100 * t['routing_improvement']:+.2f}% vs greedy routing)"
            )
            if self.refine_move_mix is not None:
                mix = ", ".join(
                    f"{k}: {v}" for k, v in sorted(self.refine_move_mix.items())
                )
                line += f"  [moves — {mix}]"
            lines.append(line)
        return "\n".join(lines)


def build_topology_report(
    scenario: TopologyScenario,
    plan: Dict[str, np.ndarray],
    routing,
    *,
    include_oracle: bool = False,
    include_dedicated_baseline: bool = True,
    renew_in_chunks: bool = False,
    forecast_plan: Optional[Dict[str, np.ndarray]] = None,
    refine: bool = False,
    refine_max_moves: int = 8,
    device: DeviceLike = None,
) -> TopologyReport:
    """Assemble a :class:`TopologyReport` from :func:`plan_topology` outputs.

    ``include_dedicated_baseline`` replans the SAME routed (pair, port)
    choices with the per-link engine — every pair paying its full port
    lease — so ``lease_sharing_savings`` isolates exactly what sharing buys.
    ``include_oracle`` runs the per-port offline DP on the port-aggregated
    cost series (:func:`topology_oracle`: the series on the host, every
    port's DP in one ``oracle_dp`` launch on ``device``).
    ``forecast_plan`` takes the outputs of a plan run with a forecast-gated
    policy on the SAME routing (any plan's outputs: tensors or numpy) and
    adds the per-port ``forecast_cost`` column plus the aggregate
    ``forecast_gain`` (fraction of the reactive-vs-oracle gap closed —
    requires ``include_oracle``).
    ``refine`` runs the pair-move local search
    (:func:`repro_torch.fleet.topology.refine_routing`) after the greedy
    routing and reports ``routing_improvement`` on a full replan.

    ``routing`` is a :class:`RoutingPlan` (legacy bare arrays go through
    the deprecation shim). When the plan uses multi-hop relays, the report
    automatically adds ``relay_savings`` — the realized-cost saving vs a
    reactive replan of :func:`optimize_routing(..., max_hops=1)` — and when
    the topology has multicast groups, ``tree_sharing_savings`` vs a
    reactive replan of the per-leaf unicast expansion
    (:func:`repro_torch.fleet.topology.multicast_unicast_expansion`).
    Every replan runs on ``device`` (CUDA unless the caller says otherwise).
    """
    from .policy import reactive_policy
    from .topology import refine_routing

    dev = resolve_device(device)
    topo = scenario.topo
    r = as_routing_plan(
        routing, n_ports=topo.n_ports, context="build_topology_report"
    )
    topo.validate_plan(r)
    state = to_host(plan["state"])
    x = to_host(plan["x"])
    toggle_cost = to_host(plan["toggle_cost"], np.float64)
    static_vpn = to_host(plan["static_vpn"], np.float64)
    static_cci = to_host(plan["static_cci"], np.float64)
    n_pairs = to_host(plan["n_pairs"]).astype(np.int64)
    T = state.shape[1]

    oracle = (
        topology_oracle(topo, scenario.demand, r, device=dev) if include_oracle else None
    )

    dedicated_cost = None
    if include_dedicated_baseline:
        ded = plan_fleet(
            dedicated_fleet(topo, r),
            scenario.demand,
            renew_in_chunks=renew_in_chunks,
            device=dev,
        )
        dedicated_cost = float(np.sum(to_host(ded["toggle_cost"])))

    forecast_cost = (
        to_host(forecast_plan["toggle_cost"], np.float64)
        if forecast_plan is not None
        else None
    )

    def _reactive_replan_cost(t, rt, demand) -> float:
        """Reactive full replan of routing ``rt`` on topology ``t`` — the
        common policy-controlled baseline every savings metric compares
        against (the spec's default kind may be one the engine cannot
        resolve on its own, e.g. "forecast")."""
        arr = t.stack(rt, torch.float64, dev)
        pol = reactive_policy(arr.toggle, renew_in_chunks=renew_in_chunks)
        out = plan_topology(
            arr, demand, policy=pol, hours_per_month=t.hours_per_month, device=dev
        )
        return float(np.sum(to_host(out["toggle_cost"])))

    refined_routing = refined_cost = refine_base_cost = refine_move_mix = None
    if refine:
        r2, info = refine_routing(
            topo,
            scenario.demand,
            r,
            max_moves=refine_max_moves,
            renew_in_chunks=renew_in_chunks,
            device=dev,
        )
        # Replan under an EXPLICIT reactive policy: the local search ranks
        # moves on reactive realized costs.
        refined_cost = _reactive_replan_cost(topo, r2, scenario.demand)
        refined_routing = r2
        refine_base_cost = float(info["cost_before"])
        refine_move_mix = dict(info["move_mix"])

    relay_baseline_cost = None
    if r.hop_depth > 1:
        one_hop = optimize_routing(topo, scenario.demand, max_hops=1)
        relay_baseline_cost = _reactive_replan_cost(
            topo, one_hop, scenario.demand
        )

    tree_unicast_cost = None
    if topo.groups:
        etopo, row_map = multicast_unicast_expansion(topo)
        d_uni = np.asarray(scenario.demand)[row_map]
        uni_routing = optimize_routing(etopo, d_uni, max_hops=1)
        tree_unicast_cost = _reactive_replan_cost(etopo, uni_routing, d_uni)

    rows: List[PortReport] = []
    for m, po in enumerate(topo.ports):
        requests, releases = toggle_events(state[m])
        rows.append(
            PortReport(
                name=po.name,
                facility=po.facility,
                n_pairs=int(n_pairs[m]),
                toggle_cost=float(toggle_cost[m]),
                static_vpn=float(static_vpn[m]),
                static_cci=float(static_cci[m]),
                oracle_cost=float(oracle[m]) if oracle is not None else None,
                on_fraction=float(np.mean(x[m])),
                requests=requests,
                releases=releases,
                forecast_cost=(
                    float(forecast_cost[m]) if forecast_cost is not None else None
                ),
            )
        )
    return TopologyReport(
        ports=tuple(rows),
        horizon=T,
        routing=r,
        dedicated_cost=dedicated_cost,
        refined_routing=refined_routing,
        refined_cost=refined_cost,
        refine_base_cost=refine_base_cost,
        refine_move_mix=refine_move_mix,
        relay_baseline_cost=relay_baseline_cost,
        tree_unicast_cost=tree_unicast_cost,
    )
