"""Fleet scenario builder: heterogeneous links + mixed-family demand.

The paper evaluates three workloads one link at a time; this builder
composes a *portfolio*: every link draws

* a pricing scenario (cloud pair, direction, colocation distance, VLAN size,
  GCP egress tier) via :func:`repro_torch.core.pricing.make_scenario`;
* its own ToggleCCI operating point (D, T_cci, h, θ₁/θ₂) — the fleet engine
  treats them as array operands, so heterogeneity is free;
* a linksim-calibrated capacity ceiling (VLAN elastic-upward burst capped by
  the hard CCI link rate — findings F1/F3 of §IV);
* one column of a demand-trace family: ``constant`` / ``bursty`` (synthetic,
  §VII-D), ``mirage`` (mobile users, §VII-B), ``puffer`` (live video,
  §VII-C). Family generators emit their natural (T, n_links-of-family)
  matrices which are assigned column-per-link — no more collapsing to a
  single pair.

Demand is scaled per link to sit at ``demand_scale`` x the link's breakeven
rate (log-normal spread), so a fleet contains always-VPN links, always-CCI
links, and the interesting toggling middle.

Port of :mod:`repro.fleet.scenario`: the functions are copied verbatim
(numpy only), so with the same seed the numpy random generator is consumed
in the same order and both packages build the same demand bits and the same
per-link :class:`CostParams`, ports and pairs. The topology builders
(:func:`build_topology_scenario`, :func:`build_relay_scenario`,
:func:`build_multicast_scenario`) compose facilities, shared ports and
region pairs (paper §VII-A); :func:`build_reroute_scenario` is the regime
swap the streaming runtime's live re-routing is measured on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pricing import CostParams, breakeven_rate_gb_per_hour, make_scenario
from repro_torch.traffic import linksim
from repro_torch.traffic.mirage import mirage_trace
from repro_torch.traffic.puffer import puffer_trace
from repro_torch.traffic.traces import bursty_trace, constant_trace

from .spec import FleetSpec, LinkSpec
from .topology import (
    MulticastSpec,
    PairSpec,
    PathSpec,
    PortSpec,
    TopologySpec,
)

GB_PER_GBPS_HOUR = 450.0  # 1 Gbps sustained for one hour = 450 GB

FAMILIES = ("constant", "bursty", "mirage", "puffer")

_CLOUD_PAIRS = (("gcp", "aws"), ("aws", "gcp"), ("gcp", "azure"), ("azure", "gcp"))
_VLAN_CHOICES = (1, 2, 5, 10)


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """A fleet plus its (N, T) demand matrix and per-link metadata.

    ``history`` is an optional (N, H) warm-up demand block drawn from the
    SAME trace columns, strictly BEFORE the planning horizon — the training
    input of the forecast-gated toggle policy
    (:func:`repro.fleet.policy.forecast_fleet_policy`), kept disjoint so
    forecasts stay causal.
    """

    fleet: FleetSpec
    demand: np.ndarray          # (N, T) GB/hour
    horizon: int
    history: Optional[np.ndarray] = None  # (N, H) GB/hour, hours < 0

    @property
    def n_links(self) -> int:
        return len(self.fleet)

    def summary(self) -> Dict[str, int]:
        by_family: Dict[str, int] = {}
        for l in self.fleet.links:
            by_family[l.family] = by_family.get(l.family, 0) + 1
        return by_family


def link_capacity_gb_hr(vlan_gbps: int) -> float:
    """Physical ceiling of one link's demand path (linksim findings F1/F3):
    the VLAN bursts elastically up to +70% of nominal but the CCI link is a
    hard cap at nominal minus L2+L4 overhead."""
    vlan_cap = linksim.vlan_access_capacity_gbps(vlan_gbps)
    cci_cap = linksim.cci_port_capacity_gbps()
    return min(vlan_cap, cci_cap) * GB_PER_GBPS_HOUR


def port_capacity_gb_hr(nominal_gbps: float = linksim.CCI_NOMINAL_GBPS) -> float:
    """Hard CCI ceiling of one shared colocation port (GB/hour, finding F1)."""
    return linksim.cci_port_capacity_gbps(nominal_gbps) * GB_PER_GBPS_HOUR


def vlan_access_gb_hr(vlan_gbps: int) -> float:
    """Elastic VLAN-attachment access ceiling of one pair (GB/hour, F3)."""
    return linksim.vlan_access_capacity_gbps(vlan_gbps) * GB_PER_GBPS_HOUR


def _sample_params(rng: np.random.Generator) -> Tuple[CostParams, int]:
    src, dst = _CLOUD_PAIRS[rng.integers(len(_CLOUD_PAIRS))]
    vlan = int(_VLAN_CHOICES[rng.integers(len(_VLAN_CHOICES))])
    theta1 = float(rng.uniform(0.85, 0.95))
    params = make_scenario(
        src,
        dst,
        intercontinental=bool(rng.random() < 0.25),
        colocation_far=bool(rng.random() < 0.2),
        vlan_gbps=vlan,
        gcp_tier="premium" if rng.random() < 0.7 else "standard",
        D=int(rng.integers(24, 97)),
        T_cci=int(rng.integers(72, 337)),
        h=int(rng.integers(72, 337)),
        theta1=theta1,
        theta2=float(rng.uniform(1.05, 1.2)),
    )
    return params, vlan


def _family_columns(
    family: str, n: int, horizon: int, rng: np.random.Generator
) -> np.ndarray:
    """(horizon, n) raw demand columns for one family group."""
    if n == 0:
        return np.zeros((horizon, 0))
    days = math.ceil(horizon / 24)
    seed = int(rng.integers(2**31))
    if family == "constant":
        cols = np.concatenate(
            [constant_trace(1.0, horizon=horizon, n_pairs=1) for _ in range(n)],
            axis=1,
        )
    elif family == "bursty":
        cols = np.concatenate(
            [
                bursty_trace(horizon=horizon, n_pairs=1, seed=seed + i)
                for i in range(n)
            ],
            axis=1,
        )
    elif family == "mirage":
        cols = mirage_trace(
            n_users=2000 * n, horizon_days=days, n_pairs=n, seed=seed
        )[:horizon]
    elif family == "puffer":
        cols = puffer_trace(horizon_days=days, n_channels=n, seed=seed)[:horizon]
    else:
        raise ValueError(f"unknown family {family!r}")
    return cols


def build_fleet_scenario(
    n_links: int,
    *,
    horizon: int = 8760,
    history_hours: int = 0,
    seed: int = 0,
    families: Sequence[str] = FAMILIES,
    demand_scale: float = 1.0,
) -> FleetScenario:
    """Sample an ``n_links``-strong heterogeneous portfolio.

    Each link's demand column is rescaled to mean ``demand_scale x`` a
    log-normal multiple of its breakeven rate, then clipped (by the engine)
    at the link's physical capacity. ``history_hours > 0`` prepends that
    many warm-up hours to every trace and returns them separately as
    ``scenario.history`` — forecaster training data disjoint from the
    planning horizon.
    """
    assert n_links >= 1 and horizon >= 24 and history_hours >= 0
    rng = np.random.default_rng(seed)
    families = tuple(families)
    fam_of = [families[i % len(families)] for i in range(n_links)]
    total = horizon + history_hours

    links, cols = [], []
    # Family groups emit their natural (T, n_family) matrices; links then
    # take columns — the multi-pair structure the paper's consumers dropped.
    group_cols = {
        fam: _family_columns(fam, fam_of.count(fam), total, rng)
        for fam in families
    }
    taken = {fam: 0 for fam in families}
    for i in range(n_links):
        fam = fam_of[i]
        params, vlan = _sample_params(rng)
        cap = link_capacity_gb_hr(vlan)
        col = group_cols[fam][:, taken[fam]]
        taken[fam] += 1

        target = (
            breakeven_rate_gb_per_hour(params)
            * demand_scale
            * float(rng.lognormal(0.0, 0.7))
        )
        mean = col.mean()
        col = col * (target / mean) if mean > 0 else np.full(total, target)
        links.append(
            LinkSpec(
                name=f"{fam}-{i:03d}",
                params=params,
                capacity_gb_hr=cap,
                family=fam,
            )
        )
        cols.append(col)

    full = np.stack(cols)  # (N, history + horizon)
    return FleetScenario(
        fleet=FleetSpec(tuple(links)),
        demand=full[:, history_hours:],
        horizon=horizon,
        history=full[:, :history_hours] if history_hours else None,
    )


# ---------------------------------------------------------------------------
# Multi-pair topology scenarios (paper §VII-A: pairs sharing CCI ports)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyScenario:
    """A port/facility topology plus its (P, T) per-pair demand matrix.

    ``history`` (optional, (P, H)) holds warm-up hours strictly before the
    horizon — per-pair demand the forecast-gated policy aggregates onto
    ports and trains its SSM head on
    (the JAX package's ``forecast_topology_policy``).
    """

    topo: TopologySpec
    demand: np.ndarray          # (P, T) GB/hour per region pair
    horizon: int
    history: Optional[np.ndarray] = None  # (P, H) GB/hour, hours < 0

    @property
    def n_pairs(self) -> int:
        return self.topo.n_pairs

    @property
    def n_ports(self) -> int:
        return self.topo.n_ports

    def summary(self) -> Dict[str, int]:
        by_family: Dict[str, int] = {}
        for pr in self.topo.pairs:
            by_family[pr.family] = by_family.get(pr.family, 0) + 1
        return by_family


def _sample_port(
    rng: np.random.Generator, name: str, facility: str, cloud: str
) -> PortSpec:
    """One candidate CCI port: catalog pricing + a sampled toggle point."""
    from repro_torch.core.pricing import AWS_DX_PORT_100G_HR, GCP_CCI_PORT_100G_HR

    vlan = int(_VLAN_CHOICES[rng.integers(len(_VLAN_CHOICES))])
    base = make_scenario(
        "gcp", cloud, colocation_far=bool(rng.random() < 0.2), vlan_gbps=vlan
    )
    # A quarter of AWS-side facilities offer a 100G port: 8x the lease for
    # 10x the hard capacity — the sharing-friendly choice for hot facilities.
    if cloud == "aws" and rng.random() < 0.25:
        L_cci, cap = GCP_CCI_PORT_100G_HR + AWS_DX_PORT_100G_HR, port_capacity_gb_hr(100.0)
    else:
        L_cci, cap = base.L_cci, port_capacity_gb_hr()
    return PortSpec(
        name=name,
        facility=facility,
        cloud=cloud,
        L_cci=L_cci,
        V_cci=base.V_cci,
        c_cci=base.c_cci,
        capacity_gb_hr=cap,
        D=int(rng.integers(24, 97)),
        T_cci=int(rng.integers(72, 337)),
        h=int(rng.integers(72, 337)),
        theta1=float(rng.uniform(0.85, 0.95)),
        theta2=float(rng.uniform(1.05, 1.2)),
    )


def build_topology_scenario(
    n_pairs: int,
    *,
    n_facilities: int = 3,
    ports_per_facility: int = 2,
    reach: int = 2,
    horizon: int = 8760,
    history_hours: int = 0,
    seed: int = 0,
    families: Sequence[str] = FAMILIES,
    demand_scale: float = 1.0,
) -> TopologyScenario:
    """Sample a multi-pair topology: facilities -> candidate ports -> pairs.

    Facilities alternate the non-GCP cloud they host (AWS/Azure) and expose
    ``ports_per_facility`` candidate CCI ports each (10G catalog pricing,
    occasionally 100G). Every region pair can reach the ports of up to
    ``reach`` facilities on its cloud pair — the candidate set
    :func:`repro_torch.fleet.topology.optimize_routing` packs leases over. Demand
    reuses the four trace families of :func:`build_fleet_scenario`, scaled
    per pair against the breakeven rate of its first candidate port ridden
    ALONE (so sharing strictly improves on the per-link economics).
    """
    assert n_pairs >= 1 and n_facilities >= 1 and ports_per_facility >= 1
    assert horizon >= 24 and reach >= 1 and history_hours >= 0
    rng = np.random.default_rng(seed)
    families = tuple(families)
    fam_of = [families[i % len(families)] for i in range(n_pairs)]
    total = horizon + history_hours

    clouds = ("aws", "azure") if n_facilities >= 2 else ("aws",)
    ports = []
    for j in range(n_facilities):
        fac = f"fac{j:02d}"
        cloud = clouds[j % len(clouds)]
        for k in range(ports_per_facility):
            ports.append(
                _sample_port(rng, f"{fac}-{cloud}-p{k}", fac, cloud)
            )
    by_cloud = {
        c: [j for j, po in enumerate(ports) if po.cloud == c] for c in clouds
    }

    group_cols = {
        fam: _family_columns(fam, fam_of.count(fam), total, rng)
        for fam in families
    }
    taken = {fam: 0 for fam in families}

    pairs, cols = [], []
    for i in range(n_pairs):
        fam = fam_of[i]
        src, dst = _CLOUD_PAIRS[rng.integers(len(_CLOUD_PAIRS))]
        other = dst if src == "gcp" else src
        if other not in by_cloud:
            other = clouds[0]
            src, dst = ("gcp", other) if src == "gcp" else (other, "gcp")
        vlan = int(_VLAN_CHOICES[rng.integers(len(_VLAN_CHOICES))])
        params = make_scenario(
            src,
            dst,
            intercontinental=bool(rng.random() < 0.25),
            vlan_gbps=vlan,
            gcp_tier="premium" if rng.random() < 0.7 else "standard",
        )
        # Candidate ports: every port at <= `reach` facilities of the
        # pair's cloud (region pairs only meet at facilities both clouds
        # populate — the facility-graph edge set).
        facs = sorted({ports[j].facility for j in by_cloud[other]})
        n_reach = min(reach, len(facs))
        chosen = set(
            np.array(facs)[rng.permutation(len(facs))[:n_reach]].tolist()
        )
        candidates = tuple(
            j for j in by_cloud[other] if ports[j].facility in chosen
        )
        pairs.append(
            PairSpec(
                name=f"{fam}-{i:03d}",
                src=src,
                dst=dst,
                L_vpn=params.L_vpn,
                vpn_tier=params.vpn_tier,
                capacity_gb_hr=vlan_access_gb_hr(vlan),
                candidates=candidates,
                family=fam,
            )
        )

        col = group_cols[fam][:, taken[fam]]
        taken[fam] += 1
        po = ports[candidates[0]]
        solo = CostParams(
            L_cci=po.L_cci,
            V_cci=po.V_cci,
            c_cci=po.c_cci,
            L_vpn=params.L_vpn,
            vpn_tier=params.vpn_tier,
        )
        target = (
            breakeven_rate_gb_per_hour(solo)
            * demand_scale
            * float(rng.lognormal(0.0, 0.7))
        )
        mean = col.mean()
        col = col * (target / mean) if mean > 0 else np.full(total, target)
        cols.append(col)

    full = np.stack(cols)  # (P, history + horizon)
    return TopologyScenario(
        topo=TopologySpec(ports=tuple(ports), pairs=tuple(pairs)),
        demand=full[:, history_hours:],
        horizon=horizon,
        history=full[:, :history_hours] if history_hours else None,
    )


def build_reroute_scenario(
    *, horizon: int = 2000, shift_hour: int = 800, seed: int = 0
) -> TopologyScenario:
    """A live re-routing scenario: a hot pair outgrows its spill port.

    Three pairs, two ports. The ``hub`` port has dedicated-link unit
    economics (low $/GB); the ``spill`` port is 10x more expensive per GB.
    ``anchor`` and ``fading`` fill the hub to its capacity headroom, so the
    greedy packer must park ``hot`` (initially tiny) on the spill port. At
    ``shift_hour`` the regimes swap: ``fading`` collapses and ``hot`` ramps
    ~25x — the hub now has room, and migrating ``hot`` onto it saves the
    spill port's lease AND the 10x transfer premium. A planner that
    re-routes on streamed state catches the migration mid-stream
    (:meth:`repro_torch.fleet.runtime.FleetRuntime.reroute`); a frozen
    routing keeps paying the spill premium for the rest of the horizon.
    """
    from repro_torch.core.pricing import flat_rate

    if not 24 <= shift_hour < horizon:
        raise ValueError(f"need 24 <= shift_hour < horizon, got {shift_hour}, {horizon}")
    rng = np.random.default_rng(seed)
    mk_port = lambda name, fac, c_gb: PortSpec(
        name=name, facility=fac, cloud="aws",
        L_cci=4.55, V_cci=0.1, c_cci=c_gb,
        capacity_gb_hr=port_capacity_gb_hr(),
        D=48, T_cci=168, h=96, theta1=0.9, theta2=1.1,
    )
    mk_pair = lambda name, cands: PairSpec(
        name=name, src="gcp", dst="aws", L_vpn=0.105,
        vpn_tier=flat_rate(0.08),
        capacity_gb_hr=vlan_access_gb_hr(10),
        candidates=cands, family="constant",
    )
    topo = TopologySpec(
        ports=(mk_port("hub-aws-p0", "fac-hub", 0.002),
               mk_port("spill-aws-p0", "fac-spill", 0.02)),
        pairs=(mk_pair("anchor", (0,)),
               mk_pair("fading", (0,)),
               mk_pair("hot", (0, 1))),
    )
    before = np.array([1800.0, 1800.0, 50.0])
    after = np.array([1800.0, 100.0, 1200.0])
    demand = np.empty((3, horizon))
    demand[:, :shift_hour] = before[:, None]
    demand[:, shift_hour:] = after[:, None]
    demand *= rng.uniform(0.97, 1.03, size=demand.shape)  # mild jitter
    return TopologyScenario(topo=topo, demand=demand, horizon=horizon)


# ---------------------------------------------------------------------------
# Multi-hop relay and multicast scenarios (overlay routing / replication)
# ---------------------------------------------------------------------------


def broadcast_burst_trace(
    horizon: int,
    n_groups: int = 1,
    *,
    period: int = 168,
    burst_hours: int = 8,
    base_gb_hr: float = 25.0,
    burst_gb: float = 20_000.0,
    seed: int = 0,
) -> np.ndarray:
    """(T, n_groups) replication-push demand: model-weight / CDN-fill drops.

    Each group idles at ``base_gb_hr`` (config churn, telemetry) and every
    ``period`` hours pushes a ``burst_gb`` artifact spread evenly over
    ``burst_hours`` — the point-to-multipoint workload a forwarding tree
    serves with ONE copy per shared edge. Drop phases are jittered per
    group so a portfolio of groups doesn't burst in lockstep.
    """
    assert horizon >= 1 and n_groups >= 0 and 1 <= burst_hours <= period
    rng = np.random.default_rng(seed)
    cols = np.full((horizon, n_groups), base_gb_hr)
    rate = burst_gb / burst_hours
    for g in range(n_groups):
        start = int(rng.integers(0, period))
        for t0 in range(start, horizon, period):
            t1 = min(t0 + burst_hours, horizon)
            cols[t0:t1, g] += rate * float(rng.uniform(0.9, 1.1))
    return cols


def build_relay_scenario(
    *, horizon: int = 2000, seed: int = 0, long_gb_hr: float = 800.0
) -> TopologyScenario:
    """A multi-hop overlay-routing scenario: the relay detour wins.

    Three ports, three demand rows. Two cheap ``hub`` ports (dedicated-link
    unit economics, $0.002/GB) are each pinned ON by an ``anchor`` pair;
    the ``direct`` port serving the long intercontinental pair charges a
    10x+ transfer premium ($0.025/GB) and a lease nobody else shares. The
    ``long`` row is a :class:`PathSpec` that may EITHER lease the direct
    port 1-hop OR compose the two already-hot hubs as a 2-hop relay path
    (CloudCast-style overlay detour): per hop it pays only the marginal
    attachment + cheap per-GB rate, and the hub leases are already bought.
    The hop-aware :func:`repro_torch.fleet.topology.optimize_routing` takes the
    relay; restricting it to ``max_hops=1`` forces the premium port — the
    measured ``relay_savings`` gap ``build_topology_report`` reports and
    the topology bench gates.
    """
    from repro_torch.core.pricing import flat_rate

    rng = np.random.default_rng(seed)
    mk_port = lambda name, fac, c_gb: PortSpec(
        name=name, facility=fac, cloud="aws",
        L_cci=4.55, V_cci=0.1, c_cci=c_gb,
        capacity_gb_hr=port_capacity_gb_hr(),
        D=48, T_cci=168, h=96, theta1=0.9, theta2=1.1,
    )
    mk_pair = lambda name, cands: PairSpec(
        name=name, src="gcp", dst="aws", L_vpn=0.105,
        vpn_tier=flat_rate(0.08),
        capacity_gb_hr=vlan_access_gb_hr(10),
        candidates=cands, family="constant",
    )
    topo = TopologySpec(
        ports=(mk_port("hub-a-p0", "fac-hub-a", 0.002),
               mk_port("hub-b-p0", "fac-hub-b", 0.002),
               mk_port("direct-p0", "fac-direct", 0.025)),
        pairs=(mk_pair("anchor-a", (0,)),
               mk_pair("anchor-b", (1,)),
               PathSpec(
                   name="long", src="gcp", dst="aws", L_vpn=0.105,
                   vpn_tier=flat_rate(0.08),
                   capacity_gb_hr=vlan_access_gb_hr(10),
                   candidates=(2,), relays=((0, 1),), family="constant",
               )),
    )
    demand = np.empty((3, horizon))
    demand[0] = 1800.0
    demand[1] = 1800.0
    demand[2] = long_gb_hr
    demand *= rng.uniform(0.97, 1.03, size=demand.shape)  # mild jitter
    return TopologyScenario(topo=topo, demand=demand, horizon=horizon)


def build_multicast_scenario(
    *, n_leaves: int = 4, horizon: int = 2000, seed: int = 0
) -> TopologyScenario:
    """A point-to-multipoint scenario: the forwarding tree's shared edge
    beats the per-leaf unicast expansion.

    One cheap ``hub`` port every leaf can reach (kept warm by an anchor
    pair) plus one pricier local port per leaf. The broadcast-burst group
    routed as a tree attaches the hub ONCE and its burst bytes are charged
    once; the unicast expansion pays ``n_leaves`` attachments and bills the
    same bytes ``n_leaves`` times — the ``tree_sharing_savings`` gap the
    report layer measures and ``examples/multicast_demo.py`` demos.
    """
    from repro_torch.core.pricing import flat_rate

    assert n_leaves >= 1
    rng = np.random.default_rng(seed)
    mk_port = lambda name, fac, c_gb: PortSpec(
        name=name, facility=fac, cloud="aws",
        L_cci=4.55, V_cci=0.1, c_cci=c_gb,
        capacity_gb_hr=port_capacity_gb_hr(100.0),
        D=48, T_cci=168, h=96, theta1=0.9, theta2=1.1,
    )
    ports = [mk_port("hub-p0", "fac-hub", 0.004)] + [
        mk_port(f"leaf{j}-p0", f"fac-leaf{j}", 0.02) for j in range(n_leaves)
    ]
    anchor = PairSpec(
        name="anchor", src="gcp", dst="aws", L_vpn=0.105,
        vpn_tier=flat_rate(0.08),
        capacity_gb_hr=vlan_access_gb_hr(10),
        candidates=(0,), family="constant",
    )
    group = MulticastSpec(
        name="weights-push", src="gcp",
        leaves=tuple(f"aws-leaf{j}" for j in range(n_leaves)),
        leaf_candidates=tuple((0, 1 + j) for j in range(n_leaves)),
        L_vpn=0.105, vpn_tier=flat_rate(0.08),
        capacity_gb_hr=vlan_access_gb_hr(10),
    )
    topo = TopologySpec(ports=tuple(ports), pairs=(anchor,), groups=(group,))
    demand = np.empty((2, horizon))
    demand[0] = 1500.0 * rng.uniform(0.97, 1.03, size=horizon)
    demand[1] = broadcast_burst_trace(horizon, 1, seed=seed + 1)[:, 0]
    return TopologyScenario(topo=topo, demand=demand, horizon=horizon)
