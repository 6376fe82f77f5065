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

Port of the fleet half of :mod:`repro.fleet.scenario`: the functions are
copied verbatim (numpy only), so with the same seed the numpy random
generator is consumed in the same order and both packages build the same
demand bits and the same per-link :class:`CostParams`. The topology
builders are not ported yet.
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
