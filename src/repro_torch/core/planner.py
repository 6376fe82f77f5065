"""InterconnectPlanner — ToggleCCI driving the cross-pod collective mode.

Port of :mod:`repro.core.planner` (numpy and Python: a copy, with the
fleet factory pointing at the port's runtime). The framework's cross-pod
hop is a provisionable, separately priced link: *CCI mode* is a leased
dedicated link (hourly fee + flat $/GB), *VPN mode* the pay-per-GB path
(tiered egress pricing). Demand is the measured cross-pod traffic: the
gradient sync's wire bytes (:func:`repro_torch.dist.collectives.sync_wire_bytes`)
× steps per hour.

The planner runs the ToggleCCI FSM incrementally
(:class:`ToggleCCIController`, held against ``run_togglecci``) and actuates
through the collective layer: ON -> full-precision ``hierarchical`` sync
over the leased link; OFF/WAITING -> int8-compressed sync over the
pay-per-GB path (~4x fewer billed GB, the endogenous-demand loop).

:func:`cross_pod_bytes_per_step` parses XLA's compiled HLO in the JAX
package; its port waits for the HLO telemetry (ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from .pricing import CostParams, TieredRate
from .togglecci import OFF, ON, WAITING

# int8 payload + one f32 scale per 256-wide row: the billed-GB shrink factor
# of the compressed pay-per-GB path (shared by the single-link planner below
# and the fleet-level one in repro_torch.fleet.runtime).
COMPRESS_RATIO = 4.0 * (256.0 / 260.0)


def collective_mode(state: int) -> str:
    """Map one link's FSM state to its cross-pod collective mode.

    ON means the leased link serves traffic: full-precision hierarchical
    all-reduce. OFF/WAITING ride the pay-per-GB path: int8 + error-feedback
    compressed sync (``repro_torch.dist.collectives.sync_grads`` modes).
    """
    return "hierarchical" if state == ON else "compressed"


def dci_scenario(
    *,
    lease_per_hr: float = 48.0,       # dedicated 2x100G DCI pair lease
    dci_per_gb: float = 0.002,        # dedicated-link per-GB
    vpn_lease_per_hr: float = 1.2,    # commodity path standing charge
    vpn_tier: Optional[TieredRate] = None,
    **overrides,
) -> CostParams:
    """CostParams for the cross-pod interconnect (defaults: list-price-scale
    datacenter-interconnect economics; same structure as the paper's Eq. 2)."""
    tier = vpn_tier or TieredRate(
        bounds_gb=(10_240.0, 153_600.0, float("inf")), rates=(0.02, 0.015, 0.01)
    )
    return CostParams(
        L_cci=lease_per_hr,
        V_cci=0.0,
        c_cci=dci_per_gb,
        L_vpn=vpn_lease_per_hr,
        vpn_tier=tier,
        **overrides,
    )


class ToggleCCIController:
    """Incremental ToggleCCI FSM — one ``update()`` per hour tick.

    Semantically identical to ``run_togglecci``: start-of-hour cascade
    OFF->WAITING, WAITING->ON, ON->OFF over the same window costs; returns
    the state that *serves* the current hour.
    """

    def __init__(self, params: CostParams):
        self.p = params
        self.state = OFF
        self.t_state = 0
        self._win_vpn = collections.deque(maxlen=params.h)
        self._win_cci = collections.deque(maxlen=params.h)
        self.r_vpn = 0.0
        self.r_cci = 0.0
        self.month_cum_gb = 0.0
        self.hour = 0
        self.requests: list = []
        self.releases: list = []

    def hourly_costs(self, vpn_gb: float, cci_gb: Optional[float] = None, n_pairs: int = 1):
        """Counterfactual hourly costs. The two modes may carry *different*
        demand shapes (endogenous demand: the framework compresses on the
        pay-per-GB path), so each mode is priced on its own volume."""
        p = self.p
        cci_gb = vpn_gb if cci_gb is None else cci_gb
        if self.hour % p.hours_per_month == 0:
            self.month_cum_gb = 0.0
        vpn = n_pairs * p.L_vpn + p.vpn_tier.marginal_cost(self.month_cum_gb, vpn_gb)
        cci = p.L_cci + n_pairs * p.V_cci + p.c_cci * cci_gb
        self.month_cum_gb += vpn_gb
        return vpn, cci

    def update(self, vpn_cost: float, cci_cost: float) -> int:
        """Advance one hour given that hour's counterfactual mode costs.
        Returns the FSM state serving this hour (OFF/WAITING -> VPN path)."""
        p = self.p
        r_vpn, r_cci = self.r_vpn, self.r_cci  # window BEFORE this hour

        if self.state == OFF and r_cci < p.theta1 * r_vpn:
            self.state, self.t_state = WAITING, 0
            self.requests.append(self.hour)
        if self.state == WAITING and self.t_state >= p.D:
            self.state, self.t_state = ON, 0
        if (
            self.state == ON
            and self.t_state >= p.T_cci
            and r_cci > p.theta2 * r_vpn
        ):
            self.state, self.t_state = OFF, 0
            self.releases.append(self.hour)

        served = self.state
        self.t_state += 1
        self.hour += 1
        # Slide the window.
        if len(self._win_vpn) == p.h:
            self.r_vpn -= self._win_vpn[0]
            self.r_cci -= self._win_cci[0]
        self._win_vpn.append(vpn_cost)
        self._win_cci.append(cci_cost)
        self.r_vpn += vpn_cost
        self.r_cci += cci_cost
        return served


@dataclasses.dataclass
class PlannerReport:
    hours: int
    total_cost: float
    cost_always_vpn: float
    cost_always_cci: float
    on_fraction: float
    compressed_fraction: float
    total_gb: float
    requests: list
    releases: list


class InterconnectPlanner:
    """Hour-tick planner driving the cross-pod collective mode.

    ``feed_hour(bytes)`` per hour; the ``mode`` property maps the FSM state
    to the collective layer: ON -> ``'hierarchical'`` (leased link, full
    precision), else ``'compressed'`` (pay-per-GB path, int8 + error
    feedback). Compression shrinks billed demand by ``COMPRESS_RATIO``
    (int8 + scales ~ 3.94x).
    """

    COMPRESS_RATIO = COMPRESS_RATIO  # int8 payload + f32 scale per 256

    def __init__(self, params: Optional[CostParams] = None):
        self.params = params or dci_scenario()
        self.ctl = ToggleCCIController(self.params)
        self.cost = 0.0
        self.cost_vpn_only = 0.0
        self.cost_cci_only = 0.0
        self.gb = 0.0
        self.on_hours = 0
        self.compressed_hours = 0
        self._vpn_ctl_cum = 0.0

    @property
    def mode(self) -> str:
        return collective_mode(self.ctl.state)

    def feed_hour(self, cross_pod_bytes: float) -> str:
        """Account one hour of measured cross-pod traffic; returns the
        collective mode for the NEXT hour.

        Each mode's counterfactual is priced on its own demand shape: the
        VPN path carries int8-compressed collectives (~4x fewer billed GB),
        the leased link full precision (pricing both on the served volume
        traps the controller ON). The static-VPN comparator's tier state
        resets on the monthly calendar.
        """
        raw_gb = cross_pod_bytes / 1e9
        if self.ctl.hour % self.params.hours_per_month == 0:
            self._vpn_ctl_cum = 0.0
        vpn_cost, cci_cost = self.ctl.hourly_costs(
            raw_gb / self.COMPRESS_RATIO, raw_gb
        )
        state = self.ctl.update(vpn_cost, cci_cost)
        self.cost += cci_cost if state == ON else vpn_cost
        # Static comparators (both billed at their own demand shapes).
        p = self.params
        self.cost_vpn_only += p.L_vpn + p.vpn_tier.marginal_cost(
            self._vpn_ctl_cum, raw_gb / self.COMPRESS_RATIO
        )
        self._vpn_ctl_cum += raw_gb / self.COMPRESS_RATIO
        self.cost_cci_only += p.L_cci + p.V_cci + p.c_cci * raw_gb
        self.gb += raw_gb if state == ON else raw_gb / self.COMPRESS_RATIO
        if state == ON:
            self.on_hours += 1
        else:
            self.compressed_hours += 1
        return self.mode

    def report(self) -> PlannerReport:
        h = self.ctl.hour
        return PlannerReport(
            hours=h,
            total_cost=self.cost,
            cost_always_vpn=self.cost_vpn_only,
            cost_always_cci=self.cost_cci_only,
            on_fraction=self.on_hours / max(1, h),
            compressed_fraction=self.compressed_hours / max(1, h),
            total_gb=self.gb,
            requests=list(self.ctl.requests),
            releases=list(self.ctl.releases),
        )


def fleet_planner(fleet, **kw):
    """N-row generalization of :class:`InterconnectPlanner`: a
    :class:`repro_torch.fleet.runtime.ElasticFleetPlanner` over ``fleet``,
    every row stepped in one chunk of the streaming runtime: a
    ``FleetSpec``/``FleetArrays`` (per-link actuation) or a ``TopologySpec``
    with ``routing=``/routed ``TopologyArrays`` (per-port leases, per-pair
    modes). ``device=``, ``routing=`` and the runtime's other keywords pass
    through. Behind a factory so ``core`` keeps no import edge onto
    ``fleet`` (which imports ``core``)."""
    from repro_torch.fleet.runtime import ElasticFleetPlanner

    return ElasticFleetPlanner(fleet, **kw)


def cross_pod_bytes_per_step(hlo_text: str, *, pod_axis_size: int = 2) -> float:
    """Not ported: the JAX package estimates cross-pod bytes from compiled
    XLA HLO; the port's HLO/trace telemetry is ROADMAP Queue 1, item 12.
    Use :func:`repro_torch.dist.collectives.sync_wire_bytes` for the
    gradient sync's bytes."""
    raise NotImplementedError(
        "not ported to repro_torch yet: cross_pod_bytes_per_step parses XLA HLO "
        "(the telemetry of ROADMAP Queue 1, item 12)")
