"""Pricing catalogs for cross-cloud connectivity (paper §V, §VII-A).

All values are point-in-time *list-price snapshots* (July-2025) of the public
catalogs cited by the paper:

* AWS EC2 / internet egress ........ [46] https://aws.amazon.com/ec2/pricing/on-demand/
* AWS Direct Connect ............... [47] https://aws.amazon.com/directconnect/pricing/
* GCP CCI / interconnect ........... [38] cloud.google.com/network-connectivity/docs/interconnect/pricing
* GCP premium-tier egress .......... [48] cloud.google.com/vpc/network-pricing
* Azure ExpressRoute ............... [49] azure.microsoft.com/en-us/pricing/details/expressroute/
* Azure VPN gateway ................ [50] azure.microsoft.com/en-us/pricing/details/vpn-gateway/

The algorithms in :mod:`repro_torch.core` consume these values abstractly through
:class:`CostParams`, so catalog staleness affects absolute dollar figures only,
never the correctness of the reproduction (DESIGN.md §6.3).

Volumes are in **GB**, rates in **$/GB**, leases in **$/hour** — matching the
paper's hourly decision granularity.

A verbatim copy of :mod:`repro.core.pricing` (no array library at all): the
port imports nothing of the JAX package, so it keeps its own catalogs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

INF = math.inf

# ---------------------------------------------------------------------------
# Tiered (volume-dependent) per-GB rates — paper challenge (c): VPN uses tiered
# egress pricing where the per-GB cost decreases with monthly volume, while CCI
# has a flat per-GB cost.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TieredRate:
    """Piecewise-constant marginal $/GB rate over cumulative monthly volume.

    ``bounds_gb[i]`` is the *upper* cumulative-volume bound (GB) of tier ``i``;
    the last bound must be ``inf``.  ``rates[i]`` is the marginal rate inside
    tier ``i``.
    """

    bounds_gb: Tuple[float, ...]
    rates: Tuple[float, ...]

    def __post_init__(self) -> None:
        assert len(self.bounds_gb) == len(self.rates) >= 1
        assert self.bounds_gb[-1] == INF
        assert all(b2 > b1 for b1, b2 in zip(self.bounds_gb, self.bounds_gb[1:]))
        assert all(r >= 0 for r in self.rates)

    def marginal_cost(self, start_gb: float, added_gb: float) -> float:
        """$ cost of moving cumulative volume from start_gb to start_gb+added_gb."""
        if added_gb <= 0:
            return 0.0
        lo, total = float(start_gb), 0.0
        hi = lo + float(added_gb)
        prev_bound = 0.0
        for bound, rate in zip(self.bounds_gb, self.rates):
            seg = max(0.0, min(hi, bound) - max(lo, prev_bound))
            total += seg * rate
            prev_bound = bound
            if bound >= hi:
                break
        return total

    def flat(self) -> bool:
        return len(set(self.rates)) == 1


def flat_rate(rate: float) -> TieredRate:
    return TieredRate((INF,), (float(rate),))


# --- Internet egress catalogs (monthly cumulative tiers). VPN traffic is billed
# at the sending cloud's internet-egress tier rates (paper §III "VPN").
AWS_EGRESS_INTERNET = TieredRate(
    bounds_gb=(10_240.0, 51_200.0, 153_600.0, INF),
    rates=(0.09, 0.085, 0.07, 0.05),
)
GCP_EGRESS_PREMIUM = TieredRate(
    bounds_gb=(1_024.0, 10_240.0, INF),
    rates=(0.12, 0.11, 0.08),
)
GCP_EGRESS_STANDARD = TieredRate(
    bounds_gb=(10_240.0, 153_600.0, INF),
    rates=(0.085, 0.065, 0.045),
)
AZURE_EGRESS_INTERNET = TieredRate(
    bounds_gb=(10_240.0, 51_200.0, 153_600.0, INF),
    rates=(0.087, 0.083, 0.07, 0.05),
)

# --- Dedicated-link (CCI-style) per-GB egress: flat rate (paper §III "CCI").
GCP_CCI_EGRESS_INTRA_CONTINENT = 0.02  # $/GB, GCP interconnect egress EU/US
GCP_CCI_EGRESS_INTER_CONTINENT = 0.05  # $/GB, via GCP inter-continental backbone
AWS_DX_EGRESS = 0.02                   # $/GB, Direct Connect data-transfer-out
AZURE_ER_EGRESS = 0.025                # $/GB, ExpressRoute metered egress

# --- Hourly port leases. Paper §III: "Lease a physical port from BOTH Google
# and another cloud provider at the same colocation facility."
GCP_CCI_PORT_10G_HR = 2.30   # $/hr, CCI 10 Gbps port
GCP_CCI_PORT_100G_HR = 18.00
AWS_DX_PORT_10G_HR = 2.25    # $/hr, Direct Connect dedicated 10G port
AWS_DX_PORT_100G_HR = 16.20
AZURE_ER_PORT_10G_HR = 2.74  # $/hr, ExpressRoute Direct-equivalent share

# --- VLAN attachment / VIF hourly leases (per pair; paper §III "VLAN
# attachments ... incur an hourly charge based on the selected capacity").
GCP_VLAN_HR = {1: 0.10, 2: 0.16, 5: 0.26, 10: 0.42}   # Gbps -> $/hr
AWS_VIF_HR = 0.0  # AWS bills the DX port, VIFs are free
AZURE_VLAN_HR = {1: 0.12, 2: 0.18, 5: 0.30, 10: 0.46}

# --- VPN gateway/tunnel hourly leases (per pair).
GCP_VPN_TUNNEL_HR = 0.055
AWS_VPN_CONN_HR = 0.05
AZURE_VPN_GW_HR = 0.19

HOURS_PER_MONTH = 730  # tier accumulation window (paper: "from start of month")


# ---------------------------------------------------------------------------
# Scenario -> CostParams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostParams:
    """All parameters of the paper's Eq. (2) optimization problem.

    Leasing: CCI active at hour t costs ``L_cci`` (shared across the ``P_t``
    pairs using it) plus ``V_cci`` per pair; VPN costs ``L_vpn`` per pair.
    Transfer: CCI moves data at flat ``c_cci`` $/GB; VPN at the tiered
    ``vpn_tier`` rate over cumulative monthly volume.
    """

    L_cci: float                  # $/hr shared CCI lease (both ports)
    V_cci: float                  # $/hr per-pair VLAN attachment
    c_cci: float                  # $/GB flat CCI transfer rate
    L_vpn: float                  # $/hr per-pair VPN lease (both tunnel ends)
    vpn_tier: TieredRate          # $/GB tiered VPN transfer rate
    D: int = 72                   # provisioning delay, hours (paper §V)
    T_cci: int = 168              # minimum CCI lease commitment, hours
    h: int = 168                  # ToggleCCI sliding window, hours
    theta1: float = 0.9           # OFF->WAITING threshold
    theta2: float = 1.1           # ON->OFF threshold
    hours_per_month: int = HOURS_PER_MONTH

    def __post_init__(self) -> None:
        assert self.D >= 0 and self.T_cci >= 1 and self.h >= 1
        assert 0 < self.theta1 <= self.theta2


_CLOUDS = ("gcp", "aws", "azure")


def make_scenario(
    src: str = "gcp",
    dst: str = "aws",
    *,
    intercontinental: bool = False,
    colocation_far: bool = False,
    vlan_gbps: int = 10,
    gcp_tier: str = "premium",
    **overrides,
) -> CostParams:
    """Build :class:`CostParams` for a directional src->dst scenario.

    Mirrors the paper's evaluation settings: GCP<->AWS and GCP<->Azure, both
    directions, single- and multi-continent, near/far colocation (Fig. 9).
    """
    src, dst = src.lower(), dst.lower()
    assert src in _CLOUDS and dst in _CLOUDS and src != dst
    assert "gcp" in (src, dst), "CCI scenarios connect GCP to another cloud"
    other = dst if src == "gcp" else src

    # Shared CCI lease: one port on each side of the colocation facility.
    other_port = {"aws": AWS_DX_PORT_10G_HR, "azure": AZURE_ER_PORT_10G_HR}[other]
    L_cci = GCP_CCI_PORT_10G_HR + other_port

    # Per-pair attachment: GCP VLAN + other side's virtual circuit.
    other_vif = {"aws": AWS_VIF_HR, "azure": AZURE_VLAN_HR[vlan_gbps]}[other]
    V_cci = GCP_VLAN_HR[vlan_gbps] + other_vif

    # CCI per-GB: egress of the *sending* side over the dedicated link. A far
    # colocation adds the sender's inter-continental backbone rate (Fig. 9).
    if src == "gcp":
        c_cci = (
            GCP_CCI_EGRESS_INTER_CONTINENT
            if (intercontinental or colocation_far)
            else GCP_CCI_EGRESS_INTRA_CONTINENT
        )
    else:
        c_cci = {"aws": AWS_DX_EGRESS, "azure": AZURE_ER_EGRESS}[src]
        if intercontinental or colocation_far:
            c_cci += 0.02  # sender backbone adder to reach the far colocation

    # VPN: tunnel lease on both ends; transfer billed at the sender's tiered
    # internet-egress catalog.
    lease = {"gcp": GCP_VPN_TUNNEL_HR, "aws": AWS_VPN_CONN_HR, "azure": AZURE_VPN_GW_HR}
    L_vpn = lease[src] + lease[dst]
    tier = {
        "gcp": GCP_EGRESS_PREMIUM if gcp_tier == "premium" else GCP_EGRESS_STANDARD,
        "aws": AWS_EGRESS_INTERNET,
        "azure": AZURE_EGRESS_INTERNET,
    }[src]
    if intercontinental:
        # Inter-continental internet egress: first tier carries a premium.
        tier = TieredRate(tier.bounds_gb, tuple(r + 0.03 for r in tier.rates))

    return CostParams(
        L_cci=L_cci, V_cci=V_cci, c_cci=c_cci, L_vpn=L_vpn, vpn_tier=tier, **overrides
    )


def breakeven_rate_gb_per_hour(params: CostParams, n_pairs: int = 1) -> float:
    """Constant-rate demand (GB/h, aggregate) at which steady-state hourly VPN
    and CCI costs are equal — used to position the paper's breakeven sweeps
    (Figs. 6, 11). Uses the *top* (cheapest-reached) VPN tier the steady rate
    sustains, solving the fixed point numerically.
    """
    lo, hi = 0.0, 1e9
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        month_gb = mid * params.hours_per_month
        vpn_rate = (
            params.vpn_tier.marginal_cost(0.0, month_gb) / month_gb
            if month_gb > 0
            else params.vpn_tier.rates[0]
        )
        vpn_hr = n_pairs * params.L_vpn + vpn_rate * mid
        cci_hr = params.L_cci + n_pairs * params.V_cci + params.c_cci * mid
        if cci_hr > vpn_hr:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)
