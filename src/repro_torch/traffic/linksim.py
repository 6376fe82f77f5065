"""Link simulator calibrated to the paper's hands-on measurements (§IV).

The live AWS/GCP testbed cannot be re-run offline (DESIGN.md §2), so every
*measured, often undocumented* behaviour the paper reports is encoded here as
an executable model. The benchmark `bench_measurements` regenerates the
paper's Figs. 2-4 from this simulator, and tests assert each finding:

  F1  CCI links NEVER exceed nominal capacity; at saturation they deliver
      nominal minus ~5% L2+L4 overhead (physical resource).
  F2  VM NICs are elastic: short-lived bursty traffic can reach ~2x nominal;
      throttling converges to nominal after a 3-5 min warm-up (faster when
      both endpoints are in the same cloud).
  F3  VLAN attachments are elastic upward only: bursts reach up to +70%,
      never below nominal.
  F4  Overbooked VLANs sharing a CCI link get max-min fair shares of the
      link; TCP connections within a VLAN share fairly too.
  F5  AWS Site-to-Site VPN tunnels cap at 1.25 Gbps; gateway auto-scaling
      needs >= 5 min of sustained high volume, so shorter experiments see
      far less; short-lived flows can *exceed* the cap before throttling
      engages.
  F6  Public-Internet egress from a VM caps at ~7 Gbps even when the same
      NIC can fill a 10 Gbps CCI.
  F7  Inter-continent throughput drops consistently with the
      bandwidth-delay product (per-connection TCP window / RTT).
  F8  Standard-tier Internet can occasionally beat premium tier
      intra-continent (hand-off-point routing asymmetry); never intra-region.

All rates are Gbps; time steps are 1 second.

A verbatim copy of :mod:`repro.traffic.linksim` (numpy only): the port imports nothing
of the JAX package, so the same random streams are consumed in the same
order and the two packages build identical scenarios.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# --- Calibration constants (from the paper's testbed, §IV-B/C/D) -----------
CCI_NOMINAL_GBPS = 10.0
CCI_OVERHEAD = 0.05            # L2+L4 framing overhead at saturation
VPN_TUNNEL_CAP_GBPS = 1.25     # AWS Site-to-Site quota [43]
VPN_COLD_GBPS = 0.45           # pre-autoscale gateway capacity (Fig. 2)
VPN_AUTOSCALE_S = 300          # >= 5 min sustained before scaling (§IV-C)
VPN_SHORT_FLOW_S = 60          # short flows dodge throttling briefly
INTERNET_EGRESS_CAP_GBPS = 7.0 # §IV-D "egress Public Internet capped at 7 Gbps"
NIC_BURST_FACTOR = 2.0         # §IV-A: 4.16 Gbps on a nominal 2 Gbps NIC
VLAN_BURST_FACTOR = 1.7        # §IV-A: up to 70% above nominal
WARMUP_RANGE_S = (180, 300)    # throttling "kicks in after ... 3-5 minutes"
SINGLE_CLOUD_WARMUP_S = (20, 60)  # converges much faster in a single cloud

RTT_MS = {"intra_region": 2.0, "intra_continent": 28.0, "inter_continent": 85.0}
TCP_WINDOW_BYTES = 3 * 2**20   # iperf default-ish per-connection window


def cci_port_capacity_gbps(nominal_gbps: float = CCI_NOMINAL_GBPS) -> float:
    """Hard deliverable rate of one CCI port at saturation (finding F1):
    nominal minus the measured L2+L4 framing overhead. This is the ceiling
    the fleet/topology planners use for a shared colocation port — VLAN
    attachments burst elastically (F3), the port itself never does."""
    return nominal_gbps * (1.0 - CCI_OVERHEAD)


def vlan_access_capacity_gbps(vlan_nominal_gbps: float) -> float:
    """Elastic-upward ceiling of one VLAN attachment (finding F3): bursts
    reach up to +70% of nominal, never below."""
    return vlan_nominal_gbps * VLAN_BURST_FACTOR


def max_min_fair(demands: Sequence[float], capacity: float) -> np.ndarray:
    """Classic water-filling max-min fair allocation (finding F4).

    Guaranteed termination in <= n rounds: each round either fully satisfies
    at least one active flow (remaining demand <= the equal share) and
    removes it, or no flow saturates — then every active flow receives the
    equal share and the capacity is exhausted. (The previous implementation
    relied on ``np.isclose`` firing against the *original* demands, which
    never happens for equal tiny demands left marginally unmet by rounding —
    an infinite loop.)
    """
    demands = np.asarray(demands, dtype=np.float64)
    assert (demands >= 0).all() and capacity >= 0
    alloc = np.zeros_like(demands)
    active = demands > 0
    cap = float(capacity)
    for _ in range(demands.size):
        if not active.any() or cap <= 1e-12:
            break
        share = cap / active.sum()
        rem = demands - alloc
        sat = active & (rem <= share)
        if not sat.any():
            # Nobody saturates: the link is the bottleneck — equal shares.
            alloc[active] += share
            cap = 0.0
            break
        alloc[sat] = demands[sat]
        cap -= rem[sat].sum()
        active &= ~sat
    return alloc


@dataclasses.dataclass(frozen=True)
class Flow:
    """One iperf-style measurement flow."""
    n_connections: int = 10
    per_conn_target_gbps: float = 1.0   # -b per-connection limit
    duration_s: int = 330
    vlan_index: int = 0

    @property
    def offered_gbps(self) -> float:
        return self.n_connections * self.per_conn_target_gbps


@dataclasses.dataclass(frozen=True)
class PathConfig:
    connectivity: str              # 'cci' | 'vpn' | 'internet_std' | 'internet_prem'
    colocation: str = "intra_region"   # | 'intra_continent' | 'inter_continent'
    direction: str = "gcp_to_aws"      # | 'aws_to_gcp' (egress policies differ)
    nic_nominal_gbps: float = 12.0     # sender VM NIC (m5.12xlarge: 12 Gbps)
    cci_nominal_gbps: float = CCI_NOMINAL_GBPS
    vlan_nominal_gbps: Sequence[float] = (10.0,)
    single_cloud: bool = False


def _bdp_cap_gbps(rtt_ms: float, n_connections: int) -> float:
    """Finding F7: per-connection window/RTT limit, summed over connections."""
    per_conn = TCP_WINDOW_BYTES * 8.0 / (rtt_ms * 1e-3) / 1e9
    return per_conn * n_connections


def simulate(
    path: PathConfig,
    flows: Sequence[Flow],
    *,
    seed: int = 0,
    return_timeseries: bool = False,
):
    """Simulate concurrent flows over one path; returns per-flow mean Gbps.

    Time-stepped at 1 s. Encodes findings F1-F8; all stochastic components
    (warm-up durations, routing jitter) derive from ``seed``.
    """
    rng = np.random.default_rng(seed)
    T = max(f.duration_s for f in flows)
    n = len(flows)
    rtt = RTT_MS[path.colocation]

    # Stochastic warm-up horizons (F2/F3/F5).
    lo, hi = SINGLE_CLOUD_WARMUP_S if path.single_cloud else WARMUP_RANGE_S
    nic_warmup = rng.integers(lo, hi + 1)
    vlan_warmup = rng.integers(lo, hi + 1)
    vpn_throttle_start = rng.integers(30, VPN_SHORT_FLOW_S + 30)

    # Tier routing asymmetry (F8): standard tier hands off to the destination
    # backbone early; intra-continent, when sending GCP->AWS, the AWS backbone
    # occasionally carries it faster than GCP premium would.
    tier_bias = 1.0
    if path.connectivity == "internet_std" and path.colocation == "intra_continent":
        tier_bias = rng.uniform(0.95, 1.12) if path.direction == "gcp_to_aws" else rng.uniform(0.9, 1.02)
    elif path.connectivity == "internet_std":
        tier_bias = rng.uniform(0.90, 1.0)

    series = np.zeros((T, n))
    for t in range(T):
        active = np.array([t < f.duration_s for f in flows])
        offered = np.array([f.offered_gbps if a else 0.0 for f, a in zip(flows, active)])
        # Per-flow BDP ceiling (F7).
        bdp = np.array([_bdp_cap_gbps(rtt, f.n_connections) for f in flows])
        want = np.minimum(offered, bdp)

        # Sender NIC (F2): elastic above nominal early, converges to nominal.
        nic_cap = path.nic_nominal_gbps * (NIC_BURST_FACTOR if t < nic_warmup else 1.0)
        if path.connectivity in ("internet_std", "internet_prem"):
            nic_cap = min(nic_cap, INTERNET_EGRESS_CAP_GBPS)  # F6

        if path.connectivity == "cci":
            # VLAN stage (F3): per-VLAN elastic-upward caps.
            vlan_caps = np.array(
                [
                    path.vlan_nominal_gbps[f.vlan_index]
                    * (VLAN_BURST_FACTOR if t < vlan_warmup else 1.0)
                    for f in flows
                ]
            )
            want = np.minimum(want, vlan_caps)
            # Per-VLAN fair share of the *hard* CCI cap (F1 + F4): group flows
            # by VLAN, water-fill VLAN demands, then water-fill inside VLANs.
            link_cap = path.cci_nominal_gbps * (1.0 - CCI_OVERHEAD)
            vlan_ids = np.array([f.vlan_index for f in flows])
            uniq = np.unique(vlan_ids)
            vlan_demand = np.array([want[vlan_ids == v].sum() for v in uniq])
            vlan_alloc = max_min_fair(vlan_demand, min(link_cap, nic_cap))
            got = np.zeros(n)
            for v, alloc in zip(uniq, vlan_alloc):
                idx = np.where(vlan_ids == v)[0]
                got[idx] = max_min_fair(want[idx], alloc)
        elif path.connectivity == "vpn":
            # Gateway capacity (F5): cold until autoscale; short flows dodge
            # throttling entirely for the first vpn_throttle_start seconds.
            if t < vpn_throttle_start:
                gw_cap = VPN_TUNNEL_CAP_GBPS * 1.6  # pre-throttle overshoot
            elif t < VPN_AUTOSCALE_S:
                gw_cap = VPN_COLD_GBPS if path.direction == "gcp_to_aws" else VPN_COLD_GBPS * 1.6
            else:
                gw_cap = VPN_TUNNEL_CAP_GBPS
            got = max_min_fair(want, min(gw_cap, nic_cap))
        else:  # public internet
            got = max_min_fair(want, nic_cap) * tier_bias
        # Small measurement noise (±2%).
        got = got * rng.normal(1.0, 0.02, size=n).clip(0.9, 1.1)
        series[t] = np.where(active, got, 0.0)

    means = np.array(
        [series[: f.duration_s, i].mean() for i, f in enumerate(flows)]
    )
    if return_timeseries:
        return means, series
    return means


def measure_throughput(
    connectivity: str,
    colocation: str = "intra_region",
    *,
    utilization: float = 1.0,
    direction: str = "gcp_to_aws",
    duration_s: int = 330,
    n_connections: int = 10,
    repeats: int = 30,
    seed: int = 0,
) -> dict:
    """One paper experiment cell: mean/std over ``repeats`` runs (§IV-B grid:
    4 connectivity x 2 directions x 3 colocations x 3 utilizations x 30)."""
    nominal = {
        "cci": CCI_NOMINAL_GBPS,
        "vpn": VPN_TUNNEL_CAP_GBPS,
        "internet_std": INTERNET_EGRESS_CAP_GBPS,
        "internet_prem": INTERNET_EGRESS_CAP_GBPS,
    }[connectivity]
    target = utilization * nominal
    path = PathConfig(connectivity=connectivity, colocation=colocation, direction=direction)
    flow = Flow(
        n_connections=n_connections,
        per_conn_target_gbps=target / n_connections,
        duration_s=duration_s,
    )
    samples = np.array(
        [simulate(path, [flow], seed=seed * 1000 + r)[0] for r in range(repeats)]
    )
    return {
        "connectivity": connectivity,
        "colocation": colocation,
        "direction": direction,
        "utilization": utilization,
        "duration_s": duration_s,
        "mean_gbps": float(samples.mean()),
        "std_gbps": float(samples.std()),
        "max_gbps": float(samples.max()),
        "min_gbps": float(samples.min()),
    }
