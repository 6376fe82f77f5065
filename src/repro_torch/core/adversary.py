"""Theorem 1 (§VI): no online algorithm has a parameter-independent constant
competitive ratio.

Port of :mod:`repro.core.adversary`, a numpy copy. It builds the paper's
adversarial instances so the tests can *exhibit* the unbounded ratio against
any concrete online policy.

Construction (paper proof): at decision time ``t = -D`` the online algorithm
must commit without knowing the demand at ``t = 0``.

* Branch A — the algorithm is on VPN at t=0: the adversary injects a huge
  demand ``d``; OPT (pre-provisioned CCI) pays ≈ ``c_cci · d`` while the
  algorithm pays ≈ ``c_vpn · d``; the ratio → ``c_vpn / c_cci``, which the
  adversary makes arbitrarily large by choosing the cost parameters.
* Branch B — the algorithm pre-activated CCI: the adversary sends *zero*
  traffic; the algorithm pays at least ``L_cci`` while OPT pays only the idle
  VPN lease (or nothing, in the paper's stylized model) — ratio unbounded.

Because Theorem 1 quantifies over cost parameters, :func:`instance_for_ratio`
returns, for a target ratio ``alpha``, a (params, branch-A demand, branch-B
demand) triple such that *whichever* branch a deterministic online algorithm
takes, one of the two demands forces ratio > alpha.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .costmodel import evaluate_schedule, hourly_cost_series
from .pricing import CostParams, flat_rate


@dataclasses.dataclass(frozen=True)
class AdversarialInstance:
    params: CostParams
    demand_spike: np.ndarray   # branch A: a one-hour huge demand after warm-up
    demand_silent: np.ndarray  # branch B: no traffic at all
    alpha: float               # the ratio this instance is built to exceed


def instance_for_ratio(alpha: float, *, horizon: int = 600) -> AdversarialInstance:
    """Build an instance forcing any deterministic online algorithm above
    ratio ``alpha`` on one of its two demand branches."""
    if not alpha > 0:
        raise ValueError(f"alpha must be positive, got {alpha}")
    ratio = 4.0 * max(alpha, 1.0)          # c_vpn / c_cci safety margin
    c_cci = 0.01
    c_vpn = c_cci * ratio
    params = CostParams(
        L_cci=1.0,
        V_cci=0.0,
        c_cci=c_cci,
        L_vpn=0.0,                          # stylized: idle VPN is free (paper: OPT cost 0)
        vpn_tier=flat_rate(c_vpn),
        D=72,
        T_cci=168,
        h=168,
    )
    spike_hour = params.h + params.D + 1   # after any warm-up an algorithm needs
    # Huge spike: dominates every lease term by construction.
    spike_gb = 1e9 * max(alpha, 1.0)
    demand_spike = np.zeros(horizon)
    demand_spike[spike_hour] = spike_gb
    demand_silent = np.zeros(horizon)
    return AdversarialInstance(params, demand_spike, demand_silent, alpha)


def competitive_ratio(params: CostParams, demand: np.ndarray, x: np.ndarray) -> float:
    """Ratio of schedule ``x``'s cost to the offline optimum on ``demand``.

    Uses OPT with head-start (Theorem-1 semantics: OPT may have provisioned
    before t=0). Returns ``inf`` when OPT cost is 0 and the schedule pays > 0.
    """
    from .oracle import offline_optimal

    costs = hourly_cost_series(params, demand)
    alg = evaluate_schedule(params, demand, x, costs=costs)
    opt = offline_optimal(params, costs=costs).total_cost
    if opt <= 0:
        return float("inf") if alg > 0 else 1.0
    return alg / opt


def ratio_of_policy(policy, params: CostParams, demand: np.ndarray) -> float:
    """Competitive ratio of a concrete policy callable (params, demand) -> x."""
    x = policy(params, demand)
    return competitive_ratio(params, demand, x)
