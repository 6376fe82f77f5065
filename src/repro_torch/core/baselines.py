"""Baseline policies from the paper's evaluation (§VII-A "Algorithms").

Port of :mod:`repro.core.baselines`, a numpy copy. All baselines face the
same physical constraints as ToggleCCI: a provisioning delay of ``D`` hours
between requesting CCI and its availability, and a minimum lease commitment
of ``T_cci`` hours once active.

1. ALWAYS-VPN  — never activate CCI.
2. ALWAYS-CCI  — request CCI at t=0; it serves traffic from t=D onward
   (the paper's Fig. 11 note: "it only misses the first D days due to the CCI
   setup time").
3. AVG(ALL)    — each hour, estimate demand as the average over the *entire
   history*, and hold CCI iff steady-state hourly CCI cost at that rate beats
   steady-state hourly VPN cost.
4. AVG(MONTH)  — same, over the last ``hours_per_month`` hours only.

The AVG policies share a generic threshold-on-rate engine with the same
WAITING/commitment mechanics as ToggleCCI so that comparisons isolate the
*decision rule*, not the actuation mechanics.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .costmodel import HourlyCosts, hourly_cost_series
from .pricing import CostParams

OFF, WAITING, ON = 0, 1, 2


def always_vpn(params: CostParams, demand: np.ndarray) -> np.ndarray:
    T = np.asarray(demand).shape[0]
    return np.zeros(T, dtype=np.int64)


def always_cci(params: CostParams, demand: np.ndarray) -> np.ndarray:
    T = np.asarray(demand).shape[0]
    x = np.ones(T, dtype=np.int64)
    x[: params.D] = 0  # provisioning delay
    return x


def _steady_state_prefers_cci(
    params: CostParams, rate_gb_hr: float, n_pairs: int
) -> bool:
    """Hourly CCI vs VPN cost at a constant aggregate rate (steady-state tier)."""
    month_gb = rate_gb_hr * params.hours_per_month
    if month_gb > 0:
        vpn_rate = params.vpn_tier.marginal_cost(0.0, month_gb) / month_gb
    else:
        vpn_rate = params.vpn_tier.rates[0]
    vpn_hr = n_pairs * params.L_vpn + vpn_rate * rate_gb_hr
    cci_hr = params.L_cci + n_pairs * params.V_cci + params.c_cci * rate_gb_hr
    return cci_hr < vpn_hr


def _threshold_policy(
    params: CostParams,
    demand: np.ndarray,
    want_cci_at: Callable[[int], bool],
) -> np.ndarray:
    """Generic FSM: request CCI when ``want_cci_at(t)``, honoring D and T_cci."""
    d = np.asarray(demand, dtype=np.float64)
    T = d.shape[0]
    x = np.zeros(T, dtype=np.int64)
    state, t_state = OFF, 0
    for t in range(T):
        want = want_cci_at(t)
        if state == OFF and want:
            state, t_state = WAITING, 0
        if state == WAITING and t_state >= params.D:
            state, t_state = ON, 0
        if state == ON and t_state >= params.T_cci and not want:
            state, t_state = OFF, 0
        x[t] = 1 if state == ON else 0
        t_state += 1
    return x


def avg_all(params: CostParams, demand: np.ndarray) -> np.ndarray:
    d = np.asarray(demand, dtype=np.float64)
    agg = d if d.ndim == 1 else d.sum(axis=1)
    n_pairs = 1 if d.ndim == 1 else d.shape[1]
    pref = np.concatenate([[0.0], np.cumsum(agg)])

    def want(t: int) -> bool:
        if t == 0:
            return False
        avg_rate = pref[t] / t
        return _steady_state_prefers_cci(params, avg_rate, n_pairs)

    return _threshold_policy(params, agg, want)


def avg_month(params: CostParams, demand: np.ndarray) -> np.ndarray:
    d = np.asarray(demand, dtype=np.float64)
    agg = d if d.ndim == 1 else d.sum(axis=1)
    n_pairs = 1 if d.ndim == 1 else d.shape[1]
    pref = np.concatenate([[0.0], np.cumsum(agg)])
    m = params.hours_per_month

    def want(t: int) -> bool:
        if t == 0:
            return False
        lo = max(0, t - m)
        avg_rate = (pref[t] - pref[lo]) / (t - lo)
        return _steady_state_prefers_cci(params, avg_rate, n_pairs)

    return _threshold_policy(params, agg, want)


BASELINES = {
    "always_vpn": always_vpn,
    "always_cci": always_cci,
    "avg_all": avg_all,
    "avg_month": avg_month,
}


def evaluate_all(
    params: CostParams,
    demand: np.ndarray,
    costs: Optional[HourlyCosts] = None,
) -> dict:
    """Total cost of every baseline plus ToggleCCI and the offline oracle."""
    from .costmodel import evaluate_schedule
    from .oracle import offline_optimal
    from .togglecci import run_togglecci

    costs = costs if costs is not None else hourly_cost_series(params, demand)
    out = {}
    for name, fn in BASELINES.items():
        out[name] = evaluate_schedule(params, demand, fn(params, demand), costs=costs)
    out["togglecci"] = run_togglecci(params, demand, costs=costs).total_cost
    out["oracle"] = offline_optimal(params, demand, costs=costs).total_cost
    return out
