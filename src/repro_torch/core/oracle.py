"""Offline-optimal schedule under the paper's constraints (§V, §VI "Property 1").

Port of :mod:`repro.core.oracle`, a numpy copy. With the tier-state
convention of :mod:`repro_torch.core.costmodel` (all-VPN counterfactual
tier accumulation), the per-hour VPN/CCI costs are exogenous series, so the
offline optimum is an exact finite-state dynamic program over

    state 0            — OFF        (serve VPN; may request)
    state 1 .. D       — WAITING j  (serve VPN; j hours of provisioning left)
    state D+1 .. D+T   — ON with j hours of the T_cci commitment remaining
                         (serve CCI; may not release)
    state D+T+1        — ON past commitment (serve CCI; may release)

Property-1 semantics: the offline optimum may *begin* the horizon in either
OFF or ON (it can provision before t=0 — paying lease only from t=0), which is
exactly the comparator in the paper's asymptotic-optimality proof. Set
``allow_head_start=False`` to force an OFF start (then OPT also pays the
provisioning delay).

:func:`offline_optimal` is the scalar reference, with the schedule. The
batched cost-to-go of many rows at once (the reports' OPT column) is
:func:`repro_torch.kernels.ops.oracle_dp`: the ``oracle_dp`` CUDA kernel on
the card, its plain version :func:`repro_torch.kernels.ref.oracle_dp_ref`
on the CPU, both bit-equal to this function's ``total_cost`` and
``start_on``.

Complexity: O(T · (D + T_cci)) per row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .costmodel import HourlyCosts, hourly_cost_series
from .pricing import CostParams


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray          # (T,) optimal schedule (1 = CCI serving)
    total_cost: float
    start_on: bool         # whether the optimum pre-provisioned before t=0


def offline_optimal(
    params: CostParams,
    demand: Optional[np.ndarray] = None,
    *,
    costs: Optional[HourlyCosts] = None,
    allow_head_start: bool = True,
) -> OracleResult:
    costs = costs if costs is not None else hourly_cost_series(params, demand)
    vpn = np.asarray(costs.vpn, dtype=np.float64)
    cci = np.asarray(costs.cci, dtype=np.float64)
    T = vpn.shape[0]
    D, Tc = params.D, params.T_cci

    S_OFF = 0
    S_WAIT0 = 1                      # states 1..D: waiting, j = state hours left
    S_ON0 = D + 1                    # states D+1..D+Tc: ON, commitment left
    S_ON_FREE = D + Tc + 1
    S = S_ON_FREE + 1

    INF = np.inf
    # V[s] = optimal cost-to-go from start of hour t in state s.
    V = np.zeros(S, dtype=np.float64)
    choice = np.zeros((T, S), dtype=np.int8)  # 1 = "request/stay-CCI" action

    for t in range(T - 1, -1, -1):
        nV = np.full(S, INF)
        # OFF: serve VPN; either stay OFF or request CCI. Requesting at hour t
        # makes t the FIRST waiting hour, so D-1 waiting hours remain
        # afterwards; with D == 1 the request lands in ON with the full
        # commitment, and with D == 0 it serves CCI *this* hour (one
        # commitment hour consumed).
        on_fresh = S_ON0 + Tc - 1
        if D > 1:
            req_next = S_WAIT0 + D - 2
        elif D == 1:
            req_next = on_fresh
        else:
            req_next = S_ON0 + Tc - 2 if Tc > 1 else S_ON_FREE
        stay = vpn[t] + V[S_OFF]
        req = vpn[t] + V[req_next] if D > 0 else cci[t] + V[req_next]
        if req < stay:
            nV[S_OFF] = req
            choice[t, S_OFF] = 1
        else:
            nV[S_OFF] = stay
        # WAITING j hours left (state S_WAIT0 + j - 1, j in 1..D): serve VPN.
        # j=1 transitions to fresh-ON, j>1 to WAITING j-1.
        if D > 0:
            nV[S_WAIT0] = vpn[t] + V[on_fresh]
            if D > 1:
                nV[S_WAIT0 + 1 : S_WAIT0 + D] = vpn[t] + V[S_WAIT0 : S_WAIT0 + D - 1]
        # ON with j commitment hours left (j in 1..Tc): serve CCI, no release.
        nV[S_ON0] = cci[t] + V[S_ON_FREE]
        if Tc > 1:
            nV[S_ON0 + 1 : S_ON0 + Tc] = cci[t] + V[S_ON0 : S_ON0 + Tc - 1]
        # ON past commitment: stay on CCI or release to OFF (takes effect now).
        stay_on = cci[t] + V[S_ON_FREE]
        release = vpn[t] + V[S_OFF]
        if stay_on <= release:
            nV[S_ON_FREE] = stay_on
            choice[t, S_ON_FREE] = 1
        else:
            nV[S_ON_FREE] = release
        V = nV

    # Pick the start state (ON only when strictly cheaper: a tie or a NaN
    # keeps OFF, as Python's min() picks the first of equals).
    start_candidates = [(V[S_OFF], S_OFF, False)]
    if allow_head_start:
        start_candidates.append((V[S_ON_FREE], S_ON_FREE, True))
    best_cost, s, start_on = min(start_candidates, key=lambda c: c[0])

    # Forward pass to extract the schedule.
    x = np.zeros(T, dtype=np.int64)
    for t in range(T):
        if s == S_OFF:
            if choice[t, s] == 1:  # request
                if D > 1:
                    x[t] = 0
                    s = S_WAIT0 + D - 2  # hour t was the first waiting hour
                elif D == 1:
                    x[t] = 0
                    s = S_ON0 + Tc - 1
                else:
                    x[t] = 1
                    s = S_ON0 + Tc - 2 if Tc > 1 else S_ON_FREE
            else:
                x[t] = 0
        elif S_WAIT0 <= s < S_ON0:  # waiting
            j = s - S_WAIT0 + 1
            x[t] = 0
            s = (S_ON0 + Tc - 1) if j == 1 else s - 1
        elif S_ON0 <= s < S_ON_FREE:  # committed ON
            j = s - S_ON0 + 1
            x[t] = 1
            s = s - 1 if j > 1 else S_ON_FREE
        else:  # ON free
            if choice[t, s] == 1:
                x[t] = 1
            else:
                x[t] = 0
                s = S_OFF
    return OracleResult(x=x, total_cost=float(best_cost), start_on=start_on)


def best_static(params: CostParams, demand: np.ndarray) -> dict:
    """Cost of the best *static* policy (paper: "tracks the best static
    policy"): min(ALWAYS-VPN, ALWAYS-CCI)."""
    from .baselines import always_cci, always_vpn
    from .costmodel import evaluate_schedule

    costs = hourly_cost_series(params, demand)
    c_vpn = evaluate_schedule(params, demand, always_vpn(params, demand), costs=costs)
    c_cci = evaluate_schedule(params, demand, always_cci(params, demand), costs=costs)
    return {
        "always_vpn": c_vpn,
        "always_cci": c_cci,
        "best_static": min(c_vpn, c_cci),
    }
