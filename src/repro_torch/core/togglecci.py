"""ToggleCCI — the paper's online algorithm (§VI, Fig. 5) — in PyTorch.

Port of :mod:`repro.core.togglecci`. A three-state controller (OFF →
WAITING → ON) driven by sliding-window counterfactual costs ``R_VPN`` and
``R_CCI`` over the last ``h`` hours (the partial prefix while ``t < h``):

* OFF:      route VPN;  if ``R_CCI < θ₁·R_VPN``  → request CCI, enter WAITING.
* WAITING:  route VPN for the provisioning delay ``D`` hours, then → ON.
* ON:       route CCI;  committed for at least ``T_CCI`` hours; afterwards,
            if ``R_CCI > θ₂·R_VPN`` → release CCI, return to OFF.

Two implementations:

* :func:`run_togglecci`      — the pure-Python numpy reference (a copy of the
  JAX package's), with rich diagnostics.
* :func:`run_togglecci_scan` — the batched torch path through
  :func:`repro_torch.fleet.policy.policy_scan`, which runs the FSM scan
  kernel on CUDA and its plain per-hour loop on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .costmodel import HourlyCosts, hourly_cost_series
from .pricing import CostParams

OFF, WAITING, ON = 0, 1, 2


@dataclasses.dataclass
class ToggleResult:
    x: np.ndarray            # (T,) 0/1 — CCI actually serving traffic at hour t
    state: np.ndarray        # (T,) FSM state during hour t
    r_vpn: np.ndarray        # (T,) sliding-window VPN counterfactual cost
    r_cci: np.ndarray        # (T,) sliding-window CCI counterfactual cost
    requests: list           # hours at which CCI provisioning was requested
    releases: list           # hours at which CCI was released
    total_cost: float
    costs: HourlyCosts


def run_togglecci(
    params: CostParams,
    demand: np.ndarray,
    *,
    costs: Optional[HourlyCosts] = None,
    renew_in_chunks: bool = False,
) -> ToggleResult:
    """Pure-Python reference implementation of ToggleCCI (numpy, float64)."""
    costs = costs if costs is not None else hourly_cost_series(params, demand)
    T = costs.vpn.shape[0]
    h, D, T_cci = params.h, params.D, params.T_cci

    vpn_pref = np.concatenate([[0.0], np.cumsum(costs.vpn)])
    cci_pref = np.concatenate([[0.0], np.cumsum(costs.cci)])

    x = np.zeros(T, dtype=np.int64)
    state_trace = np.zeros(T, dtype=np.int64)
    r_vpn_tr = np.zeros(T)
    r_cci_tr = np.zeros(T)
    requests, releases = [], []

    # At the START of hour t, observe the window [max(0, t-h), t), apply at
    # most the cascade OFF->WAITING, WAITING->ON (covers D=0), ON->OFF; then
    # serve hour t in the resulting state. ``t_state`` counts hours already
    # served in the state.
    state, t_state = OFF, 0
    for t in range(T):
        lo = max(0, t - h)
        r_vpn = vpn_pref[t] - vpn_pref[lo]
        r_cci = cci_pref[t] - cci_pref[lo]
        r_vpn_tr[t], r_cci_tr[t] = r_vpn, r_cci

        if state == OFF and r_cci < params.theta1 * r_vpn:
            state, t_state = WAITING, 0
            requests.append(t)
        if state == WAITING and t_state >= D:
            state, t_state = ON, 0
        if state == ON and t_state >= T_cci:
            at_renewal = (t_state % params.T_cci) == 0
            if (at_renewal if renew_in_chunks else True) and (
                r_cci > params.theta2 * r_vpn
            ):
                state, t_state = OFF, 0
                releases.append(t)

        state_trace[t] = state
        x[t] = 1 if state == ON else 0
        t_state += 1

    total = float(np.sum(np.where(x == 1, costs.cci, costs.vpn)))
    return ToggleResult(
        x=x, state=state_trace, r_vpn=r_vpn_tr, r_cci=r_cci_tr,
        requests=requests, releases=releases, total_cost=total, costs=costs,
    )


# ---------------------------------------------------------------------------
# Batched torch path
# ---------------------------------------------------------------------------


class ToggleParams(NamedTuple):
    """ToggleCCI's decision parameters as tensors, one entry per row.

    ``theta1``/``theta2`` are float64, ``h``/``D``/``T_cci`` int32, each of
    shape (N,) for a fleet of N links (or () for one link).
    """

    theta1: torch.Tensor  # OFF->WAITING threshold
    theta2: torch.Tensor  # ON->OFF threshold
    h: torch.Tensor       # sliding window, hours (int32)
    D: torch.Tensor       # provisioning delay, hours (int32)
    T_cci: torch.Tensor   # minimum commitment, hours (int32)

    @classmethod
    def from_cost_params(cls, p: CostParams, device=None) -> "ToggleParams":
        f, i = torch.float64, torch.int32
        return cls(
            theta1=torch.tensor(p.theta1, dtype=f, device=device),
            theta2=torch.tensor(p.theta2, dtype=f, device=device),
            h=torch.tensor(p.h, dtype=i, device=device),
            D=torch.tensor(p.D, dtype=i, device=device),
            T_cci=torch.tensor(p.T_cci, dtype=i, device=device),
        )

    def to(self, device) -> "ToggleParams":
        return ToggleParams(*(t.to(device) for t in self))


def window_sums(hourly: torch.Tensor, h) -> torch.Tensor:
    """Sliding-window sums ``r[t] = sum(hourly[max(0, t-h):t])`` per row.

    ``hourly`` is (..., T) and ``h`` an int or a tensor broadcastable to the
    leading axes. The formula of :func:`repro.core.togglecci.window_sums`:
    a float64 prefix ``pref`` (leading zero) and ``pref[t] − pref[max(0,
    t−h)]``. On the CPU ``torch.cumsum`` is sequential, so this equals the
    JAX package's concrete numpy path bit for bit and the FSM scan kernel's
    in-order running prefix too.
    """
    v = hourly.to(torch.float64)
    T = v.shape[-1]
    zeros = torch.zeros(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    pref = torch.cat([zeros, torch.cumsum(v, dim=-1)], dim=-1)
    t_idx = torch.arange(T, device=v.device)
    h = torch.as_tensor(h, device=v.device).to(torch.int64)[..., None]
    lo = torch.clamp(t_idx - h, min=0).expand(v.shape)
    return pref[..., :T] - torch.gather(pref, -1, lo)


def run_togglecci_scan(
    params,
    vpn_hourly: torch.Tensor,
    cci_hourly: torch.Tensor,
    *,
    renew_in_chunks: bool = False,
):
    """ToggleCCI over precomputed per-hour mode costs, batched over rows.

    ``params`` is a :class:`CostParams` (one link, broadcast to every row)
    or a :class:`ToggleParams` with per-row fields; ``vpn_hourly`` and
    ``cci_hourly`` are (N, T). Returns the dict of
    :func:`repro_torch.fleet.policy.policy_scan`.
    """
    from repro_torch.fleet.policy import policy_scan, reactive_policy

    n = vpn_hourly.shape[0]
    if isinstance(params, ToggleParams):
        tp = params
    else:
        one = ToggleParams.from_cost_params(params, device=vpn_hourly.device)
        tp = ToggleParams(*(t.expand(n).contiguous() for t in one))
    return policy_scan(
        reactive_policy(tp, renew_in_chunks=renew_in_chunks), vpn_hourly, cci_hourly
    )
