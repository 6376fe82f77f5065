"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Port of :mod:`repro.kernels.ref` for the kernels of the fleet planner's
path. Each function computes what its CUDA kernel computes, in the same
order of operations where that order decides the bits. They run wherever a
tensor lies; :mod:`repro_torch.kernels.ops` sends CPU tensors here, and the
chip checks hold each kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.costmodel import tiered_marginal_cost_tables
from repro_torch.core.togglecci import ToggleParams, window_sums


def tiered_cost_batched_ref(
    month_cum: torch.Tensor, demand: torch.Tensor, bounds: torch.Tensor,
    rates: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`repro_torch.kernels.tiered_cost.tiered_cost_batched`
    (float64 or float32; the left fold over tiers of the kernel)."""
    return tiered_marginal_cost_tables(month_cum, demand, bounds, rates)


def fsm_scan_ref(
    vpn: torch.Tensor, cci: torch.Tensor,
    theta1: torch.Tensor, theta2: torch.Tensor,
    h: torch.Tensor, D: torch.Tensor, T_cci: torch.Tensor,
    up_hold: torch.Tensor, down_hold: torch.Tensor,
    *,
    renew_in_chunks: bool = False,
) -> Dict[str, torch.Tensor]:
    """Plain version of :func:`repro_torch.kernels.fsm_scan.fsm_scan`.

    Window sums from a float64 ``torch.cumsum`` prefix
    (:func:`repro_torch.core.togglecci.window_sums`), then one
    :func:`repro_torch.fleet.policy._fsm_cascade` step per hour, vectorised
    over rows, with the hysteresis hold counters (hold 1 is the reactive
    rule). ``total_cost`` is the last entry of a cumsum of the served
    costs, so on the CPU, where cumsum is sequential, every output equals
    the kernel's bit for bit.
    """
    from repro_torch.fleet.policy import _fsm_cascade

    tp = ToggleParams(theta1, theta2, h, D, T_cci)
    r_vpn = window_sums(vpn, h)
    r_cci = window_sums(cci, h)
    raw_req = r_cci < theta1[:, None] * r_vpn      # (N, T) trigger planes
    raw_rel = r_cci > theta2[:, None] * r_vpn
    N, T = vpn.shape
    zero = torch.zeros(N, dtype=torch.int32, device=vpn.device)
    carry = (zero, zero)
    up, down = zero, zero
    xs, states = [], []
    for t in range(T):
        up = torch.where(raw_req[:, t], up + 1, 0)
        down = torch.where(raw_rel[:, t], down + 1, 0)
        req = raw_req[:, t] & (up >= up_hold)
        rel = raw_rel[:, t] & (down >= down_hold)
        carry, (x_t, s_t) = _fsm_cascade(tp, renew_in_chunks, carry, req, rel)
        xs.append(x_t)
        states.append(s_t)
    x = torch.stack(xs, dim=1)
    state = torch.stack(states, dim=1)
    served = torch.where(x == 1, cci.to(torch.float64), vpn.to(torch.float64))
    return {"x": x, "state": state, "total_cost": torch.cumsum(served, dim=1)[:, -1]}
