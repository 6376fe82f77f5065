"""The paper's cost model — Eq. (1)/(2) of §V — in PyTorch.

Port of :mod:`repro.core.costmodel`. Given hourly demand ``d[t, p]`` and a
CCI-activation schedule ``x[t]``, hour ``t`` costs ``L_CCI + Σ_p (V_CCI +
c_CCI·d)`` over CCI and ``Σ_p (L_VPN + c_VPN(p, t)·d)`` over VPN, where the
tiered VPN rate depends on pair ``p``'s volume since the start of its
billing month (the all-VPN counterfactual tier convention of the JAX
package).

Two implementations with identical semantics:

* numpy reference (test oracle)          — :func:`hourly_cost_series`,
  :func:`tiered_marginal_cost_np`, :func:`evaluate_schedule`,
  :func:`cost_breakdown` (copies of the JAX package's numpy code)
* torch, batched over links              — :func:`monthly_cumsum`,
  :func:`tiered_marginal_cost_tables` (the plain version of the
  ``tiered_cost_batched`` CUDA kernel, :mod:`repro_torch.kernels`)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .pricing import CostParams, TieredRate

# ---------------------------------------------------------------------------
# numpy reference (copies of the JAX package's repro.core.costmodel)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HourlyCosts:
    """Per-hour aggregate (summed over pairs) costs of each mode."""

    vpn_lease: np.ndarray
    vpn_transfer: np.ndarray
    cci_lease: np.ndarray
    cci_transfer: np.ndarray

    @property
    def vpn(self) -> np.ndarray:
        return self.vpn_lease + self.vpn_transfer

    @property
    def cci(self) -> np.ndarray:
        return self.cci_lease + self.cci_transfer


def tiered_marginal_cost_np(
    tier: TieredRate, start_gb: np.ndarray, added_gb: np.ndarray
) -> np.ndarray:
    """Vectorized piecewise-linear marginal cost (numpy; broadcasts)."""
    bounds = np.array(
        [b if b != np.inf else 1e300 for b in tier.bounds_gb], dtype=np.float64
    )
    rates = np.array(tier.rates, dtype=np.float64)
    prev = np.concatenate([[0.0], bounds[:-1]])
    lo = np.asarray(start_gb, dtype=np.float64)[..., None]
    hi = lo + np.asarray(added_gb, dtype=np.float64)[..., None]
    seg = np.clip(np.minimum(hi, bounds) - np.maximum(lo, prev), 0.0, None)
    return np.sum(seg * rates, axis=-1)


def _as_2d(demand: np.ndarray) -> np.ndarray:
    demand = np.asarray(demand, dtype=np.float64)
    if demand.ndim == 1:
        demand = demand[:, None]
    if demand.ndim != 2:
        raise ValueError("demand must be (T,) or (T, P)")
    if not (demand >= 0).all():
        raise ValueError("negative demand")
    return demand


def hourly_cost_series(params: CostParams, demand: np.ndarray) -> HourlyCosts:
    """Compute the per-hour VPN and CCI cost series (numpy reference)."""
    d = _as_2d(demand)
    T, P = d.shape
    t_idx = np.arange(T)
    month_start = (t_idx // params.hours_per_month) * params.hours_per_month
    cum = np.cumsum(d, axis=0) - d  # exclusive prefix sum
    cum_at_month_start = np.zeros_like(d)
    for p in range(P):
        full = np.concatenate([[0.0], np.cumsum(d[:, p])])
        cum_at_month_start[:, p] = full[month_start]
    month_cum = cum - cum_at_month_start

    vpn_transfer = tiered_marginal_cost_np(params.vpn_tier, month_cum, d).sum(axis=1)
    vpn_lease = np.full(T, P * params.L_vpn)
    cci_lease = np.full(T, params.L_cci + P * params.V_cci)
    cci_transfer = params.c_cci * d.sum(axis=1)
    return HourlyCosts(vpn_lease, vpn_transfer, cci_lease, cci_transfer)


def evaluate_schedule(
    params: CostParams,
    demand: np.ndarray,
    x: np.ndarray,
    costs: Optional[HourlyCosts] = None,
) -> float:
    """Total cost of schedule ``x`` (Eq. 2). ``x[t]=1`` means CCI serves hour t."""
    costs = costs if costs is not None else hourly_cost_series(params, demand)
    x = np.asarray(x, dtype=np.float64)
    if x.shape != costs.vpn.shape:
        raise ValueError(f"schedule of shape {x.shape} for {costs.vpn.shape} hours")
    if not np.isin(x, (0.0, 1.0)).all():
        raise ValueError("a schedule holds only 0 and 1")
    return float(np.sum(x * costs.cci + (1.0 - x) * costs.vpn))


def cost_breakdown(
    params: CostParams, demand: np.ndarray, x: np.ndarray
) -> dict:
    """Leasing/transfer decomposition of a schedule's cost (paper Figs. 7, 10b)."""
    c = hourly_cost_series(params, demand)
    x = np.asarray(x, dtype=np.float64)
    return {
        "lease": float(np.sum(x * c.cci_lease + (1 - x) * c.vpn_lease)),
        "transfer": float(np.sum(x * c.cci_transfer + (1 - x) * c.vpn_transfer)),
        "total": float(np.sum(x * c.cci + (1 - x) * c.vpn)),
    }


# ---------------------------------------------------------------------------
# torch implementation (batched over leading link axes)
# ---------------------------------------------------------------------------


def tiered_marginal_cost_tables(
    start_gb: torch.Tensor,   # (..., T)
    added_gb: torch.Tensor,   # (..., T)
    bounds: torch.Tensor,     # (..., K) — inf already mapped to a large finite cap
    rates: torch.Tensor,      # (..., K)
) -> torch.Tensor:
    """Piecewise-linear marginal cost with per-link tier tables as operands.

    The same left fold over the K tiers as the JAX function of this name:
    ``hi = lo + d`` once, then ``out += where(seg > 0, seg·rate_k, 0)`` for
    k = 0, 1, … — every product rounded before it is added, so the float64
    result is bit-identical to the JAX package's on equal inputs and to the
    CUDA kernel, which keeps this order of operations exactly. Pad ragged
    tables with ``(bound=1e30, rate=0)`` rows (zero-width segments).

    Computes in the promoted floating dtype of the volumes (float64 on the
    default path, float32 on the ``use_pallas`` path).
    """
    acc = torch.promote_types(start_gb.dtype, added_gb.dtype)
    if not acc.is_floating_point:
        raise TypeError(f"volumes must be floating point, got {acc}")
    bounds = bounds.to(acc)
    rates = rates.to(acc)
    lo = start_gb.to(acc)
    hi = lo + added_gb.to(acc)
    out = torch.zeros((), dtype=acc, device=lo.device)
    prev = torch.zeros(bounds.shape[:-1] + (1,), dtype=acc, device=lo.device)
    zero = torch.zeros((), dtype=acc, device=lo.device)
    for j in range(bounds.shape[-1]):
        b_j = bounds[..., j:j + 1]
        seg = (torch.minimum(hi, b_j) - torch.maximum(lo, prev)).clamp_min(0.0)
        out = out + torch.where(seg > 0, seg * rates[..., j:j + 1], zero)
        prev = b_j
    return out


def monthly_cumsum(demand: torch.Tensor, hours_per_month: int) -> torch.Tensor:
    """Exclusive within-month cumulative volume along the LAST axis.

    The formula of the JAX function of this name: a global inclusive prefix
    ``full`` (with a leading zero) minus its value at each hour's month start.
    ``torch.cumsum`` sums sequentially on the CPU (bit-equal to
    ``np.cumsum``); on CUDA it is a parallel scan whose order of additions
    is not sequential, so month-to-date volumes there may differ from the
    CPU's in the last bits.
    """
    T = demand.shape[-1]
    t_idx = torch.arange(T, device=demand.device)
    month_start = (t_idx // hours_per_month) * hours_per_month
    zeros = torch.zeros(demand.shape[:-1] + (1,), dtype=demand.dtype, device=demand.device)
    full = torch.cat([zeros, torch.cumsum(demand, dim=-1)], dim=-1)
    return full[..., :-1] - full[..., month_start]
