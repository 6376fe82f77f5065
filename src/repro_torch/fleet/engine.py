"""The fleet planning engine in PyTorch: price, then toggle, every link.

Port of the fleet half of :mod:`repro.fleet.engine`. A plan runs three
stages on one device, each batched over the N links:

  pair stage    demand (N, T) --clip at link capacity--> d
                d --monthly_cumsum + tiered pricing kernel--> hourly VPN cost
  route stage   identity routing (one link is one pair on a private port):
                hourly CCI cost ``L + V·1 + c·d``
  policy stage  both cost planes --FSM scan kernel--> x, state, toggle cost

On CUDA the tiered pricing and the FSM scan are the hand-written kernels
of :mod:`repro_torch.kernels`; on the CPU (``device="cpu"``) their plain
PyTorch versions. Everything is float64, except that ``use_pallas=True``
prices tiers in float32, as the JAX package's Pallas path does.

Topology routing (shared ports, multi-hop legs) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Union

import numpy as np
import torch

from repro_torch.core.costmodel import monthly_cumsum
from repro_torch.core.togglecci import run_togglecci
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

from .policy import make_policy, policy_scan
from .spec import FleetArrays, FleetSpec


def _plan_outputs(policy, d, vpn, cci) -> Dict[str, torch.Tensor]:
    """Run the policy and add the static comparators. ALWAYS-CCI still pays
    the provisioning delay: the first D hours ride VPN."""
    out = policy_scan(policy, vpn, cci)
    T = d.shape[1]
    cci_live = torch.arange(T, device=d.device)[None, :] >= policy.toggle.D[:, None]
    static_cci = torch.sum(torch.where(cci_live, cci, vpn), dim=1)
    return {
        "x": out["x"],                     # (rows, T) 0/1 decision sequences
        "state": out["state"],             # (rows, T) FSM states
        "toggle_cost": out["total_cost"],  # (rows,)
        "static_vpn": torch.sum(vpn, dim=1),
        "static_cci": static_cci,
        "vpn_hourly": vpn,
        "cci_hourly": cci,
    }


class RoutedSeries(NamedTuple):
    """The pricing output the policy toggles on (fleet mode: rows are links,
    ``row_demand is pair_demand`` and ``n_pairs`` is all ones)."""

    pair_demand: torch.Tensor  # (P, T) capacity-clipped demand
    row_demand: torch.Tensor   # (M, T) demand the decision rows see
    vpn: torch.Tensor          # (M, T) hourly VPN counterfactual
    cci: torch.Tensor          # (M, T) hourly CCI counterfactual
    n_pairs: torch.Tensor      # (M,) pairs attached per row


def _pair_stage(arrays: FleetArrays, demand: torch.Tensor, *, hours_per_month: int,
                use_pallas: bool = False):
    """Per-link clip + tiered VPN pricing."""
    f = torch.float64
    d = torch.minimum(demand.to(f), arrays.capacity[:, None])          # (N, T)
    month_cum = monthly_cumsum(d, hours_per_month)
    if use_pallas:
        # The float32 tier path of the JAX package's use_pallas=True.
        f32 = torch.float32
        vpn_transfer = ops.tiered_cost_batched(
            month_cum.to(f32), d.to(f32),
            arrays.tier_bounds.to(f32), arrays.tier_rates.to(f32),
        ).to(f)
    else:
        vpn_transfer = ops.tiered_cost_batched(
            month_cum, d, arrays.tier_bounds, arrays.tier_rates
        )
    return d, arrays.L_vpn[:, None] + vpn_transfer


def _route_stage(arrays: FleetArrays, d_pair, vpn_pair):
    """Price the CCI counterfactual on the identity routing of fleet mode
    (one pair per row); shared-port routing is not ported yet."""
    d_row, vpn = d_pair, vpn_pair
    n_pairs = torch.ones_like(arrays.L_cci)
    cci = (
        arrays.L_cci[:, None]
        + (arrays.V_cci * n_pairs)[:, None]
        + arrays.c_cci[:, None] * d_row
    )
    return d_row, vpn, cci, n_pairs


def routed_cost_series(
    arrays: FleetArrays,
    demand: torch.Tensor,
    *,
    hours_per_month: int,
    use_pallas: bool = False,
    device: DeviceLike = None,
) -> RoutedSeries:
    """The pricing stage: per-link VPN and CCI hourly cost planes on
    ``device`` (CUDA unless the caller says otherwise)."""
    dev = resolve_device(device)
    arrays = arrays.to(dev)
    demand = torch.as_tensor(demand, dtype=torch.float64, device=dev)
    d_pair, vpn_pair = _pair_stage(
        arrays, demand, hours_per_month=hours_per_month, use_pallas=use_pallas
    )
    d_row, vpn, cci, n_pairs = _route_stage(arrays, d_pair, vpn_pair)
    return RoutedSeries(d_pair, d_row, vpn, cci, n_pairs)


def plan_fleet(
    fleet: Union[FleetSpec, FleetArrays],
    demand,
    *,
    policy=None,
    hours_per_month: int = 730,
    renew_in_chunks: bool = False,
    use_pallas: bool = False,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """Plan the whole portfolio on ``device``: price every link-hour, then run
    every link's FSM, each in one kernel launch on CUDA.

    Args:
      fleet: a :class:`FleetSpec` (stacked here) or :class:`FleetArrays`
        (moved to ``device`` if they lie elsewhere).
      demand: (N, T) hourly GB per link, numpy or tensor (clipped at each
        link's capacity).
      policy: a :mod:`repro_torch.fleet.policy` policy with per-link
        tensors; ``None`` builds the spec's kind (default ``"reactive"``).
      hours_per_month: billing calendar (taken from the spec when given).
      use_pallas: price tiers in float32, the path the JAX package's
        ``use_pallas=True`` selects; costs stay float64 after pricing.
      device: ``None`` runs on CUDA and raises without it; ``"cpu"`` runs
        the plain PyTorch versions of the kernels.
    Returns:
      dict of per-link tensors on ``device``: ``x``, ``state``,
      ``toggle_cost``, ``static_vpn``, ``static_cci``, ``vpn_hourly``,
      ``cci_hourly``, ``pair_demand``/``demand``, ``port_demand`` and
      ``n_pairs``.
    """
    dev = resolve_device(device)
    kind = "reactive"
    if isinstance(fleet, FleetSpec):
        hours_per_month = fleet.hours_per_month
        kind = fleet.policy
        arrays = fleet.stack(torch.float64, dev)
    else:
        arrays = fleet.to(dev)
    if policy is None:
        policy = make_policy(kind, arrays.toggle, renew_in_chunks=renew_in_chunks)
    s = routed_cost_series(
        arrays, demand, hours_per_month=hours_per_month, use_pallas=use_pallas,
        device=dev,
    )
    out = _plan_outputs(policy, s.row_demand, s.vpn, s.cci)
    out.update(
        pair_demand=s.pair_demand, port_demand=s.row_demand, n_pairs=s.n_pairs,
        demand=s.pair_demand,
    )
    return out


def plan_fleet_reference(
    fleet: FleetSpec, demand, *, renew_in_chunks: bool = False
) -> Dict[str, np.ndarray]:
    """Per-link pure-Python reference (numpy float64): :func:`run_togglecci`
    link by link on capacity-clipped demand."""
    demand = np.asarray(demand, dtype=np.float64)
    xs, states, totals = [], [], []
    for i, link in enumerate(fleet.links):
        d = np.minimum(demand[i], link.capacity_gb_hr)
        res = run_togglecci(link.params, d, renew_in_chunks=renew_in_chunks)
        xs.append(res.x)
        states.append(res.state)
        totals.append(res.total_cost)
    return {
        "x": np.stack(xs),
        "state": np.stack(states),
        "toggle_cost": np.array(totals),
    }
