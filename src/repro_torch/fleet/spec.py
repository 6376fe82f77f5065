"""Fleet specification: N heterogeneous links as struct-of-arrays tensors.

Port of :mod:`repro.fleet.spec`. A *link* is one priced interconnect with
its own :class:`~repro_torch.core.pricing.CostParams` and a capacity
ceiling; :meth:`FleetSpec.stack` turns the list of links into
:class:`FleetArrays`, the (N,)/(N, K) tensors the batched engine runs on.

Ragged tier tables are padded to the fleet-wide max depth with
``(bound=PAD_BOUND, rate=0)`` rows; duplicate bounds make zero-width
segments, so padding costs nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pricing import CostParams, TieredRate
from repro_torch.core.togglecci import ToggleParams
from repro_torch.device import DeviceLike, resolve_device

PAD_BOUND = 1e30  # stands in for inf (finite, so it can sit in a tensor)


def pad_tier_tables(
    tiers: Sequence[TieredRate],
) -> Tuple[List[List[float]], List[List[float]]]:
    """Pad ragged tier tables to the common max depth K.

    Returns ``(bounds, rates)`` as (len(tiers), K) nested lists with
    ``(PAD_BOUND, 0)`` padding rows.
    """
    K = max(len(t.bounds_gb) for t in tiers)
    bounds, rates = [], []
    for t in tiers:
        b = [x if math.isfinite(x) else PAD_BOUND for x in t.bounds_gb]
        r = list(t.rates)
        bounds.append(b + [PAD_BOUND] * (K - len(b)))
        rates.append(r + [0.0] * (K - len(r)))
    return bounds, rates


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """One interconnect link of the portfolio."""

    name: str
    params: CostParams
    capacity_gb_hr: float = math.inf   # linksim-calibrated ceiling (GB/hour)
    family: str = "constant"           # demand-trace family (scenario metadata)

    def __post_init__(self) -> None:
        if not self.capacity_gb_hr > 0:
            raise ValueError(f"capacity must be positive, got {self.capacity_gb_hr}")


class FleetArrays(NamedTuple):
    """Struct-of-arrays view of a fleet: every field is an (N,)/(N, K) tensor
    on one device (float64 except the int32 toggle windows)."""

    L_cci: torch.Tensor        # (N,) shared CCI lease $/hr
    V_cci: torch.Tensor        # (N,) per-pair attachment $/hr
    c_cci: torch.Tensor        # (N,) flat CCI $/GB
    L_vpn: torch.Tensor        # (N,) VPN lease $/hr
    tier_bounds: torch.Tensor  # (N, K) padded cumulative-volume bounds (GB)
    tier_rates: torch.Tensor   # (N, K) marginal $/GB per tier (0 on padding)
    toggle: ToggleParams       # fields (N,): theta1/theta2/h/D/T_cci
    capacity: torch.Tensor     # (N,) demand ceiling GB/hr (PAD_BOUND when inf)

    @property
    def n_links(self) -> int:
        return self.L_cci.shape[0]

    def to(self, device) -> "FleetArrays":
        """The same arrays on ``device`` (no copy where they already lie there)."""
        return FleetArrays(*(f.to(device) for f in self))  # ToggleParams.to too


_FLOAT_FIELDS = ("L_cci", "V_cci", "c_cci", "L_vpn", "tier_bounds", "tier_rates",
                 "capacity")
_TOGGLE_DTYPES = {"theta1": np.float64, "theta2": np.float64, "h": np.int32,
                  "D": np.int32, "T_cci": np.int32}


def fleet_arrays_from_numpy(d: Mapping[str, np.ndarray],
                            device: DeviceLike = None) -> FleetArrays:
    """Build :class:`FleetArrays` on ``device`` from a dict of numpy arrays.

    ``d`` holds the fields of a stacked fleet (for example ``np.asarray`` of
    each field of the JAX package's ``FleetArrays``), with the toggle
    parameters flattened to ``theta1``/``theta2``/``h``/``D``/``T_cci``.
    Floats become float64 and the toggle windows int32, as
    :meth:`FleetSpec.stack` makes them.
    """
    dev = resolve_device(device)

    def t(name, dtype):
        return torch.tensor(np.asarray(d[name], dtype=dtype), device=dev)

    toggle = ToggleParams(**{k: t(k, dt) for k, dt in _TOGGLE_DTYPES.items()})
    return FleetArrays(**{k: t(k, np.float64) for k in _FLOAT_FIELDS}, toggle=toggle)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """An ordered portfolio of links sharing one billing calendar.

    ``policy`` names the toggle rule the engine builds when no policy object
    is passed (see :mod:`repro_torch.fleet.policy`).
    """

    links: Tuple[LinkSpec, ...]
    policy: str = "reactive"

    def __post_init__(self) -> None:
        from .policy import POLICY_KINDS

        if not self.links:
            raise ValueError("a fleet needs at least one link")
        if self.policy not in POLICY_KINDS:
            raise ValueError(
                f"unknown toggle policy {self.policy!r} (known: {POLICY_KINDS})"
            )
        hpms = {l.params.hours_per_month for l in self.links}
        if len(hpms) != 1:
            raise ValueError(
                "fleet links must share hours_per_month (one billing calendar); "
                f"got {sorted(hpms)}"
            )

    def __len__(self) -> int:
        return len(self.links)

    @property
    def hours_per_month(self) -> int:
        return self.links[0].params.hours_per_month

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(l.name for l in self.links)

    def stack(self, dtype=torch.float64, device: DeviceLike = None) -> FleetArrays:
        """Stack link parameters into :class:`FleetArrays` on ``device``."""
        dev = resolve_device(device)
        ps = [l.params for l in self.links]
        bounds, rates = pad_tier_tables([p.vpn_tier for p in ps])
        cap = [
            l.capacity_gb_hr if math.isfinite(l.capacity_gb_hr) else PAD_BOUND
            for l in self.links
        ]

        def f(values):
            return torch.tensor(values, dtype=dtype, device=dev)

        def i(values):
            return torch.tensor(values, dtype=torch.int32, device=dev)

        toggle = ToggleParams(
            theta1=f([p.theta1 for p in ps]),
            theta2=f([p.theta2 for p in ps]),
            h=i([p.h for p in ps]),
            D=i([p.D for p in ps]),
            T_cci=i([p.T_cci for p in ps]),
        )
        return FleetArrays(
            L_cci=f([p.L_cci for p in ps]),
            V_cci=f([p.V_cci for p in ps]),
            c_cci=f([p.c_cci for p in ps]),
            L_vpn=f([p.L_vpn for p in ps]),
            tier_bounds=f(bounds),
            tier_rates=f(rates),
            toggle=toggle,
            capacity=f(cap),
        )


def fleet_from_params(
    params: Sequence[CostParams],
    *,
    capacities: Sequence[float] = (),
    names: Sequence[str] = (),
) -> FleetSpec:
    """Convenience: wrap bare CostParams into a FleetSpec."""
    n = len(params)
    caps = list(capacities) or [math.inf] * n
    nms = list(names) or [f"link{i:03d}" for i in range(n)]
    if len(caps) != n or len(nms) != n:
        raise ValueError("capacities and names must match params in length")
    return FleetSpec(
        tuple(
            LinkSpec(name=nm, params=p, capacity_gb_hr=c)
            for nm, p, c in zip(nms, params, caps)
        )
    )
