"""Tiered VPN transfer-cost kernel wrapper — the paper's Eq. (2) hot loop.

Port of :func:`repro.kernels.tiered_cost.tiered_cost_batched`. The CUDA C++
kernel (``csrc/tiered_cost.cu``) prices an (N, T) plane of link-hours
against per-link padded (N, K) tier tables, one thread per element, in
float64 (the fleet engine's default path; bit-equal to
:func:`repro_torch.core.costmodel.tiered_marginal_cost_tables`) or float32
(the ``use_pallas`` path). Its plain PyTorch version is
:func:`repro_torch.kernels.ref.tiered_cost_batched_ref`.

The static-table entry :func:`tiered_cost` is the port of
:func:`repro.kernels.tiered_cost.tiered_cost`: a (T, P) float32 plane
priced against one tier table passed by value, as a flat plane of float4
vectors (plain version :func:`repro_torch.kernels.ref.tiered_cost`).

NaN: the fold's min and max keep a NaN, as ``torch.minimum``/``maximum``
and ``jnp.minimum``/``maximum`` do. So an hour whose month-to-date volume or
demand is NaN is priced +0.0 by :func:`tiered_cost_batched` (every tier
segment is NaN and fails the ``seg > 0`` guard), as by
:func:`repro_torch.core.costmodel.tiered_marginal_cost_tables` and the JAX
function of that name; and NaN by :func:`tiered_cost`, whose clip keeps it
and which has no such guard, as the Pallas ``_tiered_kernel``. (The Pallas
``_tiered_batched_kernel`` sums without the guard and gives NaN there; the
port follows the XLA function the JAX fleet engine prices with.)

These wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from . import _lib

_ENTRY = {torch.float64: "tiered_cost_batched_f64", torch.float32: "tiered_cost_batched_f32"}


def tiered_cost_batched(
    month_cum: torch.Tensor,   # (N, T) per-link exclusive monthly volume
    demand: torch.Tensor,      # (N, T)
    bounds: torch.Tensor,      # (N, K) padded per-link tier bounds (finite)
    rates: torch.Tensor,       # (N, K) per-link marginal rates (0 on padding)
) -> torch.Tensor:
    """Per-hour tiered transfer cost for N heterogeneous links (CUDA)."""
    N, T = month_cum.shape
    K = bounds.shape[-1]
    dtype = month_cum.dtype
    if dtype not in _ENTRY:
        raise TypeError(f"tiered_cost_batched takes float64 or float32, got {dtype}")
    if demand.shape != (N, T) or bounds.shape != (N, K) or rates.shape != (N, K):
        raise ValueError(
            f"shapes: month_cum {tuple(month_cum.shape)}, demand "
            f"{tuple(demand.shape)}, bounds {tuple(bounds.shape)}, rates "
            f"{tuple(rates.shape)}"
        )
    args = (month_cum, demand, bounds, rates)
    for a in args:
        if not a.is_cuda or a.device != month_cum.device:
            raise ValueError("tiered_cost_batched takes CUDA tensors on one device")
        if a.dtype != dtype or not a.is_contiguous():
            raise ValueError("tiered_cost_batched takes contiguous tensors of one dtype")
    lib = _lib.load()
    out = torch.empty((N, T), dtype=dtype, device=month_cum.device)
    with torch.cuda.device(month_cum.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _ENTRY[dtype])(
            *(a.data_ptr() for a in args), N, T, K, out.data_ptr(), stream
        )
    _lib.check(status, _ENTRY[dtype])
    _lib.LAUNCHES["tiered_cost_batched"] += 1
    return out


def tier_table(bounds: Sequence[float], rates: Sequence[float]) -> Tuple[Tuple[float, ...],
                                                                          Tuple[float, ...]]:
    """One static tier table as Python floats, as the Pallas op takes it: an
    infinite bound becomes ``1e30``; at most :data:`_lib.MAX_TIERS` tiers."""
    bounds = tuple(float(b) if math.isfinite(b) else 1e30 for b in bounds)
    rates = tuple(float(r) for r in rates)
    if len(bounds) != len(rates):
        raise ValueError(f"{len(bounds)} bounds but {len(rates)} rates")
    if len(bounds) > _lib.MAX_TIERS:
        raise ValueError(f"tiered_cost takes at most {_lib.MAX_TIERS} tiers, got {len(bounds)}")
    return bounds, rates


def tiered_cost(
    month_cum: torch.Tensor,     # (T, P) float32 volume of the month before the hour
    demand: torch.Tensor,        # (T, P) float32
    bounds: Sequence[float],     # upper bounds; inf is mapped to 1e30
    rates: Sequence[float],
) -> torch.Tensor:
    """(T, P) tiered cost against one static tier table (CUDA): port of
    :func:`repro.kernels.tiered_cost.tiered_cost`. Any T and P (the TPU
    kernel's ``T % 512`` is a tiling limit)."""
    bounds, rates = tier_table(bounds, rates)
    if month_cum.dtype != torch.float32 or demand.dtype != torch.float32:
        raise TypeError(f"tiered_cost takes float32, got {month_cum.dtype}, {demand.dtype}")
    if month_cum.ndim != 2 or demand.shape != month_cum.shape:
        raise ValueError(f"shapes: month_cum {tuple(month_cum.shape)}, demand "
                         f"{tuple(demand.shape)}")
    for a in (month_cum, demand):
        if not a.is_cuda or a.device != month_cum.device:
            raise ValueError("tiered_cost takes CUDA tensors on one device")
        if not a.is_contiguous():
            raise ValueError("tiered_cost takes contiguous tensors")
    tab = _lib.TierTable(len(bounds))
    tab.bounds[:len(bounds)] = bounds
    tab.rates[:len(rates)] = rates
    lib = _lib.load()
    out = torch.empty_like(month_cum)
    with torch.cuda.device(month_cum.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tiered_cost_static_f32(month_cum.data_ptr(), demand.data_ptr(),
                                            month_cum.numel(), tab, out.data_ptr(), stream)
    _lib.check(status, "tiered_cost_static_f32")
    _lib.LAUNCHES["tiered_cost"] += 1
    return out
