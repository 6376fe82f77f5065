"""Tiered VPN transfer-cost kernel wrapper — the paper's Eq. (2) hot loop.

Port of :func:`repro.kernels.tiered_cost.tiered_cost_batched`. The CUDA C++
kernel (``csrc/tiered_cost.cu``) prices an (N, T) plane of link-hours
against per-link padded (N, K) tier tables, one thread per element, in
float64 (the fleet engine's default path; bit-equal to
:func:`repro_torch.core.costmodel.tiered_marginal_cost_tables`) or float32
(the ``use_pallas`` path). Its plain PyTorch version is
:func:`repro_torch.kernels.ref.tiered_cost_batched_ref`.

This wrapper takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

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
