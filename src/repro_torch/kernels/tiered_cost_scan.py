"""Chunked tiered VPN pricing kernel wrappers — K hours with a billing carry.

Port of :func:`repro.kernels.tiered_cost.tiered_cost_scan`. One CUDA C++
kernel template (``csrc/tiered_cost_scan.cu``), one thread per row walking
the chunk's hours with the carry in a register, with two entry points:

* :func:`tiered_cost_scan` — the Pallas kernel's contract: carry the
  month-to-date volume, zero it where ``reset[k]`` is set; (N, K) planes;
  float64 or float32;
* :func:`tiered_cost_calendar` — the streaming runtime's form: carry the
  global prefix ``dcum`` and its month-start value ``dcum_month`` and price
  at their difference, as ``monthly_cumsum`` does offline; hour-major (K, N)
  planes; float64. The two forms are not bit-equal, and only this one keeps
  the runtime bit-equal to ``plan_fleet``.

Both price an hour whose carried volume or demand is NaN +0.0, as their
plain versions and the XLA ``tiered_cost_scan_ref`` do (the tier fold's min
and max keep the NaN, and every NaN segment fails ``seg > 0``); the Pallas
kernel, which sums without that guard, gives NaN there.

Both count as launches of ``tiered_cost_scan``. Their plain PyTorch versions
are :func:`repro_torch.kernels.ref.tiered_cost_scan_ref` and
:func:`~repro_torch.kernels.ref.tiered_cost_calendar_ref`. These wrappers
take CUDA tensors only; :mod:`repro_torch.kernels.ops` dispatches CPU tensors
to the plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

_SCAN = {torch.float64: "tiered_cost_scan_f64", torch.float32: "tiered_cost_scan_f32"}


def _check_cuda(name: str, dev: torch.device, *tensors: torch.Tensor) -> None:
    for a in tensors:
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous CUDA tensors on one device")


def tiered_cost_scan(
    cum0: torch.Tensor,     # (N,) month-to-date volume at the chunk start
    demand: torch.Tensor,   # (N, K) billed volume per hour
    bounds: torch.Tensor,   # (N, Kt) padded per-link tier bounds (finite)
    rates: torch.Tensor,    # (N, Kt) per-link marginal rates (0 on padding)
    reset: torch.Tensor,    # (K,) int32: hour k starts a new month
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Costs (N, K) and the carried month-to-date volume (N,) (CUDA)."""
    N, K = demand.shape
    Kt = bounds.shape[-1]
    dtype = demand.dtype
    if dtype not in _SCAN:
        raise TypeError(f"tiered_cost_scan takes float64 or float32, got {dtype}")
    if (cum0.shape != (N,) or bounds.shape != (N, Kt) or rates.shape != (N, Kt)
            or reset.shape != (K,)):
        raise ValueError(
            f"shapes: cum0 {tuple(cum0.shape)}, demand {tuple(demand.shape)}, "
            f"bounds {tuple(bounds.shape)}, rates {tuple(rates.shape)}, reset "
            f"{tuple(reset.shape)}"
        )
    if any(a.dtype != dtype for a in (cum0, bounds, rates)) or reset.dtype != torch.int32:
        raise ValueError("tiered_cost_scan takes one float dtype and an int32 reset")
    _check_cuda("tiered_cost_scan", demand.device, cum0, demand, bounds, rates, reset)
    lib = _lib.load()
    costs = torch.empty((N, K), dtype=dtype, device=demand.device)
    cum_out = torch.empty((N,), dtype=dtype, device=demand.device)
    with torch.cuda.device(demand.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _SCAN[dtype])(
            cum0.data_ptr(), demand.data_ptr(), bounds.data_ptr(), rates.data_ptr(),
            reset.data_ptr(), N, K, Kt, costs.data_ptr(), cum_out.data_ptr(), stream,
        )
    _lib.check(status, _SCAN[dtype])
    _lib.LAUNCHES["tiered_cost_scan"] += 1
    return costs, cum_out


def tiered_cost_calendar(
    carry: torch.Tensor,    # (2, N) float64: dcum, dcum_month at the chunk start
    demand: torch.Tensor,   # (K, N) float64 clipped billed volume, hour-major
    bounds: torch.Tensor,   # (N, Kt)
    rates: torch.Tensor,    # (N, Kt)
    t0: int,                # the chunk's first hour
    hours_per_month: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Costs (K, N) and the carry (2, N) after the chunk (CUDA, float64)."""
    K, N = demand.shape
    Kt = bounds.shape[-1]
    if carry.shape != (2, N) or bounds.shape != (N, Kt) or rates.shape != (N, Kt):
        raise ValueError(
            f"shapes: carry {tuple(carry.shape)}, demand {tuple(demand.shape)}, "
            f"bounds {tuple(bounds.shape)}, rates {tuple(rates.shape)}"
        )
    if any(a.dtype != torch.float64 for a in (carry, demand, bounds, rates)):
        raise TypeError("tiered_cost_calendar takes float64 tensors")
    if t0 < 0 or hours_per_month < 1:
        raise ValueError(f"t0 {t0} and hours_per_month {hours_per_month}")
    _check_cuda("tiered_cost_calendar", demand.device, carry, demand, bounds, rates)
    lib = _lib.load()
    costs = torch.empty((K, N), dtype=torch.float64, device=demand.device)
    carry_out = torch.empty((2, N), dtype=torch.float64, device=demand.device)
    with torch.cuda.device(demand.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.tiered_cost_calendar_f64(
            carry.data_ptr(), demand.data_ptr(), bounds.data_ptr(), rates.data_ptr(),
            t0 % hours_per_month, hours_per_month, N, K, Kt,
            costs.data_ptr(), carry_out.data_ptr(), stream,
        )
    _lib.check(status, "tiered_cost_calendar_f64")
    _lib.LAUNCHES["tiered_cost_scan"] += 1
    return costs, carry_out
