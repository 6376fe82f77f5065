"""Device-dispatching wrappers for every kernel of the port.

Dispatch rule (port of :mod:`repro.kernels.ops`):

* a CUDA tensor  -> the hand-written CUDA kernel, or an error (a failed
  build or launch raises; nothing falls back);
* a CPU tensor   -> the kernel's plain PyTorch version in
  :mod:`repro_torch.kernels.ref`;
* anything else  -> an error.

:data:`LAUNCHES` counts kernel launches by name; each kernel wrapper adds
one where it launches and nowhere else.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import ref
from .fsm_scan import fsm_scan as _fsm_scan_kernel
from .tiered_cost import tiered_cost_batched as _tiered_kernel
from ._lib import LAUNCHES, reset_launches  # noqa: F401


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def tiered_cost_batched(month_cum, demand, bounds, rates) -> torch.Tensor:
    """(N, T) tiered VPN transfer cost; float64 or float32 like the inputs."""
    if _route(month_cum, "tiered_cost_batched"):
        return _tiered_kernel(*(a.contiguous() for a in (month_cum, demand, bounds, rates)))
    return ref.tiered_cost_batched_ref(month_cum, demand, bounds, rates)


def fsm_scan(vpn, cci, theta1, theta2, h, D, T_cci, up_hold, down_hold,
             *, renew_in_chunks: bool = False) -> Dict[str, torch.Tensor]:
    """ToggleCCI over (N, T) cost planes: ``x``, ``state``, ``total_cost``."""
    args = (vpn, cci, theta1, theta2, h, D, T_cci, up_hold, down_hold)
    if _route(vpn, "fsm_scan"):
        return _fsm_scan_kernel(*(a.contiguous() for a in args), renew_in_chunks=renew_in_chunks)
    return ref.fsm_scan_ref(*args, renew_in_chunks=renew_in_chunks)
