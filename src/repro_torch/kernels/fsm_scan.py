"""ToggleCCI FSM scan kernel wrapper.

The JAX package runs this step as a ``lax.scan`` inside
:func:`repro.fleet.policy.policy_scan`, vmapped over rows; it has no Pallas
twin. Here it is one CUDA C++ kernel (``csrc/fsm_scan.cu``): one thread per
row walks its T hours in order, keeping float64 running prefixes for the
window sums, applies the OFF→WAITING→ON cascade with hold counts (hold 1 is
the reactive policy, larger holds the hysteresis policy), and writes ``x``,
``state`` and the row's toggle cost. Its plain PyTorch version is
:func:`repro_torch.kernels.ref.fsm_scan_ref`.

This wrapper takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import _lib


def fsm_scan(
    vpn: torch.Tensor,        # (N, T) float64 hourly VPN counterfactual
    cci: torch.Tensor,        # (N, T) float64 hourly CCI counterfactual
    theta1: torch.Tensor,     # (N,) float64
    theta2: torch.Tensor,     # (N,) float64
    h: torch.Tensor,          # (N,) int32 window
    D: torch.Tensor,          # (N,) int32 provisioning delay
    T_cci: torch.Tensor,      # (N,) int32 commitment
    up_hold: torch.Tensor,    # (N,) int32 ≥ 1
    down_hold: torch.Tensor,  # (N,) int32 ≥ 1
    *,
    renew_in_chunks: bool = False,
) -> Dict[str, torch.Tensor]:
    """Run the FSM over every row (CUDA). Returns ``x``/``state`` (N, T)
    int32 and ``total_cost`` (N,) float64."""
    N, T = vpn.shape
    dev = vpn.device
    rows = (theta1, theta2, h, D, T_cci, up_hold, down_hold)
    want = (torch.float64,) * 2 + (torch.int32,) * 5
    if cci.shape != (N, T) or vpn.dtype != torch.float64 or cci.dtype != torch.float64:
        raise ValueError("fsm_scan takes float64 vpn/cci planes of one shape")
    for a, dt in zip(rows, want):
        if a.shape != (N,) or a.dtype != dt:
            raise ValueError(f"fsm_scan row parameter: want ({N},) {dt}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for a in (vpn, cci) + rows:
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("fsm_scan takes contiguous CUDA tensors on one device")
    lib = _lib.load()
    x = torch.empty((N, T), dtype=torch.int32, device=dev)
    state = torch.empty((N, T), dtype=torch.int32, device=dev)
    total = torch.empty((N,), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.fsm_scan_f64(
            vpn.data_ptr(), cci.data_ptr(), *(a.data_ptr() for a in rows),
            int(bool(renew_in_chunks)), N, T,
            x.data_ptr(), state.data_ptr(), total.data_ptr(), stream,
        )
    _lib.check(status, "fsm_scan_f64")
    _lib.LAUNCHES["fsm_scan"] += 1
    return {"x": x, "state": state, "total_cost": total}
