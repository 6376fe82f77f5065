"""Batched offline-optimal DP kernel wrapper — the reports' OPT column.

Replaces the reference's row-by-row numpy DP (:func:`repro.core.oracle.offline_optimal`'s
backward pass, run link by link by ``repro.fleet.engine.fleet_oracle`` and
port by port by ``topology_oracle``): the CUDA C++ kernel
(``csrc/oracle_dp.cu``) runs every row's cost-to-go in one launch, one
block a row, the row's states double-buffered in shared memory and the
hours walked backwards in staged tiles, every add ``__dadd_rn``, so each
row's total and start state equal the numpy DP's bit for bit, NaN
included.

Its plain PyTorch version, :func:`repro_torch.kernels.ref.oracle_dp_ref`,
is the same batched recurrence over (N, S_max) states with a Python loop
over hours. This wrapper takes CUDA tensors only;
:mod:`repro_torch.kernels.ops` dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

#: The most states (D + T_cci + 2) a row may have: two buffers of states and
#: two 512-hour cost tiles, float64, in a block's 227 KB of shared memory.
MAX_STATES = 232448 // 16 - 512


def oracle_dp(
    vpn: torch.Tensor,       # (N, T) float64 hourly VPN cost per row
    cci: torch.Tensor,       # (N, T) float64 hourly CCI cost per row
    D: torch.Tensor,         # (N,) int32 provisioning delay, >= 0
    T_cci: torch.Tensor,     # (N,) int32 minimum commitment, >= 1
    *,
    allow_head_start: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(total (N,) float64, start_on (N,) bool)`` of every row's offline
    optimum, in one launch (CUDA). Reads the rows' largest state count back
    to the host once, to size the block."""
    if vpn.dim() != 2:
        raise ValueError(f"vpn must be (N, T), got {tuple(vpn.shape)}")
    N, T = vpn.shape
    dev = vpn.device
    for a in (vpn, cci, D, T_cci):
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("oracle_dp takes contiguous CUDA tensors on one device")
    if cci.shape != (N, T) or vpn.dtype != torch.float64 or cci.dtype != torch.float64:
        raise ValueError(f"vpn and cci must be float64 of one shape, got "
                         f"{tuple(vpn.shape)} {vpn.dtype} and {tuple(cci.shape)} {cci.dtype}")
    if D.shape != (N,) or T_cci.shape != (N,) or D.dtype != torch.int32 \
            or T_cci.dtype != torch.int32:
        raise ValueError(f"D and T_cci must be ({N},) int32")
    total = torch.empty(N, dtype=torch.float64, device=dev)
    start_on = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return total, start_on
    d_min, tc_min, s_max = torch.stack([D.min(), T_cci.min(), (D + T_cci).max()]).tolist()
    if d_min < 0 or tc_min < 1:
        raise ValueError(f"oracle_dp needs D >= 0 and T_cci >= 1, got min D {d_min}, "
                         f"min T_cci {tc_min}")
    S_max = s_max + 2
    if S_max > MAX_STATES:
        raise ValueError(f"a row has {S_max} states; a block holds at most {MAX_STATES}")
    lib = _lib.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.oracle_dp_f64(
            vpn.data_ptr(), cci.data_ptr(), D.data_ptr(), T_cci.data_ptr(), N, T, S_max,
            int(bool(allow_head_start)), total.data_ptr(), start_on.data_ptr(), stream,
        )
    _lib.check(status, "oracle_dp_f64")
    _lib.LAUNCHES["oracle_dp"] += 1
    return total, start_on
