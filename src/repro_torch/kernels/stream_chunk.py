"""The streaming runtime's chunk kernel wrapper: K hours of every link in one launch.

Port of the chunk step of :class:`repro.fleet.runtime.FleetRuntime`
(``_build_step_many``, one jitted dispatch for K hours) in fleet mode. One
CUDA C++ kernel (``csrc/stream_chunk.cu``) takes the runtime's packed host
block on the device (demand, optionally the CCI demand, and the host's
pre-chunk window reads) and the device carries, and computes the clip, the
billing calendar, the tier fold, the VPN and CCI cost planes, the prefix
snapshots, the window sums and the FSM, into one packed float64 result.

Its plain PyTorch version is :func:`repro_torch.kernels.ref.stream_chunk_ref`.
This wrapper takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _lib


def block_size(K: int, M: int, endo: bool) -> int:
    """Elements of the runtime's packed chunk block: the demand (and the CCI
    demand) (K, M), then the window reads pre_v, pre_c (K, M)."""
    return ((2 if endo else 1) + 2) * K * M


def stream_chunk(
    block: torch.Tensor,      # flat float64, block_size(K, M, endo)
    K: int,
    endo: bool,               # the block holds a CCI demand plane
    capacity: torch.Tensor,   # (M,) float64
    L_vpn: torch.Tensor,      # (M,) float64
    lease_cci: torch.Tensor,  # (M,) float64: L_cci + V_cci
    c_cci: torch.Tensor,      # (M,) float64
    bounds: torch.Tensor,     # (M, Kt) float64 padded tier bounds (finite)
    rates: torch.Tensor,      # (M, Kt) float64
    theta1: torch.Tensor,     # (M,) float64
    theta2: torch.Tensor,     # (M,) float64
    h: torch.Tensor,          # (M,) int32 window
    D: torch.Tensor,          # (M,) int32
    T_cci: torch.Tensor,      # (M,) int32
    up_hold: torch.Tensor,    # (M,) int32 >= 1
    down_hold: torch.Tensor,  # (M,) int32 >= 1
    cal: torch.Tensor,        # (2, M) float64: dcum, dcum_month
    fsm: torch.Tensor,        # (4, M) int32: state, t_state, up, down
    pref: torch.Tensor,       # (2, M) float64: vpn_pref, cci_pref
    t0: int,                  # the chunk's first hour
    hours_per_month: int,
    *,
    renew_in_chunks: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunk on the card: the packed float64 (8K + 4, M) result (vpn, cci,
    r_vpn, r_cci, snap_v, snap_c, x, state, K rows each, then dcum,
    dcum_month, vpn_pref, cci_pref) and the FSM carry after the chunk, (4, M)
    int32."""
    M = capacity.shape[0]
    dev = block.device
    f64, i32 = torch.float64, torch.int32
    if K < 1 or t0 < 0 or hours_per_month < 1:
        raise ValueError(f"stream_chunk: K {K}, t0 {t0}, hours_per_month {hours_per_month}")
    if block.dtype != f64 or block.shape != (block_size(K, M, endo),):
        raise ValueError(f"stream_chunk block: want flat float64 of {block_size(K, M, endo)}, "
                         f"got {tuple(block.shape)} {block.dtype}")
    Kt = bounds.shape[-1]
    want = [(bounds, (M, Kt), f64), (rates, (M, Kt), f64), (cal, (2, M), f64),
            (fsm, (4, M), i32), (pref, (2, M), f64)]
    want += [(a, (M,), f64) for a in (capacity, L_vpn, lease_cci, c_cci, theta1, theta2)]
    want += [(a, (M,), i32) for a in (h, D, T_cci, up_hold, down_hold)]
    for a, shape, dt in want:
        if a.shape != shape or a.dtype != dt:
            raise ValueError(f"stream_chunk operand: want {shape} {dt}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for a in [block] + [w[0] for w in want]:
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("stream_chunk takes contiguous CUDA tensors on one device")
    lib = _lib.load()
    out = torch.empty((8 * K + 4, M), dtype=f64, device=dev)
    fsm_out = torch.empty((4, M), dtype=i32, device=dev)
    nd = (2 if endo else 1) * K * M
    at = lambda off: block.data_ptr() + 8 * off   # element offset into the block
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.stream_chunk_f64(
            at(0), at(K * M) if endo else None, at(nd), at(nd + K * M),
            *(a.data_ptr() for a in (capacity, L_vpn, lease_cci, c_cci, bounds, rates,
                                     theta1, theta2, h, D, T_cci, up_hold, down_hold,
                                     cal, fsm, pref)),
            int(bool(renew_in_chunks)), t0, hours_per_month, K, M, Kt,
            out.data_ptr(), fsm_out.data_ptr(), stream,
        )
    _lib.check(status, "stream_chunk_f64")
    _lib.LAUNCHES["stream_chunk"] += 1
    return out, fsm_out
