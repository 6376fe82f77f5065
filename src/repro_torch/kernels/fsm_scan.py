"""ToggleCCI FSM scan kernel wrapper.

The JAX package runs this step as a ``lax.scan`` inside
:func:`repro.fleet.policy.policy_scan`, vmapped over rows; it has no Pallas
twin. Here it is one CUDA C++ kernel (``csrc/fsm_scan.cu``): each row's T
hours are walked in order, in tiles staged through shared memory, by three
warps one tile apart (float64 running prefixes and window sums; the
OFF→WAITING→ON cascade with hold counts, hold 1 being the reactive policy
and larger holds the hysteresis policy; the toggle cost), and it writes
``x``, ``state`` and the row's toggle cost. Any N, T and window, any 8-byte
aligned view. Its plain PyTorch version is
:func:`repro_torch.kernels.ref.fsm_scan_ref`, and the two agree bit for bit.
With ``gate=(pred, coef, margin)`` it launches the kernel's gated instance,
the forecast-gated policy (``ForecastGatedPolicy.step``'s gates on the
hour's predicted mode costs, hold counts of 1), counted apart in
``LAUNCHES["fsm_scan_gated"]``. The kernel decides the gates from the
predicted demand and the rows' cost coefficients: every bit equals the
comparison of the costs :func:`repro_torch.fleet.policy.predicted_mode_costs`
forms on the card (a float32 screen decides the bits whose margin clears
both forms' rounding, the exact costs the rest).

:func:`gate_masks` runs the gated instance's gate stage alone, for the
card's checks of its bits.

:func:`fsm_chunk` launches the third kernel of that source, the streaming
runtime's FSM: K hours from a carry, on hour-major (K, M) planes, replacing
the ``lax.scan`` of the JAX runtime's chunked step. Its plain version is
:func:`repro_torch.kernels.ref.fsm_chunk_ref`.

These wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain versions.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
    gate: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Run the FSM over every row (CUDA). Returns ``x``/``state`` (N, T)
    int32 and ``total_cost`` (N,) float64. ``gate`` is ``(pred, coef,
    margin)``: the (N, T) float64 predicted demand, the (N, 4) float64 cost
    coefficients ``[a_vpn, b_vpn, a_cci, b_cci]`` and the (N,) float64
    margins of the forecast gates."""
    N, T = vpn.shape
    dev = vpn.device
    rows = (theta1, theta2, h, D, T_cci, up_hold, down_hold)
    want = (torch.float64,) * 2 + (torch.int32,) * 5
    planes = (vpn, cci) + (() if gate is None else (gate[0],))
    for a in planes:
        if a.shape != (N, T) or a.dtype != torch.float64:
            raise ValueError("fsm_scan takes float64 vpn/cci (and pred) planes of one shape")
    coef = ()
    if gate is not None:
        coef = (gate[1],)
        if gate[1].shape != (N, 4) or gate[1].dtype != torch.float64:
            raise ValueError(f"fsm_scan gate coef: want ({N}, 4) float64, got "
                             f"{tuple(gate[1].shape)} {gate[1].dtype}")
        rows += (gate[2],)
        want += (torch.float64,)
    for a, dt in zip(rows, want):
        if a.shape != (N,) or a.dtype != dt:
            raise ValueError(f"fsm_scan row parameter: want ({N},) {dt}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for a in planes + coef + rows:
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("fsm_scan takes contiguous CUDA tensors on one device")
    lib = _lib.load()
    x = torch.empty((N, T), dtype=torch.int32, device=dev)
    state = torch.empty((N, T), dtype=torch.int32, device=dev)
    total = torch.empty((N,), dtype=torch.float64, device=dev)
    outs = (N, T, x.data_ptr(), state.data_ptr(), total.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if gate is None:
            status = lib.fsm_scan_f64(
                vpn.data_ptr(), cci.data_ptr(), *(a.data_ptr() for a in rows),
                int(bool(renew_in_chunks)), *outs, stream,
            )
        else:
            status = lib.fsm_scan_gated_f64(
                *(a.data_ptr() for a in planes + coef), rows[-1].data_ptr(),
                *(a.data_ptr() for a in rows[:-1]), int(bool(renew_in_chunks)), *outs, stream,
            )
    name = "fsm_scan" if gate is None else "fsm_scan_gated"
    _lib.check(status, name + "_f64")
    _lib.LAUNCHES[name] += 1
    return {"x": x, "state": state, "total_cost": total}


def gate_masks(
    pred: torch.Tensor,       # (N, T) float64 predicted demand
    coef: torch.Tensor,       # (N, 4) float64 [a_vpn, b_vpn, a_cci, b_cci]
    margin: torch.Tensor,     # (N,) float64
    theta1: torch.Tensor,     # (N,) float64
    theta2: torch.Tensor,     # (N,) float64
    *,
    screen: bool = True,
) -> torch.Tensor:
    """The gated instance's gate stage alone (CUDA), for the checks: the
    masks its gate warps form, (N, ceil(T / 64), 4) int64 holding the 64-bit
    masks A_req, B_req, A_rel, B_rel of each row's 64-hour tiles (bit i =
    hour 64 t + i; 0 past T). ``screen=False`` decides every hour by its
    exact mode costs. Not a path kernel: it counts no launch. Plain version:
    :func:`repro_torch.kernels.ref.gate_masks_ref`."""
    N, T = pred.shape
    dev = pred.device
    if pred.dtype != torch.float64:
        raise ValueError("gate_masks takes a float64 pred plane")
    if coef.shape != (N, 4) or coef.dtype != torch.float64:
        raise ValueError(f"gate_masks coef: want ({N}, 4) float64, got {tuple(coef.shape)} "
                         f"{coef.dtype}")
    rows = (margin, theta1, theta2)
    for a in rows:
        if a.shape != (N,) or a.dtype != torch.float64:
            raise ValueError(f"gate_masks row parameter: want ({N},) float64, got "
                             f"{tuple(a.shape)} {a.dtype}")
    for a in (pred, coef) + rows:
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("gate_masks takes contiguous CUDA tensors on one device")
    lib = _lib.load()
    masks = torch.empty((N, -(-T // 64), 4), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.fsm_scan_gate_masks_f64(
            *(a.data_ptr() for a in (pred, coef) + rows), N, T, int(bool(screen)),
            masks.data_ptr(), stream,
        )
    _lib.check(status, "fsm_scan_gate_masks_f64")
    return masks


def fsm_chunk(
    vpn: torch.Tensor,        # (K, M) float64 hourly VPN cost, hour-major
    cci: torch.Tensor,        # (K, M) float64 hourly CCI cost
    pre_v: torch.Tensor,      # (K, M) float64 host ring reads, prefix at t0+k-h
    pre_c: torch.Tensor,      # (K, M) float64
    theta1: torch.Tensor,     # (M,) float64
    theta2: torch.Tensor,     # (M,) float64
    h: torch.Tensor,          # (M,) int32 window
    D: torch.Tensor,          # (M,) int32
    T_cci: torch.Tensor,      # (M,) int32
    up_hold: torch.Tensor,    # (M,) int32 ≥ 1
    down_hold: torch.Tensor,  # (M,) int32 ≥ 1
    carry: torch.Tensor,      # (4, M) int32: state, t_state, up, down
    pref: torch.Tensor,       # (2, M) float64: VPN and CCI exclusive prefixes
    t0: int,
    *,
    renew_in_chunks: bool = False,
) -> Dict[str, torch.Tensor]:
    """K hours of the FSM from a carry (CUDA): ``x``/``state`` (K, M) int32,
    ``r_vpn``/``r_cci`` and the prefix snapshots ``snap_v``/``snap_c`` (K, M)
    float64, and the ``carry``/``pref`` after the chunk. Plain version:
    :func:`repro_torch.kernels.ref.fsm_chunk_ref`."""
    K, M = vpn.shape
    dev = vpn.device
    planes = (vpn, cci, pre_v, pre_c)
    rows = (theta1, theta2, h, D, T_cci, up_hold, down_hold)
    want = (torch.float64,) * 2 + (torch.int32,) * 5
    for a in planes:
        if a.shape != (K, M) or a.dtype != torch.float64:
            raise ValueError("fsm_chunk takes float64 (K, M) vpn/cci/pre planes")
    for a, dt in zip(rows, want):
        if a.shape != (M,) or a.dtype != dt:
            raise ValueError(f"fsm_chunk row parameter: want ({M},) {dt}, got "
                             f"{tuple(a.shape)} {a.dtype}")
    if carry.shape != (4, M) or carry.dtype != torch.int32:
        raise ValueError(f"fsm_chunk carry: want (4, {M}) int32")
    if pref.shape != (2, M) or pref.dtype != torch.float64:
        raise ValueError(f"fsm_chunk pref: want (2, {M}) float64")
    if t0 < 0:
        raise ValueError(f"fsm_chunk t0 {t0}")
    for a in planes + rows + (carry, pref):
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("fsm_chunk takes contiguous CUDA tensors on one device")
    lib = _lib.load()
    i32 = dict(dtype=torch.int32, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    out = {
        "x": torch.empty((K, M), **i32), "state": torch.empty((K, M), **i32),
        "r_vpn": torch.empty((K, M), **f64), "r_cci": torch.empty((K, M), **f64),
        "snap_v": torch.empty((K, M), **f64), "snap_c": torch.empty((K, M), **f64),
        "carry": torch.empty((4, M), **i32), "pref": torch.empty((2, M), **f64),
    }
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.fsm_chunk_f64(
            *(a.data_ptr() for a in planes + rows),
            int(bool(renew_in_chunks)), t0, K, M, carry.data_ptr(), pref.data_ptr(),
            *(out[k].data_ptr() for k in ("x", "state", "r_vpn", "r_cci", "snap_v",
                                          "snap_c", "carry", "pref")),
            stream,
        )
    _lib.check(status, "fsm_chunk_f64")
    _lib.LAUNCHES["fsm_chunk"] += 1
    return out
