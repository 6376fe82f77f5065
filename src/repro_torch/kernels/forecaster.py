"""The demand forecaster's scan kernel wrapper.

The JAX package runs the forecaster (:func:`repro.models.ssm.demand_forecaster_step`)
under a ``lax.scan`` in ``demand_forecaster_state`` and
``demand_forecaster_apply``; it has no Pallas twin. Here it is one CUDA C++
kernel (``csrc/forecaster_scan.cu``): each row's S-state EMA bank walks its T
hours in tiles staged through shared memory, one thread a (row, state)
chain forming each hour's product ``(h − u)·w``, and a readout warp folds
the tile before, each hour's S products in index order. float32, every
product and sum rounded on its own, so it equals its plain version
:func:`repro_torch.kernels.ref.forecaster_scan_ref` bit for bit. Both
kernels take any S: compile-time instances up to :data:`FAST_STATE`, one
run-time instance past it.

Given a checkpoint output, the scan also stores each chain's state at the
start of every tile of :data:`BWD_TILE` hours. Its backward pass,
:func:`forecaster_scan_bwd`, is a second CUDA C++ source
(``csrc/forecaster_scan_bwd.cu``): the gradients of a loss with respect to
``a``, ``1 − a``, ``w`` and ``bias`` given ``dy``, one thread a (row, state)
chain recomputing each tile's states from its checkpoint while it walks the
adjoint back through the tile after it, then a fold over the rows in index
order; it equals :func:`repro_torch.kernels.ref.forecaster_scan_bwd_ref` bit
for bit.

The wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

#: The state sizes the kernels have compile-time instances for, 1 ..
#: FAST_STATE (``kFastState`` in both sources); any larger S takes each
#: kernel's run-time instance, with the same bits.
FAST_STATE = 16
#: Hours between two checkpoints of the forward chain (``kTile`` in
#: ``csrc/forecaster_scan.cu`` and ``csrc/forecaster_scan_bwd.cu``): a
#: checkpoint output holds ``ceil(T / BWD_TILE)`` states a (row, state) chain.
BWD_TILE = 64


def checkpoint_shape(N: int, T: int, S: int) -> Tuple[int, int, int]:
    """``(ceil(T / BWD_TILE), N, S)``: tile ``j`` holds the state before hour
    ``j · BWD_TILE`` (tile 0's is ``h0``)."""
    return (-(-T // BWD_TILE), N, S)


def _check_ckpt(name: str, ckpt: torch.Tensor, u: torch.Tensor, S: int) -> None:
    want = checkpoint_shape(*u.shape, S)
    if ckpt.dtype != torch.float32 or not ckpt.is_cuda or ckpt.device != u.device:
        raise ValueError(f"{name}: ckpt must be float32 on {u.device}, got {ckpt.dtype} on "
                         f"{ckpt.device}")
    if tuple(ckpt.shape) != want or not ckpt.is_contiguous():
        raise ValueError(f"{name}: ckpt must be contiguous {want}, got {tuple(ckpt.shape)}")


def _check_operands(name: str, u, vecs, rest, S: int) -> None:
    """float32, contiguous, CUDA, one device; ``vecs`` of shape (S,), S >= 1."""
    if S < 1:
        raise ValueError(f"{name} takes a of shape (S,) with S >= 1, got "
                         f"{tuple(vecs[0].shape)}")
    for t in (u,) + tuple(vecs) + tuple(rest):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32 tensors, got {t.dtype}")
        if not t.is_cuda or t.device != u.device or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous CUDA tensors on one device")
    if any(v.shape != (S,) for v in vecs):
        raise ValueError(f"{name}: a, 1 - a and w must be ({S},)")


def forecaster_scan(
    u: torch.Tensor,                    # (N, T) float32 log1p of normalised demand
    a: torch.Tensor,                    # (S,) float32 sigmoid(raw_a)
    one_minus_a: torch.Tensor,          # (S,) float32 1 - a
    w: torch.Tensor,                    # (S,) float32 readout weights
    bias: torch.Tensor,                 # () float32
    h0: Optional[torch.Tensor] = None,  # (N, S) float32 initial state, zeros if None
    *,
    write_y: bool = True,
    ckpt: Optional[torch.Tensor] = None,  # checkpoint_shape(N, T, S) float32 output
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The forecaster over every row (CUDA): ``(y (N, T) or None, h (N, S))``,
    float32. ``write_y=False`` skips the readout (the warm-up state only).
    ``ckpt``, when given, receives the state at the start of every tile
    (:func:`checkpoint_shape`), for :func:`forecaster_scan_bwd`."""
    if u.dim() != 2:
        raise ValueError(f"forecaster_scan takes (N, T) inputs, got {tuple(u.shape)}")
    N, T = u.shape
    S = a.shape[0] if a.dim() == 1 else -1
    _check_operands("forecaster_scan", u, (a, one_minus_a, w),
                    (bias,) + (() if h0 is None else (h0,)), S)
    if bias.numel() != 1:
        raise ValueError("forecaster_scan: bias must be one value")
    if h0 is not None and h0.shape != (N, S):
        raise ValueError(f"forecaster_scan h0: want ({N}, {S}), got {tuple(h0.shape)}")
    if ckpt is not None:
        _check_ckpt("forecaster_scan", ckpt, u, S)
    y, h = _launch_scan(u, a, one_minus_a, w, bias, h0, write_y, ckpt)
    _lib.LAUNCHES["forecaster_scan"] += 1
    return (y if write_y else None), h


def _launch_scan(u, a, one_minus_a, w, bias, h0, write_y: bool, ckpt):
    """One launch of the scan kernel on checked operands: ``(y, h)``."""
    N, T = u.shape
    S = a.shape[0]
    lib = _lib.load()
    f32 = dict(dtype=torch.float32, device=u.device)
    y = torch.empty((N, T) if write_y else (0,), **f32)
    h = torch.empty((N, S), **f32)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.forecaster_scan_f32(
            u.data_ptr(), a.data_ptr(), one_minus_a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if h0 is None else h0.data_ptr(), N, T, S, int(bool(write_y)),
            y.data_ptr(), h.data_ptr(), None if ckpt is None else ckpt.data_ptr(), stream,
        )
    _lib.check(status, "forecaster_scan_f32")
    return y, h


def forecaster_scan_bwd(
    u: torch.Tensor,                    # (N, T) float32 the forward's input
    dy: torch.Tensor,                   # (N, T) float32 gradient with respect to y
    a: torch.Tensor,                    # (S,) float32 sigmoid(raw_a)
    one_minus_a: torch.Tensor,          # (S,) float32 1 - a
    w: torch.Tensor,                    # (S,) float32 readout weights
    h0: Optional[torch.Tensor] = None,  # (N, S) float32 initial state, zeros if None
    *,
    ckpt: Optional[torch.Tensor] = None,  # checkpoint_shape(N, T, S) the forward's states
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forecaster's backward pass (CUDA): ``(da (S,), d_one_minus_a (S,),
    dw (S,), dbias ())`` float32, the gradients of the loss whose gradient
    with respect to :func:`forecaster_scan`'s ``y`` is ``dy``. ``dbias`` is
    ``Σ dy`` (the bias enters no other term).

    ``ckpt`` is the checkpoint output of the :func:`forecaster_scan` whose
    ``y`` ``dy`` belongs to (its tile 0 is that scan's ``h0``, so ``h0`` is
    then not given). Without it, the call forms the checkpoints from ``h0``
    with the scan kernel's state-only instance first. One call launches the
    chain kernel and the row fold (and that scan), and counts one launch."""
    if u.dim() != 2 or dy.shape != u.shape:
        raise ValueError(f"forecaster_scan_bwd takes (N, T) u and dy of one shape, got "
                         f"{tuple(u.shape)} and {tuple(dy.shape)}")
    N, T = u.shape
    S = a.shape[0] if a.dim() == 1 else -1
    dev = u.device
    _check_operands("forecaster_scan_bwd", u, (a, one_minus_a, w),
                    (dy,) + (() if h0 is None else (h0,)), S)
    if h0 is not None and h0.shape != (N, S):
        raise ValueError(f"forecaster_scan_bwd h0: want ({N}, {S}), got {tuple(h0.shape)}")
    f32 = dict(dtype=torch.float32, device=dev)
    if ckpt is None:
        ckpt = torch.empty(checkpoint_shape(N, T, S), **f32)
        if N:
            _launch_scan(u, a, one_minus_a, w, torch.zeros((), **f32), h0, False, ckpt)
    elif h0 is not None:
        raise ValueError("forecaster_scan_bwd: ckpt's first tile is the forward's h0; "
                         "give ckpt or h0, not both")
    else:
        _check_ckpt("forecaster_scan_bwd", ckpt, u, S)
    lib = _lib.load()
    part = torch.empty(((3 * S + 1) * (-(-N // 4) * 4),), **f32)   # rows padded to 4
    out = (torch.zeros if N == 0 else torch.empty)((3 * S + 1,), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.forecaster_scan_bwd_f32(
            u.data_ptr(), dy.data_ptr(), a.data_ptr(), one_minus_a.data_ptr(), w.data_ptr(),
            ckpt.data_ptr(), N, T, S, part.data_ptr(), out.data_ptr(), stream,
        )
    _lib.check(status, "forecaster_scan_bwd_f32")
    _lib.LAUNCHES["forecaster_scan_bwd"] += 1
    return out[:S], out[S:2 * S], out[2 * S:3 * S], out[3 * S]
