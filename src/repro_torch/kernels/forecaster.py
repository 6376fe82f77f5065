"""The demand forecaster's scan kernel wrapper.

The JAX package runs the forecaster (:func:`repro.models.ssm.demand_forecaster_step`)
under a ``lax.scan`` in ``demand_forecaster_state`` and
``demand_forecaster_apply``; it has no Pallas twin. Here it is one CUDA C++
kernel (``csrc/forecaster_scan.cu``): each row's S-state EMA bank walks its T
hours in tiles staged through shared memory, one thread a (row, state)
chain, and the readout of a tile's hours is folded by all threads, each
hour's S products in index order. float32, every product and sum rounded on
its own, so it equals its plain version
:func:`repro_torch.kernels.ref.forecaster_scan_ref` bit for bit.

The wrapper takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

#: The state sizes the kernel has compile-time instances for: 1 .. MAX_STATE.
MAX_STATE = 16


def forecaster_scan(
    u: torch.Tensor,                    # (N, T) float32 log1p of normalised demand
    a: torch.Tensor,                    # (S,) float32 sigmoid(raw_a)
    one_minus_a: torch.Tensor,          # (S,) float32 1 - a
    w: torch.Tensor,                    # (S,) float32 readout weights
    bias: torch.Tensor,                 # () float32
    h0: Optional[torch.Tensor] = None,  # (N, S) float32 initial state, zeros if None
    *,
    write_y: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The forecaster over every row (CUDA): ``(y (N, T) or None, h (N, S))``,
    float32. ``write_y=False`` skips the readout (the warm-up state only)."""
    if u.dim() != 2:
        raise ValueError(f"forecaster_scan takes (N, T) inputs, got {tuple(u.shape)}")
    N, T = u.shape
    S = a.shape[0] if a.dim() == 1 else -1
    if not 1 <= S <= MAX_STATE:
        raise ValueError(f"forecaster_scan has kernels for 1 <= S <= {MAX_STATE} states, "
                         f"got a of shape {tuple(a.shape)}")
    dev = u.device
    vecs = (a, one_minus_a, w)
    ins = (u,) + vecs + (bias,) + (() if h0 is None else (h0,))
    for t in ins:
        if t.dtype != torch.float32:
            raise ValueError(f"forecaster_scan takes float32 tensors, got {t.dtype}")
        if not t.is_cuda or t.device != dev or not t.is_contiguous():
            raise ValueError("forecaster_scan takes contiguous CUDA tensors on one device")
    if any(v.shape != (S,) for v in vecs) or bias.numel() != 1:
        raise ValueError(f"forecaster_scan: a, 1 - a and w must be ({S},), bias one value")
    if h0 is not None and h0.shape != (N, S):
        raise ValueError(f"forecaster_scan h0: want ({N}, {S}), got {tuple(h0.shape)}")
    lib = _lib.load()
    y = torch.empty((N, T) if write_y else (0,), dtype=torch.float32, device=dev)
    h = torch.empty((N, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.forecaster_scan_f32(
            u.data_ptr(), a.data_ptr(), one_minus_a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if h0 is None else h0.data_ptr(), N, T, S, int(bool(write_y)),
            y.data_ptr(), h.data_ptr(), stream,
        )
    _lib.check(status, "forecaster_scan_f32")
    _lib.LAUNCHES["forecaster_scan"] += 1
    return (y if write_y else None), h
