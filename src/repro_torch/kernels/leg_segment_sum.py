"""Leg-ordered segment-sum kernel wrapper — the topology planner's fold.

Replaces ``jax.ops.segment_sum`` in the route stage of
:func:`repro.fleet.engine._route_stage`: demand rows fold onto ports over
the routing's leg list, each port's legs summed in ascending leg index,
from +0.0, every product and add rounded once, as XLA's sequential
scatter-add does. The CUDA C++ kernel (``csrc/leg_segment_sum.cu``) runs
one thread per (port, hour) and walks its port's legs through a port-major
index (:func:`port_major`), built once per routing on the host; one launch
folds one or two planes over the same legs.

Its plain PyTorch version, :func:`repro_torch.kernels.ref.leg_segment_sum_ref`,
is the leg loop ``out[lm[e]] += src[lp[e]] * w[e]``. This wrapper takes
CUDA tensors only; :mod:`repro_torch.kernels.ops` dispatches CPU tensors to
the plain version.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import _lib


def port_major(leg_port, n_segments: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, start)`` int32: the legs stably sorted by segment (so each
    segment's legs keep ascending leg index) and the (M + 1,) offsets of
    each segment's run in ``order``."""
    lm = np.asarray(leg_port, dtype=np.int64)
    if lm.size and (lm.min() < 0 or lm.max() >= n_segments):
        raise ValueError(f"leg segments out of range [0, {n_segments})")
    order = np.argsort(lm, kind="stable").astype(np.int32)
    start = np.zeros(n_segments + 1, np.int32)
    start[1:] = np.cumsum(np.bincount(lm, minlength=n_segments))
    return order, start


def leg_segment_sum(
    srcs: Sequence[torch.Tensor],   # one or two (P, T) float64 planes
    ws: Sequence[torch.Tensor],     # one (E,) float64 weight list per plane
    leg_pair: torch.Tensor,         # (E,) int32 source row of each leg
    order: torch.Tensor,            # (E,) int32 legs in port-major order
    start: torch.Tensor,            # (M + 1,) int32 offsets of each port's run
) -> Tuple[torch.Tensor, ...]:
    """One (M, T) float64 segment sum per plane, in one launch (CUDA)."""
    if len(srcs) not in (1, 2) or len(ws) != len(srcs):
        raise ValueError("leg_segment_sum folds one or two planes, one weight list each")
    P, T = srcs[0].shape
    E = leg_pair.shape[0]
    M = start.shape[0] - 1
    dev = srcs[0].device
    for a in (*srcs, *ws, leg_pair, order, start):
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("leg_segment_sum takes contiguous CUDA tensors on one device")
    if any(s.shape != (P, T) or s.dtype != torch.float64 for s in srcs):
        raise ValueError(f"planes must be float64 of one shape, got "
                         f"{[(tuple(s.shape), s.dtype) for s in srcs]}")
    if any(w.shape != (E,) or w.dtype != torch.float64 for w in ws):
        raise ValueError(f"weights must be ({E},) float64")
    if (leg_pair.dtype, order.dtype, start.dtype) != (torch.int32,) * 3 or order.shape != (E,):
        raise ValueError("leg_pair, order and start must be int32, order of shape (E,)")
    if M < 0 or M > 65535:
        raise ValueError(f"leg_segment_sum takes 0 to 65535 segments, got {M}")
    lib = _lib.load()
    outs = tuple(torch.empty((M, T), dtype=torch.float64, device=dev) for _ in srcs)
    two = len(srcs) == 2
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.leg_segment_sum_f64(
            srcs[0].data_ptr(), srcs[-1].data_ptr(), ws[0].data_ptr(), ws[-1].data_ptr(),
            2 if two else 1, leg_pair.data_ptr(), order.data_ptr(), start.data_ptr(),
            T, M, outs[0].data_ptr(), outs[-1].data_ptr(), stream,
        )
    _lib.check(status, "leg_segment_sum_f64")
    _lib.LAUNCHES["leg_segment_sum"] += 1
    return outs
