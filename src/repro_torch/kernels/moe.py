"""MoE routing, dispatch and combine kernel wrappers.

Three CUDA C++ kernels (``csrc/moe.cu``) around the expert products of
:func:`repro_torch.models.ffn.moe_apply`, over G token groups of N tokens,
E experts (at most 256), top-k (at most 8) and capacity C per expert and
group. They replace no Pallas kernel: the reference's dispatch is XLA
(``src/repro/models/ffn.py::_dispatch_group``). Their plain PyTorch
versions are :func:`repro_torch.kernels.ref.moe_route_ref`,
:func:`~repro_torch.kernels.ref.moe_dispatch_ref` and
:func:`~repro_torch.kernels.ref.moe_combine_ref`.

The dispatch buffer is expert-major, (E, G, C, d), so that the expert
products read it as (E, G·C, d) without a copy.

These wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import _lib

MAX_EXPERTS = 256
MAX_TOP_K = 8
_COMBINE = {torch.float32: "moe_combine_f32", torch.bfloat16: "moe_combine_bf16"}


class MoERouting(NamedTuple):
    """One routing of G groups: the scores, the decisions and the aux loss."""

    probs: torch.Tensor      # (G, N, E) float32: softmax or sigmoid of the logits
    gate_idx: torch.Tensor   # (G, N, k) int32: the top-k experts, best first
    gate_w: torch.Tensor     # (G, N, k) float32: their scores over their sum
    pos: torch.Tensor        # (G, N·k) int32: earlier slots routed to the same expert
    keep: torch.Tensor       # (G, N·k) bool: pos < C
    src: torch.Tensor        # (G, E, C) int32: each capacity slot's n·k + j, or -1
    aux: torch.Tensor        # (G,) float32: the Switch load-balance loss (0 for sigmoid)


def check_router(router: str) -> None:
    """Raises on a router other than ``softmax`` and ``sigmoid``."""
    if router not in ("softmax", "sigmoid"):
        raise ValueError(f"unknown router {router!r}")


def aux_scale(router: str, aux_coef: float, n_experts: int) -> float:
    """The factor of the aux loss's sum (``aux_coef · E``, as the reference
    forms it in Python), 0 for the sigmoid router."""
    check_router(router)
    return 0.0 if router == "sigmoid" else aux_coef * n_experts


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for a in tensors:
        if not a.is_cuda or a.device != dev:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def moe_route(logits: torch.Tensor, top_k: int, capacity: int, *, router: str = "softmax",
              aux_coef: float = 0.0) -> MoERouting:
    """Route (G, N, E) float32 logits: scores, top-k, slot positions, the
    capacity map and the aux loss (CUDA)."""
    if logits.dtype != torch.float32 or logits.dim() != 3:
        raise TypeError(f"moe_route takes (G, N, E) float32 logits, got {logits.dtype} "
                        f"{tuple(logits.shape)}")
    G, N, E = logits.shape
    if not (1 <= E <= MAX_EXPERTS and 1 <= top_k <= min(MAX_TOP_K, E) and capacity >= 1):
        raise ValueError(f"moe_route: E = {E} (at most {MAX_EXPERTS}), k = {top_k} (at most "
                         f"{MAX_TOP_K} and E), C = {capacity}")
    scale = aux_scale(router, aux_coef, E)
    _check_cuda("moe_route", logits)
    dev = logits.device
    i32 = dict(dtype=torch.int32, device=dev)
    out = MoERouting(
        probs=torch.empty((G, N, E), dtype=torch.float32, device=dev),
        gate_idx=torch.empty((G, N, top_k), **i32),
        gate_w=torch.empty((G, N, top_k), dtype=torch.float32, device=dev),
        pos=torch.empty((G, N * top_k), **i32),
        keep=torch.empty((G, N * top_k), dtype=torch.bool, device=dev),
        src=torch.empty((G, E, capacity), **i32),
        aux=torch.empty((G,), dtype=torch.float32, device=dev),
    )
    lib = _lib.load()
    with torch.cuda.device(dev):
        status = lib.moe_route_f32(
            logits.data_ptr(), G, N, E, top_k, capacity, int(router == "sigmoid"), scale,
            *(t.data_ptr() for t in out[:6]), out.aux.data_ptr(), _stream(logits))
    _lib.check(status, "moe_route_f32")
    _lib.LAUNCHES["moe_route"] += 1
    return out


def moe_dispatch(x: torch.Tensor, src: torch.Tensor, top_k: int) -> torch.Tensor:
    """Gather x (G, N, d) into the (E, G, C, d) buffer by ``src`` (G, E, C):
    row (e, g, c) is ``x[g, src // top_k]``, or zeros where ``src < 0``
    (CUDA)."""
    if x.dim() != 3 or src.dim() != 3 or src.dtype != torch.int32 or x.shape[0] != src.shape[0]:
        raise ValueError(f"shapes: x {tuple(x.shape)}, src {tuple(src.shape)} {src.dtype}")
    if x.element_size() not in (2, 4):
        raise TypeError(f"moe_dispatch takes 2- or 4-byte elements, got {x.dtype}")
    _check_cuda("moe_dispatch", x, src)
    G, N, d = x.shape
    _, E, C = src.shape
    buf = torch.empty((E, G, C, d), dtype=x.dtype, device=x.device)
    lib = _lib.load()
    with torch.cuda.device(x.device):
        status = lib.moe_dispatch(x.data_ptr(), src.data_ptr(), G, N, E, C, top_k,
                                  d * x.element_size(), buf.data_ptr(), _stream(x))
    _lib.check(status, "moe_dispatch")
    _lib.LAUNCHES["moe_dispatch"] += 1
    return buf


def moe_combine(out: torch.Tensor, gate_idx: torch.Tensor, pos: torch.Tensor,
                keep: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """Combine the experts' out (E, G, C, d) into y (G, N, d): each token's
    k rows times their gate weights, in choice order (CUDA)."""
    if out.dtype not in _COMBINE:
        raise TypeError(f"moe_combine takes bfloat16 or float32, got {out.dtype}")
    E, G, C, d = out.shape
    Gi, N, k = gate_idx.shape
    if (Gi != G or gate_idx.dtype != torch.int32 or pos.shape != (G, N * k)
            or pos.dtype != torch.int32 or keep.shape != (G, N * k) or keep.dtype != torch.bool
            or gate_w.shape != (G, N, k) or gate_w.dtype != torch.float32 or k > MAX_TOP_K):
        raise ValueError(f"shapes: out {tuple(out.shape)}, gate_idx {tuple(gate_idx.shape)}, "
                         f"pos {tuple(pos.shape)}, keep {tuple(keep.shape)}, gate_w "
                         f"{tuple(gate_w.shape)}")
    _check_cuda("moe_combine", out, gate_idx, pos, keep, gate_w)
    y = torch.empty((G, N, d), dtype=out.dtype, device=out.device)
    lib = _lib.load()
    with torch.cuda.device(out.device):
        status = getattr(lib, _COMBINE[out.dtype])(
            out.data_ptr(), gate_idx.data_ptr(), pos.data_ptr(), keep.data_ptr(),
            gate_w.data_ptr(), G, N, E, C, k, d, y.data_ptr(), _stream(out))
    _lib.check(status, _COMBINE[out.dtype])
    _lib.LAUNCHES["moe_combine"] += 1
    return y
