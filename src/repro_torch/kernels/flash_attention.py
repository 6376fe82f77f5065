"""Flash-attention kernel wrapper.

Port of :func:`repro.kernels.flash_attention.flash_attention`. The CUDA C++
kernel (``csrc/flash_attention.cu``) computes blocked online-softmax
attention over q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv)
with GQA, causal and sliding-window masks from global positions
(``q_offset``), float32 accumulators and fully masked rows as 0, in
bfloat16 (tensor cores) or float32, for any Sq and Skv. Its plain PyTorch
version is :func:`repro_torch.kernels.ref.attention`.

The inputs may be strided views whose last dim is contiguous (the LM passes
transposes of its (B, S, H, D) projections); the output is contiguous. This
wrapper takes CUDA tensors only; :mod:`repro_torch.kernels.ops` dispatches
CPU tensors to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _lib

_ENTRY = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
#: Largest head dims whose tiles fit one block's shared memory.
MAX_HEAD_DIM = {torch.float32: 192, torch.bfloat16: 256}


def flash_attention(
    q: torch.Tensor,   # (B, Hq, Sq, D)
    k: torch.Tensor,   # (B, Hkv, Skv, D)
    v: torch.Tensor,   # (B, Hkv, Skv, Dv)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention (CUDA); output (B, Hq, Sq, Dv) in q's dtype."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes bfloat16 or float32, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-d q, k, v")
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, Hkv, Skv, D) or v.shape != (B, Hkv, Skv, Dv) or Hkv == 0
            or Hq % Hkv != 0):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if max(D, Dv) > MAX_HEAD_DIM[q.dtype]:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM[q.dtype]} "
                         f"in {q.dtype}, got D={D}, Dv={Dv}")
    for a in (q, k, v):
        if not a.is_cuda or a.device != q.device:
            raise ValueError("flash_attention takes CUDA tensors on one device")
        if a.dtype != q.dtype or a.stride(-1) != 1:
            raise ValueError("flash_attention takes tensors of one dtype with a contiguous "
                             "last dim")
    scale = D ** -0.5 if scale is None else scale
    lib = _lib.load()
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int * 10)(B, Hq, Hkv, Sq, Skv, D, Dv, int(causal), window, q_offset)
    strides = (ctypes.c_longlong * 12)(*(s for a in (q, k, v, out) for s in a.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims, strides,
            float(scale), stream,
        )
    _lib.check(status, _ENTRY[q.dtype])
    _lib.LAUNCHES["flash_attention"] += 1
    return out
