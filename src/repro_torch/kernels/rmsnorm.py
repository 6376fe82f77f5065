"""RMSNorm kernel wrapper.

Port of :func:`repro.kernels.rmsnorm.rmsnorm`. The CUDA C++ kernel
(``csrc/rmsnorm.cu``) normalises each row of x (..., d) with a weight w
(d,): ``x·rsqrt(mean(x²)+eps)·w`` in float32, cast to x's dtype, for
bfloat16 or float32 and any row count. Its plain PyTorch version is
:func:`repro_torch.kernels.ref.rmsnorm`.

This wrapper takes CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

import torch

from . import _lib

_ENTRY = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Row-wise RMSNorm of x (..., d) with weight w (d,) (CUDA)."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"rmsnorm takes bfloat16 or float32, got {x.dtype}")
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    for a in (x, w):
        if not a.is_cuda or a.device != x.device:
            raise ValueError("rmsnorm takes CUDA tensors on one device")
        if a.dtype != x.dtype or not a.is_contiguous():
            raise ValueError("rmsnorm takes contiguous tensors of one dtype")
    lib = _lib.load()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), w.data_ptr(), x.numel() // max(d, 1), d, float(eps),
            out.data_ptr(), stream,
        )
    _lib.check(status, _ENTRY[x.dtype])
    _lib.LAUNCHES["rmsnorm"] += 1
    return out
