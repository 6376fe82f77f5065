"""Per-row symmetric int8 (de)quantization kernel wrappers.

Port of :func:`repro.kernels.int8_quant.int8_quantize` and
:func:`~repro.kernels.int8_quant.int8_dequantize`. The CUDA C++ kernels
(``csrc/int8_quant.cu``) quantize each row of x (N, d), float32 or
bfloat16, to int8 with one float32 scale per row and ``q = clamp(round(x /
scale), -127, 127)``. The scale's guard is the Pallas kernel's, ``max(amax,
1e-30) / 127`` (``guard="pallas"``, the default), or the JAX collectives'
``max(amax / 127, 1e-30)`` (``guard="collectives"``, which the compressed
gradient sync uses); the clip changes nothing under the latter. They
dequantize ``q · scale`` to float32 or bfloat16, for any N and d. A row
holding NaN gets scale NaN, one holding ±inf scale inf, and both q = 0, as
the JAX package gives. Their plain PyTorch versions are
:func:`repro_torch.kernels.ref.int8_quantize` and
:func:`~repro_torch.kernels.ref.int8_dequantize`, and the two agree bit for
bit.

These wrappers take CUDA tensors only; :mod:`repro_torch.kernels.ops`
dispatches CPU tensors to the plain versions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _lib

_QUANT = {torch.float32: "int8_quantize_f32", torch.bfloat16: "int8_quantize_bf16"}
_DEQUANT = {torch.float32: "int8_dequantize_f32", torch.bfloat16: "int8_dequantize_bf16"}
#: The scale guards: the Pallas kernel's and ``repro.dist.collectives``'.
GUARDS = {"pallas": 0, "collectives": 1}


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for a in tensors:
        if not a.is_cuda or a.device != tensors[0].device:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


def int8_quantize(x: torch.Tensor, *, guard: str = "pallas"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, d) -> (q int8 (N, d), scale float32 (N, 1)) (CUDA)."""
    if guard not in GUARDS:
        raise ValueError(f"guard must be one of {tuple(GUARDS)}, got {guard!r}")
    if x.dtype not in _QUANT:
        raise TypeError(f"int8_quantize takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"int8_quantize takes (N, d >= 1), got {tuple(x.shape)}")
    _check_cuda("int8_quantize", x)
    N, d = x.shape
    lib = _lib.load()
    q = torch.empty((N, d), dtype=torch.int8, device=x.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _QUANT[x.dtype])(
            x.data_ptr(), N, d, GUARDS[guard], q.data_ptr(), scale.data_ptr(), stream)
    _lib.check(status, _QUANT[x.dtype])
    _lib.LAUNCHES["int8_quantize"] += 1
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q int8 (N, d), scale float32 (N, 1) -> q · scale as ``dtype`` (CUDA)."""
    if dtype not in _DEQUANT:
        raise TypeError(f"int8_dequantize returns float32 or bfloat16, not {dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_dequantize takes int8 q and float32 scale, got "
                        f"{q.dtype}, {scale.dtype}")
    if q.ndim != 2 or scale.shape != (q.shape[0], 1):
        raise ValueError(f"shapes: q {tuple(q.shape)}, scale {tuple(scale.shape)}")
    _check_cuda("int8_dequantize", q, scale)
    N, d = q.shape
    lib = _lib.load()
    out = torch.empty((N, d), dtype=dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, _DEQUANT[dtype])(
            q.data_ptr(), scale.data_ptr(), N, d, out.data_ptr(), stream)
    _lib.check(status, _DEQUANT[dtype])
    _lib.LAUNCHES["int8_dequantize"] += 1
    return out
