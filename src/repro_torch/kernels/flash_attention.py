"""Flash-attention kernel wrapper.

Port of :func:`repro.kernels.flash_attention.flash_attention`. The CUDA C++
kernels (``csrc/flash_attention.cu``) compute blocked online-softmax
attention over q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv)
with GQA, causal and sliding-window masks from global positions
(``q_offset``), float32 accumulators and fully masked rows as 0, for any Sq
and Skv. Its plain PyTorch version is :func:`repro_torch.kernels.ref.attention`.

Two entries, picked by :func:`_entry` from the dtype, the head dims, the
strides and the base pointers:

* ``flash_attention_sm90_bf16``, the Hopper kernel (``wgmma``, a TMA ring
  for K/V, the softmax in registers): bfloat16 with head dims that are
  multiples of 8 up to 256 and every pointer and (b, h, s) stride 16-byte
  aligned (every served config);
* ``flash_attention_bf16`` / ``flash_attention_f32``, the general kernel:
  float32, and the bfloat16 inputs the Hopper kernel does not take.

Neither falls back to the other: a refused launch raises. The inputs may be
strided views whose last dim is contiguous (the LM passes transposes of its
(B, S, H, D) projections); the output is contiguous. This wrapper takes
CUDA tensors only; :mod:`repro_torch.kernels.ops` dispatches CPU tensors to
the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _lib

_GENERAL = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
SM90 = "flash_attention_sm90_bf16"
#: Largest head dims each dtype's kernels take (the general kernel's float32
#: tiles fit one block's shared memory up to 192).
MAX_HEAD_DIM = {torch.float32: 192, torch.bfloat16: 256}


def _entry(dtype: torch.dtype, D: int, Dv: int, strides: Sequence[int],
           ptrs: Sequence[int]) -> str:
    """The C entry for inputs of ``dtype`` with head dims ``D``/``Dv``,
    (b, h, s) element strides ``strides`` and base addresses ``ptrs``: the
    Hopper entry for bfloat16 whose head dims are multiples of 8 and whose
    pointers and strides are 16-byte aligned, the general entry of the dtype
    otherwise. Raises for a dtype or head dim that neither takes."""
    if dtype not in _GENERAL:
        raise TypeError(f"flash_attention takes bfloat16 or float32, got {dtype}")
    if max(D, Dv) > MAX_HEAD_DIM[dtype]:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM[dtype]} "
                         f"in {dtype}, got D={D}, Dv={Dv}")
    if (dtype == torch.bfloat16 and D % 8 == 0 and Dv % 8 == 0
            and all(s > 0 and s % 8 == 0 for s in strides)
            and all(p % 16 == 0 for p in ptrs)):
        return SM90
    return _GENERAL[dtype]


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
    return run_entry(None, q, k, v, causal=causal, window=window, q_offset=q_offset,
                     scale=scale)


def run_entry(entry: Optional[str], q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` through the C entry ``entry`` (``None``: the
    one :func:`_entry` picks). Naming an entry lets a benchmark time the
    general kernel on inputs the Hopper kernel takes."""
    if q.dtype not in _GENERAL:
        raise TypeError(f"flash_attention takes bfloat16 or float32, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes 4-d q, k, v")
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, Hkv, Skv, D) or v.shape != (B, Hkv, Skv, Dv) or Hkv == 0
            or Hq % Hkv != 0):
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    for a in (q, k, v):
        if not a.is_cuda or a.device != q.device:
            raise ValueError("flash_attention takes CUDA tensors on one device")
        if a.dtype != q.dtype or a.stride(-1) != 1:
            raise ValueError("flash_attention takes tensors of one dtype with a contiguous "
                             "last dim")
    if max(D, Dv) > MAX_HEAD_DIM[q.dtype]:
        raise ValueError(f"flash_attention takes head dims up to {MAX_HEAD_DIM[q.dtype]} "
                         f"in {q.dtype}, got D={D}, Dv={Dv}")
    scale = D ** -0.5 if scale is None else scale
    lib = _lib.load()
    out = torch.empty((B, Hq, Sq, Dv), dtype=q.dtype, device=q.device)
    tensors = (q, k, v, out)
    stride_list = [s for a in tensors for s in a.stride()[:3]]
    if entry is None:
        entry = _entry(q.dtype, D, Dv, stride_list, [a.data_ptr() for a in tensors])
    elif entry not in (SM90, _GENERAL[q.dtype]):
        raise ValueError(f"no flash_attention entry {entry!r} for {q.dtype}")
    dims = (ctypes.c_int * 10)(B, Hq, Hkv, Sq, Skv, D, Dv, int(causal), window, q_offset)
    strides = (ctypes.c_longlong * 12)(*stride_list)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dims, strides,
            float(scale), stream,
        )
    _lib.check(status, entry)
    _lib.LAUNCHES["flash_attention"] += 1
    if entry == SM90:
        _lib.LAUNCHES["flash_attention_sm90"] += 1
    return out
