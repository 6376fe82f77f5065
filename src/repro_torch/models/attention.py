"""Attention mixers of the port: GQA with an optional sliding window.

Port of the GQA part of :mod:`repro.models.attention`:

  * ``gqa_init(cfg, gen, device)``               -> parameters (``wq``, ``wk``,
    ``wv``, ``wo`` in the reference's ``(in, out)`` layout, used as ``x @ W``)
  * ``gqa_apply(cfg, p, x, pos0)``               -> (y, cache entry) — the
    full-sequence path of prefill, through :func:`repro_torch.kernels.ops.attention`
    (the flash kernel on the card)
  * ``gqa_decode(cfg, p, x, cache, pos)``        -> (y, cache) — one token,
    plain PyTorch over the cache (as in the reference, no kernel)

Caches are dicts of tensors. A sliding-window cache is a ring buffer of
``window`` slots whose ``pos`` entries give each slot's global position (−1
when empty); RoPE is applied to K before caching, so ring order never
matters. Unlike the reference's pure functions, ``gqa_fill_cache`` and
``gqa_decode`` write into the cache in place (no copy of the cache per
token) and return it.

MLA and cross-attention are not ported yet (ROADMAP Queue 1, item 11).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

from .common import ModelConfig, apply_rope, dense_init, rope_tables

NOT_PORTED = "is not ported yet (ROADMAP Queue 1, item 11)"


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_init(cfg: ModelConfig, gen: torch.Generator, device) -> torch.nn.ParameterDict:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    return torch.nn.ParameterDict({
        "wq": dense_init(gen, (d, H * hd), dt, device),
        "wk": dense_init(gen, (d, Hkv * hd), dt, device),
        "wv": dense_init(gen, (d, Hkv * hd), dt, device),
        "wo": dense_init(gen, (H * hd, d), dt, device, fan_in=H * hd),
    })


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    size = min(max_len, cfg.window) if cfg.window > 0 else max_len
    return {
        "k": torch.zeros((batch, size, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, Hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def _qkv(cfg: ModelConfig, p, x: torch.Tensor, pos0: int):
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    cos, sin = rope_tables(pos0 + torch.arange(S, device=x.device), hd, cfg.rope_theta)
    q = apply_rope(q.transpose(1, 2), cos, sin).transpose(1, 2)  # rope over S
    k = apply_rope(k.transpose(1, 2), cos, sin).transpose(1, 2)
    return q, k, v


def gqa_apply(cfg: ModelConfig, p, x: torch.Tensor, *, pos0: int = 0, causal: bool = True):
    """Full-sequence GQA. Returns (y, {"k", "v"}) with rope-applied K."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, pos0)
    out = ops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=cfg.window, q_offset=pos0,
    ).transpose(1, 2)  # (B, S, H, hd)
    y = out.reshape(B, S, -1) @ p["wo"]
    return y, {"k": k, "v": v}


def _decode_attention(q, k, v, valid, scale: Optional[float] = None):
    """One-token attention over a (ring) cache.

    q: (B, H, 1, D); k/v: (B, W, Hkv, D/Dv); valid: (W,) bool. GQA through a
    grouped product, with no repeat of the cache. As in the reference the
    scores and the weighted sum accumulate in float32 and the softmax weights
    are rounded to v's dtype before the sum.
    """
    B, H, _, D = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = (D ** -0.5) if scale is None else scale
    f32 = torch.float32
    qg = q[:, :, 0].reshape(B, Hkv, group, D).to(f32)
    kh = k.transpose(1, 2).to(f32)                       # (B, Hkv, W, D)
    vh = v.transpose(1, 2).to(f32)                       # (B, Hkv, W, Dv)
    s = (qg @ kh.transpose(-1, -2)) * scale              # (B, Hkv, group, W)
    s = s.masked_fill(~valid, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = w.to(v.dtype).to(f32) @ vh
    return out.reshape(B, H, 1, -1).to(q.dtype)


def gqa_decode(cfg: ModelConfig, p, x: torch.Tensor, cache, pos: int):
    """x: (B, 1, d); pos: tokens already in context. Writes the token's K/V
    into ``cache`` in place and returns (y, cache)."""
    B, S, _ = x.shape
    assert S == 1
    q, k, v = _qkv(cfg, p, x, pos)
    W = cache["k"].shape[1]
    slot = pos % W if cfg.window > 0 else pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = pos
    cpos = cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)
    if cfg.window > 0:
        valid &= cpos > pos - cfg.window
    out = _decode_attention(q.transpose(1, 2), cache["k"], cache["v"], valid)
    y = out.transpose(1, 2).reshape(B, 1, -1) @ p["wo"]
    return y, cache


def gqa_fill_cache(cfg: ModelConfig, cache, entry, pos0: int = 0):
    """Write a prefill's (k, v) into a (possibly ring) cache, in place."""
    k, v = entry["k"], entry["v"]
    S = k.shape[1]
    W = cache["k"].shape[1]
    positions = pos0 + torch.arange(S, device=k.device)
    if cfg.window > 0 and S > W:
        # Only the last W tokens can live in the ring.
        k, v, positions = k[:, -W:], v[:, -W:], positions[-W:]
    slots = positions % W if cfg.window > 0 else positions
    cache["k"][:, slots] = k
    cache["v"][:, slots] = v
    cache["pos"][slots] = positions.to(torch.int32)
    return cache


# ---------------------------------------------------------------------------
# Not ported yet
# ---------------------------------------------------------------------------


def xattn_apply(cfg: ModelConfig, p, x, memory):
    raise NotImplementedError(f"cross-attention (whisper decoder) {NOT_PORTED}")


def mla_apply(cfg: ModelConfig, p, x, *, pos0: int = 0, causal: bool = True):
    raise NotImplementedError(f"MLA (DeepSeek-V3) {NOT_PORTED}")
