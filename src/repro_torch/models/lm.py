"""Model assembly of the port: init / forward / prefill / decode.

Port of :mod:`repro.models.lm` for the GQA families whose every layer is
``LayerKind("gqa", "dense")`` (TinyLlama, H2O-Danube3, Yi, DeepSeek-7B) or
``LayerKind("gqa", "moe")`` (Mixtral-8x7B). The model is an :class:`LM`
module whose layers are separate modules (the reference stacks them along a
leading axis and scans; :func:`repro_torch.models.convert.params_from_reference`
unstacks). Every norm goes through :func:`repro_torch.kernels.ops.rmsnorm`,
the full-sequence attention through :func:`repro_torch.kernels.ops.attention`
and each MoE layer through ``ops.moe_route``, ``moe_dispatch`` and
``moe_combine`` (:func:`repro_torch.models.ffn.moe_apply`), so on the card a
forward launches the RMSNorm kernel ``2 · n_layers + 1`` times, each MoE
kernel once a MoE layer, and a prefill the flash-attention kernel
``n_layers`` times.

Entry points (the reference's, with the module in place of the params)
  LM(cfg, seed=0, device=None)                        -> model
  forward(cfg, model, tokens, ...)                    -> (logits, extras {aux, entries?})
  init_cache(cfg, batch, max_len, device=None)        -> cache
  prefill(cfg, model, tokens, cache)                  -> (logits, cache)
  decode_step(cfg, model, token, cache)               -> (logits, cache)

``extras["aux"]`` is the MoE aux loss summed over the layers (0.0 for a
dense model). The default device is the card
(:func:`repro_torch.resolve_device`); pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels. The cache is updated in place. This slice
serves only: parameters do not require gradients, and the reference's
training pieces (``_grad_barrier``, remat) and its sharding constraints are
not ported. Other families (MLA, SSM mixers, encoder-decoder, VLM, MTP)
raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

from . import attention as attn
from . import ffn as ffn_mod
from .common import (
    LayerKind, ModelConfig, count_params, dense_init, embed_init, make_generator, ones_init,
)

DENSE_GQA = LayerKind("gqa", "dense")
MOE_GQA = LayerKind("gqa", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer of ``cfg`` is a GQA layer with a dense or a
    MoE FFN (MoE layers need ``cfg.moe``)."""
    kinds = set(cfg.layer_kinds())
    if (cfg.family not in ("dense", "moe") or not kinds <= {DENSE_GQA, MOE_GQA}
            or (MOE_GQA in kinds and cfg.moe is None) or cfg.mla or cfg.mtp
            or cfg.encoder_layers or cfg.n_patches):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layers {sorted(map(str, kinds))} is not "
            "ported yet; the port serves GQA models with dense or MoE FFNs only (ROADMAP "
            "Queue 1, item 11)")


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, w, eps=eps)


class Layer(nn.Module):
    """One pre-norm block: ``x + attn(norm1(x))``, then ``x + ffn(norm2(x))``,
    the FFN dense or MoE by the layer's kind."""

    def __init__(self, cfg: ModelConfig, kind: LayerKind, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        self.moe = kind.ffn == "moe"
        self.norm1 = nn.Parameter(ones_init((d,), dt, device))
        self.mixer = attn.gqa_init(cfg, gen, device)
        self.norm2 = nn.Parameter(ones_init((d,), dt, device))
        self.ffn = (ffn_mod.moe_init if self.moe else ffn_mod.dense_ffn_init)(cfg, gen, device)


class LM(nn.Module):
    """A decoder-only LM of a GQA config (dense or MoE FFNs), initialised from ``seed``
    (the configs are shapes; no weights are loaded)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device: DeviceLike = None):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        gen = make_generator(seed, device)
        d, V, dt = cfg.d_model, cfg.vocab, cfg.param_dtype
        self.embed = nn.Parameter(embed_init(gen, (V, d), dt, device))
        self.final_norm = nn.Parameter(ones_init((d,), dt, device))
        self.head = None if cfg.tie_embeddings else nn.Parameter(dense_init(gen, (d, V), dt, device))
        self.layers = nn.ModuleList(Layer(cfg, kind, gen, device) for kind in cfg.layer_kinds())
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def param_count(cfg: ModelConfig) -> int:
    return count_params(LM(cfg, device="meta"))


def _logits(cfg: ModelConfig, model: LM, x: torch.Tensor) -> torch.Tensor:
    head = model.embed.T if cfg.tie_embeddings else model.head
    return (x @ head).to(torch.float32)


def _ffn(cfg: ModelConfig, layer: Layer, h: torch.Tensor, *, with_aux: bool = True):
    """The layer's FFN: (y, aux), aux None for a dense layer or without
    ``with_aux``."""
    if layer.moe:
        return ffn_mod.moe_apply(cfg, layer.ffn, h, with_aux=with_aux)
    return ffn_mod.dense_ffn_apply(layer.ffn, h), None


def apply_layer(cfg: ModelConfig, layer: Layer, x, *, pos0: int = 0):
    """Full-sequence layer. Returns (x, cache_entry, aux), aux None for a
    dense layer."""
    h = _rmsnorm(x, layer.norm1, cfg.norm_eps)
    y, entry = attn.gqa_apply(cfg, layer.mixer, h, pos0=pos0)
    x = x + y
    y2, aux = _ffn(cfg, layer, _rmsnorm(x, layer.norm2, cfg.norm_eps))
    return x + y2, entry, aux


def apply_layer_decode(cfg: ModelConfig, layer: Layer, x, cache, pos: int):
    """One-token layer step; updates the layer's cache in place."""
    h = _rmsnorm(x, layer.norm1, cfg.norm_eps)
    y, cache = attn.gqa_decode(cfg, layer.mixer, h, cache, pos)
    x = x + y
    return x + _ffn(cfg, layer, _rmsnorm(x, layer.norm2, cfg.norm_eps), with_aux=False)[0]


def forward(cfg: ModelConfig, model: LM, tokens: torch.Tensor, *, pos0: int = 0,
            collect_cache: bool = False, logits_mode: str = "all"):
    """tokens (B, S) int -> (logits (B, S, V) float32, extras {aux, entries?}).

    ``aux`` is the MoE aux loss summed over the layers, a float32 scalar
    tensor (the Python 0.0 for a dense model, which launches nothing). ``logits_mode='last'`` projects only the final
    position (what serving prefill needs)."""
    x = model.embed[tokens]
    aux_total = 0.0
    entries = []
    for layer in model.layers:
        x, entry, aux = apply_layer(cfg, layer, x, pos0=pos0)
        if aux is not None:
            aux_total = aux_total + aux
        if collect_cache:
            entries.append(entry)
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    if logits_mode == "last":
        x = x[:, -1:]
    extras = {"aux": aux_total}
    if collect_cache:
        extras["entries"] = entries
    return _logits(cfg, model, x), extras


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    check_supported(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.param_dtype
    return {
        "layers": [attn.gqa_cache_init(cfg, batch, max_len, dtype, device)
                   for _ in range(cfg.n_layers)],
        "index": 0,
    }


def prefill(cfg: ModelConfig, model: LM, tokens: torch.Tensor, cache):
    """Run the full-sequence path and install its K/V into ``cache`` (in
    place). Returns last-position logits (B, 1, V) and the cache."""
    logits, extras = forward(cfg, model, tokens, collect_cache=True, logits_mode="last")
    for layer_cache, entry in zip(cache["layers"], extras["entries"]):
        attn.gqa_fill_cache(cfg, layer_cache, entry, 0)
    cache["index"] = tokens.shape[1]
    return logits, cache


def decode_step(cfg: ModelConfig, model: LM, token: torch.Tensor, cache):
    """token: (B, 1) int. Returns (logits (B, 1, V), cache), the cache
    advanced by one position in place."""
    pos = cache["index"]
    x = model.embed[token]
    for layer, layer_cache in zip(model.layers, cache["layers"]):
        x = apply_layer_decode(cfg, layer, x, layer_cache, pos)
    x = _rmsnorm(x, model.final_norm, cfg.norm_eps)
    cache["index"] = pos + 1
    return _logits(cfg, model, x), cache
