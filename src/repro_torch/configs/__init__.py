"""Architecture registry of the port: ``get_config(arch_id)`` / ``--arch`` ids.

Copies of :mod:`repro.configs` (pure data): each module holds the published
configuration, and ``reduce_config`` shrinks one for CPU tests and demos.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.common import LayerKind, MLAConfig, ModelConfig, MoEConfig

from . import (  # noqa: F401
    deepseek_7b,
    deepseek_v3_671b,
    h2o_danube3_4b,
    internvl2_2b,
    jamba_v0_1_52b,
    mixtral_8x7b,
    tinyllama_1_1b,
    whisper_tiny,
    xlstm_1_3b,
    yi_6b,
)

REGISTRY = {
    "mixtral-8x7b": mixtral_8x7b.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "deepseek-7b": deepseek_7b.CONFIG,
    "tinyllama-1.1b": tinyllama_1_1b.CONFIG,
    "h2o-danube-3-4b": h2o_danube3_4b.CONFIG,
    "yi-6b": yi_6b.CONFIG,
    "whisper-tiny": whisper_tiny.CONFIG,
    "internvl2-2b": internvl2_2b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def reduce_config(cfg: ModelConfig, *, d_model=64, n_heads=2, vocab=256) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests: small widths, few
    layers (one repeat of every pattern), tiny embeddings, 2-4 experts."""
    hd = d_model // n_heads
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    segments = tuple((pattern, min(rep, 2 if len(pattern) == 1 else 1)) for pattern, rep in cfg.segments)
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=d_model * 2,
            n_shared=min(cfg.moe.n_shared, 1),
            group_size=64,
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
    return dataclasses.replace(
        cfg,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=d_model * 3 if cfg.d_ff else 0,
        vocab=vocab,
        segments=segments,
        moe=moe,
        mla=mla,
        window=min(cfg.window, 32) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_frames=min(cfg.encoder_frames, 16),
        n_patches=min(cfg.n_patches, 4),
        mamba_dt_rank=8,
        dtype="float32",
        remat="none",
    )
