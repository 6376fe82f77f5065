"""Model substrate of the port: configuration schema and shared pieces.

Port of :mod:`repro.models.common`. The config dataclasses are copied (one
:class:`ModelConfig` describes every architecture of :mod:`repro_torch.configs`);
``param_dtype`` gives a ``torch.dtype``. The initialisers draw from an
explicit ``torch.Generator`` on the parameter's device (on ``meta`` they only
allocate). RoPE keeps the reference's rotate-half form and its order of
operations: float32 tables, float32 arithmetic, one cast at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

# ---------------------------------------------------------------------------
# Config schema
# ---------------------------------------------------------------------------

MIXERS = ("gqa", "mla", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str = "gqa"
    ffn: str = "dense"
    cross: bool = False   # add a cross-attention sublayer (whisper decoder)

    def __post_init__(self):
        assert self.mixer in MIXERS and self.ffn in FFNS


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0             # shared (always-on) experts, DeepSeek-V3
    router: str = "softmax"       # 'softmax' | 'sigmoid' (DeepSeek-V3)
    capacity_factor: float = 1.25
    group_size: int = 1024        # dispatch group (tokens) — memory knob
    aux_coef: float = 0.01        # load-balance loss (0 for sigmoid/aux-free)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|encdec|vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Tuple[Tuple[Tuple[LayerKind, ...], int], ...]
    head_dim: int = 0             # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    window: int = 0               # sliding-window attention (0 = full)
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # SSM (mamba) dims
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_dt_rank: int = 0        # 0 -> ceil(d_model / 16)
    mamba_conv: int = 4
    # xLSTM dims
    xlstm_proj_factor: float = 2.0   # mLSTM up-projection
    slstm_ffn_factor: float = 4.0 / 3.0
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_frames: int = 1500    # stub conv-frontend output length
    # VLM (internvl): stub ViT prefix length at train/prefill
    n_patches: int = 0
    # DeepSeek-V3 multi-token prediction module
    mtp: bool = False
    # dtypes
    dtype: str = "bfloat16"
    # Remat policy for the scan body: 'none' | 'full' | 'dots'
    remat: str = "full"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(len(pat) * rep for pat, rep in self.segments)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def xlstm_d_inner(self) -> int:
        return int(self.xlstm_proj_factor * self.d_model)

    def layer_kinds(self):
        """Flat list of LayerKind over depth (for inspection/tests)."""
        out = []
        for pat, rep in self.segments:
            out.extend(list(pat) * rep)
        return out


def uniform_segments(kind: LayerKind, n_layers: int):
    return (((kind,), n_layers),)


# ---------------------------------------------------------------------------
# Initialization helpers (explicit generator; float32 draw, then the cast)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, device, *, fan_in: Optional[int] = None):
    """Truncated normal at ±2σ with σ = 1/sqrt(fan_in) (LeCun-ish)."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(max(1, fan_in))
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=gen)
    return w.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.normal_(w, std=0.02, generator=gen)
    return w.to(dtype)


def ones_init(shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator that can fill tensors on ``device`` (a CPU one for
    ``meta``, where filling is a no-op)."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for rotate-half RoPE. positions: (...,) int."""
    assert dim % 2 == 0
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); cos/sin: (S, D/2) — leading dims broadcast."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    shape = (1,) * (x1.ndim - 2) + tuple(cos.shape)
    cos, sin = cos.reshape(shape), sin.reshape(shape)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
