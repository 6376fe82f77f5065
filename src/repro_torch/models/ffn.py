"""FFN layers of the port: the dense gated (SwiGLU) and GELU MLPs.

Port of the dense part of :mod:`repro.models.ffn`. The projections are plain
``torch.matmul`` on the reference's ``(in, out)`` weights, as the reference
leaves them to XLA. The MoE layer is not ported yet (ROADMAP Queue 1,
item 11).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, dense_init


def dense_ffn_init(cfg: ModelConfig, gen: torch.Generator, device, *, d_ff: int = 0,
                   gated: bool = True) -> torch.nn.ParameterDict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    if gated:
        return torch.nn.ParameterDict({
            "wg": dense_init(gen, (d, f), dt, device),
            "wi": dense_init(gen, (d, f), dt, device),
            "wo": dense_init(gen, (f, d), dt, device, fan_in=f),
        })
    return torch.nn.ParameterDict({
        "wi": dense_init(gen, (d, f), dt, device),
        "wo": dense_init(gen, (f, d), dt, device, fan_in=f),
    })


def dense_ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wo"]


def moe_apply(cfg: ModelConfig, p, x):
    raise NotImplementedError("the MoE layer is not ported yet (ROADMAP Queue 1, item 11)")
