"""FFN layers of the port: the dense gated (SwiGLU) and GELU MLPs, and the
capacity-based MoE.

Port of :mod:`repro.models.ffn`. The projections are plain ``torch.matmul``
on the reference's ``(in, out)`` weights, as the reference leaves them to
XLA. The MoE layer groups tokens as the reference does and routes each
group through three kernels (:func:`repro_torch.kernels.ops.moe_route`,
``moe_dispatch``, ``moe_combine``) around the expert SwiGLU, whose three
products stay ``torch.bmm`` over the (E, G·C, d) buffer (the reference's
einsums, left to XLA). The reference's sharding pins (``constrain_vjp``,
``pin``) are identities without a mesh and are not ported (ROADMAP Queue 1,
item 12).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

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


def moe_init(cfg: ModelConfig, gen: torch.Generator, device) -> torch.nn.ParameterDict:
    """The router (d, E), float32 whatever ``param_dtype`` is, the experts'
    ``wg``/``wi`` (E, d, f) and ``wo`` (E, f, d), and a ``shared`` dense
    SwiGLU of width ``d_ff_expert · n_shared`` when the config has shared
    experts."""
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff_expert
    dt = cfg.param_dtype
    p = torch.nn.ParameterDict({
        "router": dense_init(gen, (d, E), torch.float32, device),
        "wg": dense_init(gen, (E, d, f), dt, device, fan_in=d),
        "wi": dense_init(gen, (E, d, f), dt, device, fan_in=d),
        "wo": dense_init(gen, (E, f, d), dt, device, fan_in=f),
    })
    if m.n_shared:
        p["shared"] = dense_ffn_init(cfg, gen, device, d_ff=f * m.n_shared)
    return p


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots an expert holds in a group of ``group`` tokens, the reference's
    float expression (``src/repro/models/ffn.py:76``)."""
    m = cfg.moe
    return max(8, int(group * m.top_k / m.n_experts * m.capacity_factor))


def moe_apply(cfg: ModelConfig, p, x: torch.Tensor, *, with_aux: bool = True):
    """x: (B, S, d) -> (y (B, S, d), aux loss). The tokens of each batch row
    form groups of ``min(group_size, S)`` (S must be a multiple of it); each
    group's tokens go to their top-k experts up to the capacity, the
    experts' SwiGLU runs on the (E, G·C, d) buffer and the rows come back
    weighted. The aux loss is the mean over the groups; ``with_aux=False``
    returns None in its place and launches no mean (decode drops the loss)."""
    m = cfg.moe
    B, S, d = x.shape
    g = min(m.group_size, S)
    if S % g:
        raise ValueError(f"sequence length {S} is not a multiple of the MoE group {g}")
    G, E, k = B * (S // g), m.n_experts, m.top_k
    C = capacity(cfg, g)
    xg = x.reshape(G, g, d)
    r = ops.moe_route(xg.to(torch.float32) @ p["router"], k, C, router=m.router,
                      aux_coef=m.aux_coef)
    buf = ops.moe_dispatch(xg, r.src, k).view(E, G * C, d)
    h = F.silu(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    out = torch.bmm(h, p["wo"]).view(E, G, C, d)
    y = ops.moe_combine(out, r.gate_idx, r.pos, r.keep, r.gate_w).view(B, S, d)
    if m.n_shared:
        y = y + dense_ffn_apply(p["shared"], x)
    return y, (r.aux.mean() if with_aux else None)
