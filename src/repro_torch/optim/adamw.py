"""AdamW over pytrees of tensors, in plain torch ops.

Port of :mod:`repro.optim.adamw`: the same config, the same update in the
same order of operations, global-norm clipping included. Trees are the
port's containers (:mod:`repro_torch.tree`: dicts walked in sorted key
order, as JAX flattens them); every leaf update is elementwise on the
leaf's device.

Three places fix an order of operations or a rounding the reference leaves
to XLA, so that an update on the card has the bits of the same update on the
CPU:

* :func:`global_norm` sums each leaf's squares by a pairwise halving fold
  (elementwise adds of fixed shapes), then folds the leaves' sums left in
  tree order, then takes the square root. No reduction kernel, whose order
  differs between devices, runs.
* The bias corrections ``1 − b1^step`` and ``1 − b2^step`` are formed in
  float32 on the host (numpy) and divide as 0-dim tensors on the leaf's
  device, so both devices divide (CUDA turns a division by a Python number
  into a product with its reciprocal).
* Every square root is taken in float64 and rounded to float32
  (:func:`_sqrt`): torch's float32 square root on the card is not always
  correctly rounded (it can differ from the CPU's in the last bit), the
  float64 one is, and a float64 square root of a float32 rounds to the
  correctly rounded float32 one, the CPU's bits.

The step count is a host ``int`` (the reference's is an int32 array).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    if cfg.moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"moment_dtype must be one of {sorted(_MOMENT_DTYPES)}, "
                         f"got {cfg.moment_dtype!r}")
    return _MOMENT_DTYPES[cfg.moment_dtype]


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero first and second moments shaped like ``params`` (in
    ``cfg.moment_dtype``, on each leaf's device) and step 0."""
    dt = _moment_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """Σ x² in float32 as a 0-dim tensor: the squares, then a pairwise
    halving fold (the first half plus the second, an odd last element
    carried), the same adds on every device."""
    x = x.to(torch.float32).reshape(-1)
    x = x * x
    if x.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    while x.numel() > 1:
        half = x.numel() // 2
        y = x[:half] + x[half:2 * half]
        x = torch.cat([y, x[2 * half:]]) if x.numel() % 2 else y
    return x[0]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree`` (0-dim tensor): each
    leaf's squared sum (:func:`_square_sum`), folded left in tree order."""
    acc = None
    for leaf in tree_leaves(tree):
        s = _square_sum(leaf)
        acc = s if acc is None else acc + s
    if acc is None:
        raise ValueError("global_norm of a tree with no leaves")
    return _sqrt(acc)


def _bias_correction(b: float, step: int) -> float:
    """``1 − b^step`` in float32, as the reference forms it on its device."""
    return float(np.float32(1.0) - np.float32(b) ** np.float32(step))


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """Returns ``(new_params, new_state, metrics)``. ``lr_scale`` multiplies
    the base lr (schedules compose here). ``metrics`` holds ``grad_norm`` and
    ``clip_scale`` (0-dim tensors on the first leaf's device; ``clip_scale``
    is 1.0 when ``clip_norm`` is 0)."""
    step = int(state["step"]) + 1
    gnorm = global_norm(grads)
    dev = gnorm.device
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    if cfg.clip_norm:
        scale = torch.minimum(f32(1.0), f32(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9))
    else:
        scale = 1.0
    b1, b2 = cfg.b1, cfg.b2
    bc1, bc2 = f32(_bias_correction(b1, step)), f32(_bias_correction(b2, step))
    lr = cfg.lr * lr_scale
    mdt = _moment_dtype(cfg)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        update = (m32 / bc1) / (_sqrt(v32 / bc2) + cfg.eps)
        update = update + cfg.weight_decay * p.to(torch.float32)
        newp = p.to(torch.float32) - lr * update
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    results = []
    tree_map(lambda *leaves: results.append(upd(*leaves)), params, grads, state["m"], state["v"])

    def rebuild(i):
        it = iter(results)
        return tree_map(lambda _: next(it)[i], params)

    return (rebuild(0), {"m": rebuild(1), "v": rebuild(2), "step": step},
            {"grad_norm": gnorm, "clip_scale": scale})
