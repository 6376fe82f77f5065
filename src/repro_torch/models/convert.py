"""Carry the reference's LM parameters into the port's :class:`LM`.

The reference (:func:`repro.models.lm.init_params`) keeps its parameters as a
pytree whose layers are stacked along a leading ``rep`` axis per segment
pattern position. :func:`params_from_reference` takes that tree as nested
dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``; the
port never sees JAX) and returns a state dict for ``LM.load_state_dict``,
one entry per layer in depth order. The weights keep the reference's
``(in, out)`` layout, which the port also uses (``x @ W``), and their
dtypes (a MoE router stays float32); nested groups (a MoE layer's
``shared`` expert) become dotted names.

:func:`tree_from_reference` carries any other state of the reference
(gradients, error-feedback residuals) into the port's pytrees of tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_map

from .common import ModelConfig
from .lm import check_supported


def _layer_leaves(prefix: str, group, r: int):
    """(name, repeat r of the leaf) over a layer group's nested dict."""
    for name, a in group.items():
        if isinstance(a, dict):
            yield from _layer_leaves(f"{prefix}.{name}", a, r)
        else:
            yield f"{prefix}.{name}", a[r]


def params_from_reference(cfg: ModelConfig, tree) -> Dict[str, torch.Tensor]:
    check_supported(cfg)
    t = lambda a: torch.tensor(np.asarray(a))
    state = {"embed": t(tree["embed"]), "final_norm": t(tree["final_norm"])}
    if not cfg.tie_embeddings:
        state["head"] = t(tree["head"])
    i = 0
    for (pattern, rep), seg in zip(cfg.segments, tree["segments"]):
        for r in range(rep):
            for pi in range(len(pattern)):
                lp = seg[pi]
                state[f"layers.{i}.norm1"] = t(lp["norm1"][r])
                state[f"layers.{i}.norm2"] = t(lp["norm2"][r])
                for group in ("mixer", "ffn"):
                    for name, a in _layer_leaves(f"layers.{i}.{group}", lp[group], r):
                        state[name] = t(a)
                i += 1
    if i != cfg.n_layers:
        raise ValueError(f"reference tree has {i} layers, config {cfg.n_layers}")
    return state


def tree_from_reference(tree, device: DeviceLike = None):
    """A pytree of the reference's numpy arrays as the port's pytree of
    tensors on ``device`` (``None``: the card): gradients, error-feedback
    residuals or any other carried state, given as ``jax.tree.map(np.asarray,
    tree)``. Dicts, lists, tuples and ``None`` keep their structure
    (:func:`repro_torch.tree.tree_map`); each array keeps its shape and
    dtype, bfloat16 included (``ml_dtypes`` arrays are reinterpreted bit for
    bit)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a, copy=True)                   # writable, contiguous, owned
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return tree_map(leaf, tree)
