"""Carry the reference's LM parameters into the port's :class:`LM`.

The reference (:func:`repro.models.lm.init_params`) keeps its parameters as a
pytree whose layers are stacked along a leading ``rep`` axis per segment
pattern position. :func:`params_from_reference` takes that tree as nested
dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``; the
port never sees JAX) and returns a state dict for ``LM.load_state_dict``,
one entry per layer in depth order. The weights keep the reference's
``(in, out)`` layout, which the port also uses (``x @ W``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .common import ModelConfig
from .lm import check_supported


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
                    for name, a in lp[group].items():
                        state[f"layers.{i}.{group}.{name}"] = t(a[r])
                i += 1
    if i != cfg.n_layers:
        raise ValueError(f"reference tree has {i} layers, config {cfg.n_layers}")
    return state
