"""Serving steps: prefill + single-token decode, plus a minimal batched
greedy loop. Port of :mod:`repro.train.serve`; PyTorch runs eagerly, so the
steps are the model's entry points themselves (no ``jit``)."""
from __future__ import annotations

import functools

import torch

from repro_torch.models import lm
from repro_torch.models.common import ModelConfig


def make_prefill(cfg: ModelConfig):
    """prefill(model, tokens (B, S), cache) -> (logits (B, 1, V), cache)."""
    return functools.partial(lm.prefill, cfg)


def make_decode_step(cfg: ModelConfig):
    """decode_step(model, token (B, 1), cache) -> (logits (B, 1, V), cache)."""
    return functools.partial(lm.decode_step, cfg)


@torch.inference_mode()
def greedy_generate(cfg: ModelConfig, model: lm.LM, prompt: torch.Tensor,
                    max_new: int) -> torch.Tensor:
    """Batched greedy decoding on the model's device: ``max_new`` tokens
    (B, max_new) int32 after the prompt (B, S)."""
    prompt = prompt.to(model.device)
    B, S = prompt.shape
    cache = lm.init_cache(cfg, B, S + max_new, device=model.device)
    prefill, step = make_prefill(cfg), make_decode_step(cfg)
    logits, cache = prefill(model, prompt, cache)  # (B, 1, V)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for _ in range(max_new - 1):
        logits, cache = step(model, tok, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
