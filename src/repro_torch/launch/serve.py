"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Port of :mod:`repro.launch.serve`: a batched request loop over the
prefill/decode steps of ``reduce_config(get_config(arch))`` with weights
initialised from seed 0, so it is a demo; ``chip_smoke.py`` drives the
full-width models. Runs on the card unless ``--device cpu`` is given; the
GQA architectures with dense or MoE FFNs are ported (``--arch
mixtral-8x7b`` serves through the MoE kernels); the others raise.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--requests", type=int, default=3, help="request batches")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models.lm import LM
    from repro_torch.train.serve import greedy_generate

    cfg = reduce_config(get_config(args.arch))
    model = LM(cfg, seed=0, device=args.device)
    total_tokens = 0
    t0 = time.time()
    for r in range(args.requests):
        gen = torch.Generator().manual_seed(100 + r)
        prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen)
        out = greedy_generate(cfg, model, prompts, args.max_new)
        total_tokens += out.numel()
        print(f"request batch {r}: generated {tuple(out.shape)} tokens")
    dt = time.time() - t0
    print(f"served {args.requests} batches on {model.device}, {total_tokens} tokens, "
          f"{total_tokens / dt:.1f} tok/s (kernel build included on the card)")


if __name__ == "__main__":
    main()
