#!/usr/bin/env python3
"""Time the routed chunk's two launch forms over a sweep of port shapes on one card.

Run from the root of a checkout, on a host with one CUDA card::

    python3 routed_forms.py [LEGS PORTS]

(``LEGS`` and ``PORTS`` as comma-separated lists, to sweep fewer shapes.)

``stream_chunk_routed`` (``src/repro_torch/csrc/stream_chunk_routed.cu``)
launches in the port-block form (a 512-thread block a port) or the
small-port form (a warp a port, several ports a block, at most 32 legs a
port). This script builds synthetic routings (``tests/_routed_cases.py``)
of M ports of L legs each over 4 pairs a port (the gateway bucket's ratio),
for L in LEGS, M in PORTS and K in KS, plus the gateway bucket's own leg
counts (2048 ports of 0-12 legs), and times the reactive scalar instance in
both forms in turns (port-block, small-port, small-port, port-block; the
small-port form up to 32 legs) by profiler device time
(``chip_smoke.device_ms_per_call``, REPS calls each); every small-port
result equals the port-block result in every bit. Each row also says which
form the selection rule (``routed_form``) takes there. Prints the card's
name and power limit, a line a shape, and as its last line one JSON object
``{"card": ..., "rows": [...]}``; each row holds the shape, both forms'
best times in ms (``small_ms`` null past 32 legs) and the rule's form.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
LEGS = (4, 8, 12, 16, 24, 32, 64)
PORTS = (32, 128, 133, 192, 256, 384, 512, 2048)
KS = (1, 24)
PAIRS_PER_PORT = 4
BUCKET_LEGS = (12, 0, 4, 4, 3, 2, 6, 1)    # a gateway slot's 8 ports (tests/test_torch_cuda.py)
REPS = 20


def _case(port_legs, K, device):
    from _routed_cases import synthetic_chunk, synthetic_routing

    P = PAIRS_PER_PORT * len(port_legs)
    r = synthetic_routing(port_legs, max(P, max(port_legs)), seed=7, device=device)
    return synthetic_chunk(r, r.n_rows, K, seed=K, device=device)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("routed_forms: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(HERE / "src"), str(HERE / "tests"), str(HERE)]
    import chip_smoke as cs
    from repro_torch.kernels import stream_chunk as scm

    legs, ports = LEGS, PORTS
    if len(sys.argv) == 3:
        legs, ports = (tuple(int(v) for v in a.split(",")) for a in sys.argv[1:])
    card = cs.sh("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()[0]
    print(card)
    dev = torch.device("cuda")

    def timed(args, kw, form):
        fn = lambda: scm.stream_chunk_routed(*args, **kw, form=form)
        return cs.device_ms_per_call(fn, REPS, "routed_", 1)

    shapes = [(f"{L} legs", [L] * M) for L in legs for M in ports]
    shapes.append(("bucket", list(BUCKET_LEGS) * 256))
    rows = []
    for label, port_legs in shapes:
        for K in KS:
            args, kw = _case(port_legs, K, dev)
            small = max(port_legs) <= scm.SMALL_PORT_MAX_LEGS
            pb = scm.stream_chunk_routed(*args, **kw, form="port_block")
            if small:
                sp = scm.stream_chunk_routed(*args, **kw, form="small_port")
                cs.check(cs.same_bits(sp[0], pb[0]) and cs.same_bits(sp[1], pb[1]),
                         f"{label} x {len(port_legs)} ports, K = {K}: small-port != port-block")
            ms = {"port_block": [], "small_port": []}
            for form in ("port_block", "small_port", "small_port", "port_block"):
                if form == "port_block" or small:
                    ms[form].append(timed(args, kw, form))
            row = {"shape": label, "ports": len(port_legs), "legs": max(port_legs), "K": K,
                   "port_block_ms": min(ms["port_block"]),
                   "small_ms": min(ms["small_port"]) if small else None,
                   "rule": scm.routed_form(max(port_legs), len(port_legs))}
            rows.append(row)
            ratio = (f", small / port-block {row['small_ms'] / row['port_block_ms']:.3f}"
                     if small else "")
            print(f"  {label:8s} x {len(port_legs):4d} ports, K = {K:2d}: port-block "
                  f"{row['port_block_ms']:.5f} ms"
                  + (f", small-port {row['small_ms']:.5f} ms" if small else "") + ratio
                  + f"; the rule takes the {row['rule']} form", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
