"""Synthetic operands of the routed chunk kernel (``stream_chunk_routed``) at
chosen port shapes, made from a seed with numpy.

:func:`synthetic_routing` builds a routing operand whose ports hold the legs
asked for (each a distinct pair, in a shuffled leg order, plus padding legs
on a pad pair and pad port), with its port-major index built on the host as
``index_legs`` builds it, launch form included. :func:`synthetic_chunk`
builds every other operand of one chunk call, in the wrapper's order: the
block, the pair and port rows, the carries and the clocks (one clock for
the call, or the pooled instance's clock per port and per pair, months of
24, 40, 168 and 730 hours starting at and inside the chunk), optionally CCI
demand, NaN demand hours and the replay gate's planes with some ports past
their T_pred. ``tests/test_torch_cuda.py`` and ``tests/test_torch_routed_form.py``
use them, and ``routed_forms.py`` times the two forms on them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fleet.routing import RoutingOperand, index_legs

#: Months of the pooled clocks' pairs, in turn.
MONTHS = (24, 40, 168, 730)


def synthetic_routing(port_legs, n_pairs: int, *, pad_legs: int = 0, pad_pair: int = 0,
                      pad_port: int = 0, seed: int = 0, device="cpu") -> RoutingOperand:
    """A routing operand over ``n_pairs`` pairs and ``len(port_legs)``
    ports, port m holding ``port_legs[m]`` legs of distinct pairs (VPN share
    1 / the pair's legs, attachment 1), the legs in a shuffled order, then
    ``pad_legs`` padding legs (``pad_pair`` on ``pad_port``, zero weights),
    with its port-major index."""
    rng = np.random.default_rng(seed)
    legs = [(int(p), m) for m, n in enumerate(port_legs)
            for p in rng.choice(n_pairs, int(n), replace=False)]
    legs = [legs[i] for i in rng.permutation(len(legs))]
    hops = np.bincount([p for p, _ in legs], minlength=n_pairs)
    lp = np.array([p for p, _ in legs] + [pad_pair] * pad_legs, np.int32)
    lm = np.array([m for _, m in legs] + [pad_port] * pad_legs, np.int32)
    vw = np.array([1.0 / hops[p] for p, _ in legs] + [0.0] * pad_legs, np.float64)
    aw = np.array([1.0] * len(legs) + [0.0] * pad_legs, np.float64)
    primary = np.full(n_pairs, pad_port, np.int32)
    for p, m in reversed(legs):
        primary[p] = m
    t = lambda a: torch.from_numpy(a).to(device)
    op = RoutingOperand(leg_pair=t(lp), leg_port=t(lm), vpn_w=t(vw), attach_w=t(aw),
                        primary=t(primary))
    return index_legs(op, len(port_legs))


def synthetic_chunk(routing: RoutingOperand, n_pairs: int, K: int, *, seed: int = 0,
                    device="cpu", n_tiers: int = 4, endo: bool = False, pooled: bool = False,
                    T_pred: int = 0, t0: int = 48, hours_per_month: int = 730,
                    nan=()) -> tuple:
    """``(args, kwargs)`` of ``stream_chunk_routed(*args, **kwargs)`` (and its
    plain version) over ``routing``: K hours of pair-major demand clipped by
    some capacities, tiers of ``n_tiers`` bounds, random carries. ``pooled``:
    per-port first hours around ``t0`` and per-pair clocks (months of
    :data:`MONTHS`, some starting at the chunk's first hour, some inside it);
    else the call's ``t0`` and ``hours_per_month``. ``T_pred`` > 0: the
    replay gate's (T_pred, M) planes and margins. ``endo``: CCI demand.
    ``nan``: (pair, hour) demand entries (and CCI demand entries) set to
    NaN."""
    rng = np.random.default_rng(seed)
    P, M = n_pairs, routing.index.n_ports
    f64, i32 = torch.float64, torch.int32
    t = lambda a, dt=f64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)
    demand = rng.uniform(0.0, 400.0, (P, K))
    cci = rng.uniform(0.0, 500.0, (P, K)) if endo else None
    for p, k in nan:
        demand[p, k] = np.nan
        if endo:
            cci[p, k] = np.nan
    parts = [demand.ravel()]
    if endo:
        parts.append(cci.ravel())
    parts += [rng.uniform(0.0, 2e4, (K, M)).ravel(), rng.uniform(0.0, 2e4, (K, M)).ravel()]
    block = t(np.concatenate(parts))
    cap = rng.uniform(150.0, 400.0, P)
    L_vpn = rng.uniform(0.0, 0.5, P)
    steps = rng.uniform(1e3, 4e4, (P, n_tiers))
    bounds = np.cumsum(steps, axis=1)
    bounds[:, -1] = 1e12
    rates = np.sort(rng.uniform(0.02, 0.12, (P, n_tiers)), axis=1)[:, ::-1]
    pair = [t(cap), t(L_vpn), t(bounds), t(rates)]
    port = [t(rng.uniform(0.5, 3.0, M)), t(rng.uniform(0.01, 0.03, M)),
            t(rng.uniform(300.0, 1500.0, M)), t(rng.uniform(0.7, 1.0, M)),
            t(rng.uniform(1.0, 1.4, M)), t(rng.integers(1, 120, M), i32),
            t(rng.integers(0, 30, M), i32), t(rng.integers(1, 100, M), i32),
            t(rng.integers(1, 4, M), i32), t(rng.integers(1, 4, M), i32)]
    dcum = rng.uniform(0.0, 6e4, P)
    cal = t(np.stack([dcum, dcum * rng.uniform(0.0, 1.0, P)]))
    fsm = t(np.stack([rng.integers(0, 3, M), rng.integers(0, 200, M), rng.integers(0, 3, M),
                      rng.integers(0, 3, M)]), i32)
    pref = t(rng.uniform(0.0, 1e5, (2, M)))
    args = [block, K, endo, *pair, port[0], port[1], port[2], *port[3:], routing, cal, fsm,
            pref]
    kw = dict(renew_in_chunks=bool(rng.integers(0, 2)))
    if pooled:
        hpm = np.array([MONTHS[p % 4] for p in range(P)])
        # every fourth pair starts a month at the chunk's first hour, the
        # others somewhere in their month (inside the chunk for the short ones)
        phase = np.where(np.arange(P) % 4 == 0, 0, rng.integers(0, hpm))
        t0_pair = rng.integers(1, 4, P) * hpm + phase
        t0_port = np.maximum(0, t0 + rng.integers(-30, 31, M))
        kw["clocks"] = (t(t0_port, i32), t(hpm, i32), t(t0_pair, i32))
    else:
        args += [t0, hours_per_month]
    if T_pred:
        kw["gate"] = (t(rng.uniform(0.0, 300.0, (T_pred, M))),
                      t(rng.uniform(0.0, 300.0, (T_pred, M))),
                      t(rng.uniform(0.0, 0.1, M)), T_pred)
    return args, kw
