#!/usr/bin/env python3
"""Drive the PyTorch port's fleet planner on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

What it does, in order (any failure raises and the script exits non-zero
without printing a result):

1. prints the card (``nvidia-smi`` name and power limit), the CUDA and
   ``nvcc`` versions, and builds the two CUDA kernels from
   ``src/repro_torch/csrc`` (the build's seconds and ``ptxas`` report);
2. builds 128 x 8760 and 2048 x 8760 fleets with the port's own scenario
   builder (seed 0; host numpy, once each);
3. the main path: with every launch count at 0, ``plan_fleet`` on CUDA at
   both sizes for both ``renew_in_chunks`` settings, plus the float32 tier
   path (``use_pallas=True``) at 2048 links; then it reads the counts and
   fails unless both kernels launched; the 128-link plans must equal the
   per-link numpy reference (``plan_fleet_reference``) in ``x``/``state``;
4. holds each kernel against its plain PyTorch version on the same inputs
   at both sizes: tiered f64 ``torch.equal``; tiered f32 ``rtol=atol=1e-6``;
   FSM ``x``/``state`` equal and ``total_cost`` ``rtol=1e-12`` against the
   plain version on the card, and every bit equal against the plain version
   on the CPU at 128 links;
5. holds the CUDA ``plan_fleet`` against the CPU one at 16 x 2000;
6. times each kernel, its plain version and ``plan_fleet`` end to end
   (median of CUDA-synchronised runs after warm-up) beside each kernel's
   bound: the larger of its bytes over 3.35 TB/s and its operations over
   the card's peak for their type;
7. prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

It imports ``repro_torch``, torch and numpy only: no JAX and nothing of the
JAX package ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SIZES = ((128, 8760), (2048, 8760))
SMALL = (16, 2000)
SEED = 0
DEVICE = torch.device("cuda")
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, and the
# non-tensor-core float64 and float32 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def sh(*cmd: str) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise SmokeFailure(f"{' '.join(cmd)} failed: {res.stderr.strip()}")
    return res.stdout.strip()


def sync_ms(fn, reps: int, warmup: int = 1):
    """Median milliseconds of ``fn()``, each run bracketed by synchronize()."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def event_ms(fn, reps: int, warmup: int = 2):
    """Median milliseconds of one ``fn()`` on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float, dtype) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tiered_bound(N: int, T: int, K: int, dtype) -> dict:
    size = torch.empty((), dtype=dtype).element_size()
    # month_cum and demand read, cost written; tier tables read once.
    bytes_moved = N * T * 3 * size + 2 * N * K * size
    # hi = lo + d; per tier: min, max, sub, compare, mul, add.
    ops = N * T * (1 + 6 * K)
    return bound(bytes_moved, ops, dtype)


def fsm_bound(N: int, T: int) -> dict:
    # vpn, cci read (f64); x, state written (int32); per-row parameters and total.
    bytes_moved = N * T * (8 + 8 + 4 + 4) + N * (8 * 2 + 4 * 5 + 8)
    # per hour: 2 prefix adds, 2 lagged adds, 2 subs, 2 muls, 2 compares, 1 add.
    ops = N * T * 11
    return bound(bytes_moved, ops, torch.float64)


def print_breakdown(fn, reps: int) -> None:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    and the share of the traced window the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        print("    profiler: no device activity recorded (device time not measured)")
        return
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    print(f"    profiler: device busy {busy / reps / 1e3:.3f} ms per plan, "
          f"{busy / window:.3f} of the traced window (idle share "
          f"{1 - busy / window:.3f}, host-side profiler overhead included)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / reps / 1e3:9.4f} ms  {us / busy:6.1%}  {name[:90]}")


def fsm_args(arrays, vpn, cci):
    tp = arrays.toggle
    ones = torch.ones_like(tp.h)
    return (vpn, cci, tp.theta1, tp.theta2, tp.h, tp.D, tp.T_cci, ones, ones)


def describe_fsm_mismatch(label, got, want, vpn, cci, h):
    from repro_torch.core.togglecci import window_sums

    bad = (got["x"] != want["x"]) | (got["state"] != want["state"])
    if bad.any():
        n, t = (int(i) for i in torch.nonzero(bad)[0])
        rv = window_sums(vpn[n:n + 1].cpu(), int(h[n]))[0, t].item()
        rc = window_sums(cci[n:n + 1].cpu(), int(h[n]))[0, t].item()
        raise SmokeFailure(
            f"{label}: decision differs at row {n}, hour {t}: kernel "
            f"x={int(got['x'][n, t])} state={int(got['state'][n, t])}, plain "
            f"x={int(want['x'][n, t])} state={int(want['state'][n, t])}; "
            f"window sums r_vpn={rv!r} r_cci={rc!r}"
        )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.costmodel import monthly_cumsum
    from repro_torch.fleet import build_fleet_scenario, plan_fleet, plan_fleet_reference
    from repro_torch.kernels import _lib, ops, ref
    from repro_torch.kernels.fsm_scan import fsm_scan
    from repro_torch.kernels.tiered_cost import tiered_cost_batched

    card = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    print(card.splitlines()[0])
    nvcc = _lib._nvcc()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{[l for l in sh(nvcc, '--version').splitlines() if 'release' in l][0]}, "
          f"{torch.cuda.get_device_name(0)}")
    _lib.load()
    print(f"build: {_lib.build_seconds:.2f} s (nvcc, {len(_lib.SOURCES)} sources "
          f"in parallel, one .so)")
    for line in _lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- scenarios (host numpy, built once each) ---------------------------
    scen = {}
    for N, T in SIZES + (SMALL,):
        t0 = time.perf_counter()
        scen[N] = build_fleet_scenario(N, horizon=T, seed=SEED)
        print(f"scenario {N} x {T}: {time.perf_counter() - t0:.2f} s on the host")

    # -- the main path, through the entry point, launches counted -----------
    ops.reset_launches()
    plans = {}
    for N, T in SIZES:
        sc = scen[N]
        for renew in (False, True):
            plans[N, renew] = plan_fleet(sc.fleet, sc.demand, renew_in_chunks=renew)
    N_big = SIZES[-1][0]
    pallas = plan_fleet(scen[N_big].fleet, scen[N_big].demand, use_pallas=True)
    torch.cuda.synchronize()
    main_launches = dict(ops.LAUNCHES)
    print(f"main path launches: {main_launches}")
    for name, n in main_launches.items():
        check(n >= 1, f"kernel {name} was not launched on the main path")

    for (N, renew), out in plans.items():
        T = dict(SIZES)[N]
        check(out["x"].shape == (N, T) and out["state"].shape == (N, T),
              f"plan {N}: shapes {tuple(out['x'].shape)}")
        check(out["x"].device.type == DEVICE.type, "plan did not run on the card")
        for k in ("toggle_cost", "static_vpn", "static_cci", "vpn_hourly", "cci_hourly"):
            check(bool(torch.isfinite(out[k]).all()), f"plan {N}: {k} not finite")
        check(bool(((out["x"] == 0) | (out["x"] == 1)).all()), "x not 0/1")
        check(bool((out["toggle_cost"] > 0).all()), f"plan {N}: toggle cost not positive")
        print(f"plan {N} x {T} renew={renew}: CCI share "
              f"{out['x'].double().mean().item():.4f}, toggle/static_vpn "
              f"{(out['toggle_cost'].sum() / out['static_vpn'].sum()).item():.6f}")
    rel = ((pallas["toggle_cost"] - plans[N_big, False]["toggle_cost"]).abs()
           / plans[N_big, False]["toggle_cost"]).max().item()
    print(f"use_pallas (f32 tiers) vs f64 at {N_big} links: toggle_cost max rel diff {rel:.3e}, "
          f"x differs in {int((pallas['x'] != plans[N_big, False]['x']).sum())} link-hours")
    check(rel < 1e-3, "float32 tier path drifted from float64 by more than 1e-3")

    N128 = SIZES[0][0]
    for renew in (False, True):
        t0 = time.perf_counter()
        want = plan_fleet_reference(scen[N128].fleet, scen[N128].demand,
                                    renew_in_chunks=renew)
        got = plans[N128, renew]
        check(np.array_equal(got["x"].cpu().numpy(), want["x"]),
              f"128-link plan (renew={renew}): x differs from the numpy reference")
        check(np.array_equal(got["state"].cpu().numpy(), want["state"]),
              f"128-link plan (renew={renew}): state differs from the numpy reference")
        check(np.allclose(got["toggle_cost"].cpu().numpy(), want["toggle_cost"],
                          rtol=1e-9, atol=0), "128-link toggle cost vs numpy reference")
        print(f"{N128} x {dict(SIZES)[N128]} renew={renew}: CUDA plan == numpy "
              f"per-link reference "
              f"({time.perf_counter() - t0:.1f} s)")

    # -- kernels against their plain versions, same inputs ------------------
    inputs, kernel_rows = {}, {}
    for N, T in SIZES:
        sc = scen[N]
        arrays = sc.fleet.stack(torch.float64, DEVICE)
        demand = torch.as_tensor(sc.demand, dtype=torch.float64, device=DEVICE)
        d = torch.minimum(demand, arrays.capacity[:, None])
        cum = monthly_cumsum(d, sc.fleet.hours_per_month)
        tab = (arrays.tier_bounds, arrays.tier_rates)
        inputs[N] = (arrays, demand, d, cum, tab)

        got = tiered_cost_batched(cum, d, *tab)
        want = ref.tiered_cost_batched_ref(cum, d, *tab)
        check(torch.equal(got, want), f"tiered f64 kernel != plain at {N} x {T}")
        err64 = (got - want).abs().max().item()
        f32 = [a.float().contiguous() for a in (cum, d, *tab)]
        got32 = tiered_cost_batched(*f32)
        want32 = ref.tiered_cost_batched_ref(*f32)
        torch.testing.assert_close(got32, want32, rtol=1e-6, atol=1e-6)
        err32 = (got32 - want32).abs().max().item()
        print(f"tiered {N} x {T}: f64 kernel == plain (bit for bit); "
              f"f32 max abs err {err32:.3e}")

        plan = plans[N, False]
        vpn, cci = plan["vpn_hourly"], plan["cci_hourly"]
        fsm_err = 0.0
        for renew in (False, True):
            args = fsm_args(arrays, vpn, cci)
            got = fsm_scan(*args, renew_in_chunks=renew)
            want = ref.fsm_scan_ref(*args, renew_in_chunks=renew)
            describe_fsm_mismatch(f"FSM {N} renew={renew} vs plain on the card",
                                  got, want, vpn, cci, arrays.toggle.h)
            torch.testing.assert_close(got["total_cost"], want["total_cost"],
                                       rtol=1e-12, atol=0)
            fsm_err = max(fsm_err, (got["total_cost"] - want["total_cost"]).abs().max().item())
            if N == N128:
                cpu = ref.fsm_scan_ref(*(a.cpu() for a in args), renew_in_chunks=renew)
                describe_fsm_mismatch(f"FSM {N} renew={renew} vs plain on the CPU",
                                      {k: v.cpu() for k, v in got.items()}, cpu,
                                      vpn, cci, arrays.toggle.h)
                for k in ("x", "state", "total_cost"):
                    check(torch.equal(got[k].cpu(), cpu[k]),
                          f"FSM {N} renew={renew}: {k} not bit-equal to the CPU plain version")
        print(f"fsm {N} x {T}: x/state == plain on the card; total_cost max abs err "
              f"{fsm_err:.3e}" + ("; every bit == plain on the CPU" if N == N128 else ""))
        kernel_rows[N] = {"tiered_err": err64, "tiered32_err": err32, "fsm_err": fsm_err}

    # -- the card against the CPU path the tests hold against JAX -----------
    sc = scen[SMALL[0]]
    for renew in (False, True):
        g = plan_fleet(sc.fleet, sc.demand, renew_in_chunks=renew)
        c = plan_fleet(sc.fleet, sc.demand, renew_in_chunks=renew, device="cpu")
        for k in ("x", "state"):
            check(torch.equal(g[k].cpu(), c[k]), f"{SMALL}: {k} CUDA != CPU")
        for k in ("toggle_cost", "static_vpn", "static_cci", "vpn_hourly", "cci_hourly"):
            torch.testing.assert_close(g[k].cpu(), c[k], rtol=1e-9, atol=0)
    print(f"plan_fleet {SMALL[0]} x {SMALL[1]}: CUDA == CPU (decisions equal, costs rtol 1e-9)")

    # -- timings --------------------------------------------------------------
    print(f"timings on {card.splitlines()[0]} (median ms; bound = max(bytes / "
          f"3.35 TB/s, ops / peak))")
    timing = {}
    for N, T in SIZES:
        arrays, demand, d, cum, tab = inputs[N]
        K = tab[0].shape[1]
        f32 = [a.float().contiguous() for a in (cum, d, *tab)]
        vpn, cci = plans[N, False]["vpn_hourly"], plans[N, False]["cci_hourly"]
        args = fsm_args(arrays, vpn, cci)
        ops.reset_launches()
        plan_fleet(arrays, demand)
        per_plan = dict(ops.LAUNCHES)
        row = {
            "tiered_f64": (event_ms(lambda: tiered_cost_batched(cum, d, *tab), 20),
                           event_ms(lambda: ref.tiered_cost_batched_ref(cum, d, *tab), 5),
                           tiered_bound(N, T, K, torch.float64)),
            "tiered_f32": (event_ms(lambda: tiered_cost_batched(*f32), 20),
                           event_ms(lambda: ref.tiered_cost_batched_ref(*f32), 5),
                           tiered_bound(N, T, K, torch.float32)),
            "fsm_scan": (event_ms(lambda: fsm_scan(*args), 10),
                         sync_ms(lambda: ref.fsm_scan_ref(*args), 3, warmup=0),
                         fsm_bound(N, T)),
        }
        for name, (ms, plain_ms, b) in row.items():
            print(f"  {name:10s} {N:5d} x {T}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {b['bound_ms'] * 1e3:.1f} us ({b['bound_by']}), "
                  f"{ms / b['bound_ms']:.1f}x bound, launches/plan "
                  f"{per_plan['fsm_scan' if name == 'fsm_scan' else 'tiered_cost_batched']}")
        plan_ms = sync_ms(lambda: plan_fleet(arrays, demand), 10)
        spec_ms = sync_ms(lambda: plan_fleet(scen[N].fleet, scen[N].demand), 3)
        print(f"  plan_fleet {N:5d} x {T}: {plan_ms:.3f} ms from arrays and demand on "
              f"the card; {spec_ms:.3f} ms from FleetSpec + numpy demand (stack + copy "
              f"in); launches/plan {per_plan}")
        print_breakdown(lambda: plan_fleet(arrays, demand), reps=3)
        timing[N] = row

    N, T = SIZES[-1]
    rows = timing[N]
    kernels = [
        {"name": "tiered_cost_batched", "route": "cuda",
         "source": "src/repro_torch/csrc/tiered_cost.cu",
         "replaces": "src/repro/kernels/tiered_cost.py:95",
         "launches": main_launches["tiered_cost_batched"],
         "max_abs_err": kernel_rows[N]["tiered_err"],
         "ms": rows["tiered_f64"][0], "plain_ms": rows["tiered_f64"][1],
         **rows["tiered_f64"][2], "library_ms": None},
        {"name": "fsm_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/fsm_scan.cu",
         "replaces": "src/repro/fleet/policy.py:334",
         "launches": main_launches["fsm_scan"],
         "max_abs_err": kernel_rows[N]["fsm_err"],
         "ms": rows["fsm_scan"][0], "plain_ms": rows["fsm_scan"][1],
         **rows["fsm_scan"][2], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
