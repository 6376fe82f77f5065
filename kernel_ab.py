#!/usr/bin/env python3
"""Time the forecaster, stream and FSM kernels of two checkouts in turns on one card.

Run from the root of a checkout, on a host with one CUDA card, with the
other checkout (for example the parent commit, unpacked with ``git archive``
into a directory that ``.gitignore`` lists)::

    python3 kernel_ab.py OTHER_ROOT

Each side builds its own kernels (``kernels/_lib.py``, into its own
``build/``) and runs in a process of its own, in the order other, this,
this, other. Each run holds every kernel to its plain version on the timed
inputs and prints, by profiler device time (``chip_smoke.device_ms_per_call``,
20 calls), ``forecaster_scan`` at 2048 x 4380 (a training step's forward,
with and without the checkpoint store, and without the readout) and 2048 x
13140 (the forecast) at S = 8, and ``stream_chunk``'s live, replay and
reactive instances at 2048 x K = 24 (the chunk form) and K = 1-3 (the tick
form) on a seeded live forecaster's stream from hour 696, and the forecast
plan of a 2048-link year (a seeded 8-state readout's predictions, cost
coefficients fitted on the year, per-family margins): ``plan_fleet`` from
arrays with the forecast-gated policy and without it (host clock around a
synchronized call, median of 10), the ``fsm_scan`` kernel inside the gated
plan (profiler device time; the public entry, since the gate's operands
differ between checkouts; ``chip_smoke.py`` holds the gated kernel to its
plain version), and ``fsm_scan``'s reactive and hysteresis instances on that
year's cost planes. The last line is one JSON object:
{"runs": [{"root": ..., "ms": {label: ms}}, ...]}.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_LINKS, STATE, REPS = 2048, 8, 20


def _live_stream(device):
    """A 2048-link runtime in live mode (a seeded 8-state forecaster warmed
    through 600 hours of history, cost coefficients fitted on it) streamed
    to hour 696, and its demand."""
    import numpy as np
    import torch
    from repro_torch.fleet import (FleetRuntime, StreamingForecaster, build_fleet_scenario,
                                   fit_cost_coef, forecast_gated_policy)
    from repro_torch.fleet.engine import routed_cost_series
    from repro_torch.models.ssm import demand_forecaster_init

    sc = build_fleet_scenario(N_LINKS, horizon=1200, history_hours=600, seed=0)
    arrays = sc.fleet.stack(torch.float64, device)
    s = routed_cost_series(arrays, sc.history, hours_per_month=730, device=device)
    pol = forecast_gated_policy(arrays.toggle, np.zeros(N_LINKS), margin=0.05,
                                cost_coef=fit_cost_coef(s.row_demand, s.vpn, s.cci))
    rng = np.random.default_rng(STATE)
    params = dict(demand_forecaster_init(None, STATE, device=device),
                  w=torch.tensor(0.3 * rng.standard_normal(STATE), dtype=torch.float32,
                                 device=device))
    cap = arrays.capacity.cpu().numpy()[:, None]
    fc = StreamingForecaster.from_history(params, np.minimum(sc.history, cap))
    rt = FleetRuntime(sc.fleet, policy=pol, forecaster=fc)
    for t in range(0, 696, 24):
        rt.step_many(sc.demand[:, t:t + 24])
    return rt, sc.demand


def _forecast_plan(device):
    """The 2048-link year (4380 h of history), its stacked arrays, demand on
    the card, and a forecast-gated policy from a seeded 8-state readout."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.fleet import build_fleet_scenario
    from repro_torch.models.ssm import demand_forecaster_init

    sc = build_fleet_scenario(N_LINKS, horizon=8760, history_hours=4380, seed=0)
    rng = np.random.default_rng(0)
    params = dict(demand_forecaster_init(None, STATE, device=device),
                  w=torch.tensor(0.1 * rng.standard_normal(STATE), dtype=torch.float32,
                                 device=device),
                  bias=torch.tensor(0.01 * rng.standard_normal(), dtype=torch.float32,
                                    device=device))
    arrays, pol = cs.forecast_policy(sc, params, device)
    return arrays, torch.as_tensor(sc.demand, dtype=torch.float64, device=device), pol


def time_root(root: str) -> dict:
    """The kernels of the checkout at ``root``: {label: device ms}."""
    sys.path.insert(0, str(Path(root) / "src"))
    sys.path.insert(1, str(HERE))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.forecaster import checkpoint_shape, forecaster_scan
    from repro_torch.kernels.stream_chunk import _stream_chunk_launch

    dev = cs.DEVICE
    _lib.load()
    ms = {}
    for T in (4380, 13140):
        args = cs.forecaster_case(N_LINKS, T, STATE, False, dev)
        ck = torch.empty(checkpoint_shape(N_LINKS, T, STATE), device=dev)
        want = ref.forecaster_scan_ref(*args)
        cs.check(all(cs.same_bits(g, w) for g, w in zip(forecaster_scan(*args), want)),
                 f"forecaster_scan {N_LINKS} x {T} != plain")
        for label, fn in (("", lambda: forecaster_scan(*args)),
                          (" ckpt", lambda: forecaster_scan(*args, ckpt=ck)),
                          (" state", lambda: forecaster_scan(*args, write_y=False))):
            ms[f"forecaster_scan {N_LINKS}x{T}{label}"] = cs.device_ms_per_call(
                fn, REPS, "forecaster_scan", 1)
    from repro_torch.fleet import plan_fleet
    from repro_torch.kernels.fsm_scan import fsm_scan

    arrays, fdemand, pol = _forecast_plan(dev)
    gated = lambda: plan_fleet(arrays, fdemand, policy=pol)
    reactive = lambda: plan_fleet(arrays, fdemand)
    plan = reactive()
    args = cs.fsm_args(arrays, plan["vpn_hourly"], plan["cci_hourly"])
    tp = arrays.toggle
    h_args = args[:7] + (tp.h % 6 + 1, tp.h % 4 + 1)
    for a in (args, h_args):
        got, want = fsm_scan(*a), ref.fsm_scan_ref(*(x.cpu() for x in a))
        cs.check(all(torch.equal(got[k].cpu(), want[k]) for k in want),
                 "fsm_scan on the forecast year's cost planes != plain")
    for _ in range(2):                                                 # in turns
        for key, fn in (("plan_fleet forecast 2048x8760", gated),
                        ("plan_fleet reactive 2048x8760", reactive)):
            ms[key] = min(ms.get(key, float("inf")), cs.sync_ms(fn, 10))
        key = "fsm_scan_kernel in the forecast plan"
        ms[key] = min(ms.get(key, float("inf")), cs.kernel_device_ms(
            gated, REPS, ("fsm_scan_kernel",), per_call=1)["fsm_scan_kernel"])
        for key, a in (("fsm_scan reactive 2048x8760", args),
                       ("fsm_scan hysteresis 2048x8760", h_args)):
            ms[key] = min(ms.get(key, float("inf")),
                          cs.device_ms_per_call(lambda: fsm_scan(*a), REPS, "fsm_scan_kernel", 1))
    rt, demand = _live_stream(dev)
    for K in (24, 1, 2, 3):
        block, _, endo = rt._pack(demand[:, 696:696 + K], None)
        args = rt._chunk_args(torch.from_numpy(block).to(dev), K, endo)
        st = rt._state
        live = (st.ssm_h, st.pred_live, *rt._live)
        gate = (torch.ones((1, N_LINKS), dtype=torch.float64, device=dev),
                torch.ones((1, N_LINKS), dtype=torch.float64, device=dev), rt._live[6], 1)
        calls = {"live": lambda: _stream_chunk_launch("auto", *args, live=live),
                 "replay": lambda: _stream_chunk_launch("auto", *args, gate=gate),
                 "reactive": lambda: _stream_chunk_launch("auto", *args)}
        plain = {"live": lambda: ref.stream_chunk_ref(*args, live=live),
                 "replay": lambda: ref.stream_chunk_ref(*args, gate=gate),
                 "reactive": lambda: ref.stream_chunk_ref(*args)}
        for mode in calls:
            cs.check(all(cs.same_bits(g, w) for g, w in zip(calls[mode](), plain[mode]())),
                     f"stream_chunk {mode} {N_LINKS} x K={K} != plain")
        for mode in ("live", "replay", "reactive", "reactive", "replay", "live"):
            key = f"stream_chunk {mode} {N_LINKS}x{K}"
            ms[key] = min(ms.get(key, float("inf")),
                          cs.device_ms_per_call(calls[mode], REPS, "stream_chunk", 1))
    return ms


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps({"root": sys.argv[2], "ms": time_root(sys.argv[2])}))
        return 0
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    other = str(Path(sys.argv[1]).resolve())
    runs = []
    for root in (other, str(HERE), str(HERE), other):
        res = subprocess.run([sys.executable, str(HERE / "kernel_ab.py"), "--time", root],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:])
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    for key in runs[0]["ms"]:
        print(f"{key}: " + "  ".join(f"{Path(r['root']).name or r['root']} "
                                     f"{r['ms'][key]:.5f}" for r in runs))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
