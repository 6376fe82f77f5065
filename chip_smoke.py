#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a host with one CUDA card::

    python3 chip_smoke.py

What it does, in order (any failure raises and the script exits non-zero
without printing a result):

1. prints the card (``nvidia-smi`` name and power limit), the CUDA and
   ``nvcc`` versions, and builds the CUDA kernels from
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
   on the CPU at 128 links; then ``fsm_scan`` at the edges of its staged
   tiles (N in 1, 17, 128 x T in 1, 63, 2001, 8760, windows from 1 hour to
   past T, both policies and renewals, planes 8 bytes off a 16-byte
   boundary) bit for bit against the CPU plain version and in decisions
   against the card's; then :func:`tier_nan_checks`: the three tiered
   kernels on hours whose month-to-date volume or demand is NaN, at the
   main paths' shapes, against their plain versions NaN-aware (the fold
   kernels price such an hour +0.0, the static ``tiered_cost`` gives NaN);
5. holds the CUDA ``plan_fleet`` against the CPU one at 16 x 2000;
6. times each kernel, its plain version and ``plan_fleet`` end to end
   (median of CUDA-synchronised runs after warm-up) beside each kernel's
   bound: the larger of its bytes over 3.35 TB/s and its operations over
   the card's peak for their type, and ``fsm_scan`` beside its time before
   its redesign (run M in ``PERF.md``);
7. the streaming path: with every launch count at 0, ``FleetRuntime`` on
   the default device streams the 2048 x 8760 scenario in K = 24 chunks
   and 800 hours per tick (past the month start at hour 730), and the
   128 x 8760 scenario in chunks for both ``renew_in_chunks``; it fails
   unless ``stream_chunk`` launched once per chunk and tick (1895) and
   ``tiered_cost_scan`` and ``fsm_chunk`` not at all, unless the 2048-link
   stream equals the CPU ``plan_fleet`` bit for bit in
   ``x``/``state``/``vpn_cost``/``cci_cost``, the per-tick hours equal the
   chunked ones in every field, the 128-link streams equal the numpy
   reference and the card's runtime equals the CPU's at 16 x 2000; then
   it holds the month-to-date ``tiered_cost_scan`` (year as one chunk, and
   :func:`scan_edge_checks`: no reset, resets at hour 0, on consecutive
   hours and at K - 1, segments shorter than a staged tile, N of 1, 31 and
   33, K = 1, NaN demand; f64 every bit, f32 ``rtol=atol=1e-6``) and four
   chained K = 24 chunks of the calendar entry and ``fsm_chunk`` (every
   bit) against their plain versions, and ``stream_chunk`` against
   ``stream_chunk_ref`` in every output bit (NaN in the same places) on
   sixteen cases: at 2048 links four chained K = 24 chunks from hour 696
   (across the month start at 730), the same with endogenous CCI demand,
   K = 1, one K past the kernel's tile and the window ring, 2043 rows,
   demand hours holding NaN and +inf, three chained chunks from hour 726 at
   K = 2, 3, the tick form's last K and one past it, 8, 9, 23 and 25,
   windows of 1-12 hours and no provisioning delay in some links (K = 24,
   1, 30); and the 128-link fleet at K = 24; it times the tick
   (p50/p95/p99), the chunk, and (:func:`kernel_times`, profiler device
   time) ``stream_chunk`` at 2048 x K = 24, 2048 x K = 1 and 128 x K = 24
   and over the K sweep in each launch form (the tick form up to its last
   K), each form first held to ``stream_chunk_ref`` in every bit, the
   month-to-date ``tiered_cost_scan`` at 2048 x 8760 and 2048 x 24 (f64,
   f32), each beside its bound and its time before the redesign, and
   an empty kernel at their grids (the launch floor); then
   ``stream_chunk`` at K = 24 and K = 1 (CUDA events too) beside the two
   kernels it replaced on the same inputs and the whole sequence they ran
   in, its plain version, and the host and device parts of one step;
8. the LM serving path (:func:`lm_phase`): holds the flash-attention and
   RMSNorm kernels against their plain versions: the Hopper entry
   (``flash_attention_sm90``) in bfloat16 at ``2e-2`` on TinyLlama's prefill
   shape, the TPU kernel's seven contract cases and H2O-Danube3's
   full-width shape (1, 32, 8, 1024, 1024, 120, 120), causal, with windows
   256 and 4096, failing unless that entry launched for each; the general
   entry in float32 at ``2e-5`` on the contract cases; RMSNorm at 4096 and 4
   rows x 2048, ``2e-2``/``1e-5``. It runs a 2-layer full-width TinyLlama in
   float32 on the card and on the CPU (prefill and teacher-forced decode
   logits within ``SLICE_TOL``, greedy tokens equal), then, with every
   launch count at 0, serves 3 request batches of full-width, full-depth
   ``tinyllama-1.1b`` in bfloat16 (B = 4, 1024 prompt tokens, 64 new)
   through ``greedy_generate`` and fails unless each batch launched
   ``flash_attention_sm90`` 22 times and ``rmsnorm`` 45 times per forward;
   checks the decode chain against ``forward`` over the same tokens
   (``SERVE_TOL``) and times prefill and decode (with the prefill's device
   breakdown), then, in one table at the prefill shape, the Hopper kernel,
   the general kernel on the same inputs, SDPA and the plain version
   (device time per call from CUDA events) beside the bound, the Hopper kernel and SDPA at
   H2O-Danube3's shape, and RMSNorm with x cold and warm in L2 beside
   ``F.rms_norm``;
9. the actuation path (:func:`actuation_phase`): holds ``int8_quantize``
   (both scale guards) / ``int8_dequantize`` (float32 and bfloat16, every
   TinyLlama leaf shape, a zero row and a row with |max| 1e-29, quantize
   also against the CPU plain version; rows holding NaN, +inf and -inf,
   which must give JAX's scale NaN or inf and q = 0; views one element off
   a 16-byte boundary and d = 2047, which take the kernel's scalar branch)
   and the static ``tiered_cost`` (8760 x
   2048, two tier tables with an infinite last bound) against their plain
   versions with ``torch.equal``; then, with every launch count at 0, syncs
   a float32 gradient pytree with the shapes of full-width, full-depth
   ``tinyllama-1.1b`` (1.100 B values) through ``sync_grads`` on a one-rank
   NCCL ``(pod, data, model)`` mesh in every mode and three compressed steps
   with carried residuals, each output and residual ``torch.equal`` to the
   plain path, and fails unless the quantize kernel launched once and the
   dequantize kernel twice per leaf and step; drives ``InterconnectPlanner``
   over 8760 hours of that pytree's wire bytes in switching regimes, running
   the sync in the returned mode for 24 hours around each toggle, and prices
   the year's VPN bill for 2048 sync sizes through ``ops.tiered_cost``
   (held to the planner's comparator); runs ``ElasticFleetPlanner`` at 2048
   links x 800 hours on the card and on the CPU (every mode and report
   array equal) and ``fleet_sync_grads`` on 16 jobs of one full-width layer
   over a mode change (grouped == ungrouped, billed == ``sync_wire_bytes``);
   then checks ``int8_dequantize`` against ``torch.mul(q, scale)`` bit for
   bit on every leaf (float32, and cast to bfloat16), and times the sync in
   each mode, the kernels against their plain versions and bounds by
   profiler device time (``int8_quantize`` beside its run-M time,
   ``int8_dequantize`` beside ``torch.mul`` and its run-Q time, the static
   ``tiered_cost`` beside its run-Q time and CUDA events), and ``feed_hour``;
10. the topology path (:func:`topology_phase`): with every launch count
    at 0, ``plan_topology`` of ``build_topology_scenario(2048,
    n_facilities=32, ports_per_facility=4, reach=2)`` over 8760 hours (128
    ports) with ``routing=None`` (``optimize_routing`` on the host); it
    fails unless ``tiered_cost_batched``, ``leg_segment_sum`` and
    ``fsm_scan`` launched, unless ``x``/``state`` equal
    ``plan_topology_reference`` (toggle cost ``rtol=1e-9``) and the CPU
    plan (costs ``rtol=1e-9``); the routing padded by 64 legs must give
    every output bit of the unpadded plan, and the identity topology of the
    2048-link fleet every bit of ``plan_fleet``; ``leg_segment_sum`` is held
    against its plain version bit for bit at P = 2048, T = 8760, M = 128, E
    = 6144 (1-, 2- and 3-hop rows, padding legs, NaN and inf in row 0, -0.0
    sources) and at the main path's inputs; at 1200 hours
    ``refine_routing`` from the 1-hop routing must apply a relay move, and
    ``replay_plan_topology`` of one segment must equal ``plan_topology``
    bit for bit and of two (direct, then the relay from hour 600) the CPU;
    then it times the kernel (profiler device time) beside its bound, its
    plain version and ``index_add_`` on both planes, ``plan_topology`` from
    arrays and from the spec, and a device breakdown of one plan;
11. the streaming runtime's topology mode (:func:`topology_stream_phase`):
    with every launch count at 0, ``FleetRuntime(topo, routing=...)`` on
    the default device streams the same 2048-pair, 128-port year in K = 24
    chunks and 800 hours per tick; it fails unless ``stream_chunk_routed``
    launched once per chunk and tick (1165) and ``stream_chunk``,
    ``leg_segment_sum``, ``tiered_cost_scan`` and ``fsm_chunk`` never, unless
    the stream equals the CPU ``plan_topology`` of the same routing bit for
    bit in ``x``/``state``/``vpn_cost``/``cci_cost`` and the per-tick hours
    the chunked ones in every field; it holds ``stream_chunk_routed``
    against ``stream_chunk_routed_ref`` in every output bit on the relay
    (padded) and multicast scenarios, NaN demand in pair 0 under padding
    legs, K = 1 across the month start, chained K = 24 across it, one K past
    the window ring, endogenous CCI demand, ports of 76 and 165 legs (one
    and two of the port stage's 128-leg tiles) at K = 24, 1 and 33, and the
    cell's routing, with its empty ports and 95-leg port, over 200 hours at
    K = 24 and 5; it streams
    ``build_reroute_scenario(2000, 800, seed 0)`` frozen and with live
    re-packing every 24 hours (``reroute()`` at chunk boundaries), fails
    unless the live run costs less and its decisions equal
    ``replay_plan_topology`` on the card and on the CPU, and prints the
    saving; then it times the tick, the chunk, the host split of a step and
    the kernel (profiler device time) beside its bound and plain version,
    with a device breakdown of one chunk;
12. the paper's evaluation (:func:`report_phase`): with every launch count
    at 0, ``build_report`` of the 2048 x 8760 fleet plan with the OPT column
    on the card; it fails unless ``oracle_dp`` launched exactly once (one
    ``fleet_oracle`` call) and nothing else did, unless every link's OPT is
    at most its ToggleCCI and its best static cost (x (1 + 1e-9)), and
    prints the portfolio totals; ``oracle_dp`` at the report's inputs must
    equal its OPT column, its plain version on the card every bit, the plain
    version on the CPU on 64 links and the numpy ``offline_optimal`` on 4;
    ``build_topology_report`` of the relay and multicast scenarios at 1200
    hours (each plan and its report driven with launches counted) must give
    ``relay_savings`` 0.3785 and ``tree_sharing_savings`` 0.1101, equal to
    the CPU report within ``rtol=1e-12``; with every count at 0,
    ``build_topology_report`` of the 2048-pair year with the oracle must
    launch ``oracle_dp`` once, keep OPT at most ToggleCCI on every port and
    equal the plain version on the CPU on the port series; ``oracle_dp``'s
    register form must build with no spill and no stack frame (``-Xptxas
    -v``, printed), and both of its forms, forced, must equal the plain
    version on the card at the fleet year and on 256 links half of which
    are past the register form (there ``"auto"`` launches both forms and
    forcing the register form raises); then it times both forms in turns
    (profiler device time) at 2048 links and 128 ports beside the bound
    (the DP's adds and compares over half the FMA-counted float64 peak,
    printed beside the old one) and run 22A's time of PR 22's kernel,
    ``fleet_oracle``'s host split (the cost series, the copy in, the launch,
    the copy out), each report's wall time and one link of the numpy DP;
13. prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` as
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
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth, the
# non-tensor-core float64 and float32 rates, and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12, torch.bfloat16: 989e12}
# The kernels before their redesign, NVIDIA H100 80GB HBM3, 700.00 W (PERF.md):
# run M, fsm_scan at 2048 x 8760 and int8_quantize over the 201 leaves; run Q,
# int8_dequantize over the 201 leaves (profiler device time) and the static
# tiered_cost at 8760 x 2048 (CUDA events around one call, launch included).
RUN_M_MS = {"fsm_scan": 3.3928, "int8_quantize": 3.6788}
RUN_Q_MS = {"int8_dequantize": 3.2221, "tiered_cost": 0.1247}
# oracle_dp before its redesign (PR 22's one-block-a-row kernel, now the
# large-row form), run 22A, profiler device time, same card and limit.
RUN_22A_MS = {"fleet": 13.4088, "ports": 2.0575}   # 2048 links, 128 ports, x 8760 h
# The offline DP's work is float64 adds and compares, nothing to fuse: each
# takes a whole float64 lane-cycle, and the card does those at half the
# PEAK_FLOPS[torch.float64] above, which counts a fused multiply-add as two.
F64_LANE_OPS_PER_S = PEAK_FLOPS[torch.float64] / 2


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


def queued_ms(fn, reps: int, before=None) -> float:
    """Median device milliseconds of one ``fn()``, from CUDA events around
    that call alone. Every call is queued behind a sleep kernel first, so the
    host's launch cost stays out of the events; ``before()`` (an L2 flush,
    say) runs ahead of each call, outside them."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(reps * 1_000_000)   # ~0.5 ms of card time per call to queue
    for a, b in events:
        if before is not None:
            before()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def bound(bytes_moved: float, ops: float, dtype) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[dtype]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lane_bound(bytes_moved: float, ops: float, dtype) -> dict:
    """bound() for operations that each take a whole lane-cycle (adds,
    compares, selects, unfused multiplies): they run at half the FMA-counted
    peak, as F64_LANE_OPS_PER_S does for float64."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / (PEAK_FLOPS[dtype] / 2)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tiered_bound(N: int, T: int, K: int, dtype) -> dict:
    size = torch.empty((), dtype=dtype).element_size()
    # month_cum and demand read, cost written; tier tables read once.
    bytes_moved = N * T * 3 * size + 2 * N * K * size
    # hi = lo + d; per tier: min, max, sub, compare, mul, add.
    ops = N * T * (1 + 6 * K)
    return lane_bound(bytes_moved, ops, dtype)


def fsm_bound(N: int, T: int) -> dict:
    # vpn, cci read (f64); x, state written (int32); per-row parameters and total.
    bytes_moved = N * T * (8 + 8 + 4 + 4) + N * (8 * 2 + 4 * 5 + 8)
    # per hour: 2 prefix adds, 2 lagged adds, 2 subs, 2 muls, 2 compares, 1 add.
    ops = N * T * 11
    return bound(bytes_moved, ops, torch.float64)


TRACE_PADS, TRACE_QUIET_S = 64, 0.01   # pad kernels that open a trace, then 10 ms idle
PAD_SEEN = []                          # per trace: how many pads it recorded


def traced(fn, reps: int):
    """Host and device events of ``reps`` calls of ``fn`` from torch.profiler
    (after one call untraced), and the device events alone. Minutes into a
    run on the H100 host, a trace can lose the device events of its first
    ~0.5 ms of device activity (7 of 20 launches of a 0.07-ms kernel; all of
    16 one-cycle spin kernels), and the later the trace the more it loses
    (0 to 17 first events over 32-40 traces in one run). So the trace opens
    with TRACE_PADS such spin kernels and TRACE_QUIET_S of idle card, and
    keeps only the events of the annotated calls after them. The callers that know how many launches a
    call makes check the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_PADS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(TRACE_QUIET_S)
        with record_function("traced calls"):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    PAD_SEEN.append(sum(e.device_type == DeviceType.CUDA and "spin_kernel" in e.name
                        for e in events))
    mark = [e.time_range.start for e in events if e.name == "traced calls"]
    t0 = mark[0] if mark else float("-inf")
    events = [e for e in events if "spin_kernel" not in e.name and e.time_range.start >= t0]
    return events, [e for e in events if e.device_type == DeviceType.CUDA
                    and e.name != "traced calls"]     # kineto mirrors the annotation there


def print_breakdown(fn, reps: int, unit: str = "plan") -> None:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    and the share of the traced window the device was busy."""
    events, dev = traced(fn, reps)
    if not dev:
        print("    profiler: no device activity recorded (device time not measured)")
        return
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    print(f"    profiler: device busy {busy / reps / 1e3:.3f} ms per {unit}, "
          f"{busy / window:.3f} of the traced window (idle share "
          f"{1 - busy / window:.3f}, host-side profiler overhead included)")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / reps / 1e3:9.4f} ms  {us / busy:6.1%}  {name[:90]}")


STREAM_K = 24          # hours per step_many chunk: one day
STREAM_TICKS = 800     # per-tick step() hours: past the first month start (730)


def stream(rt, demand, K: int, clock: list = None) -> dict:
    """Stream a (rows, T) matrix through ``rt``: chunks of K, then a per-tick
    ragged tail; outputs stacked to (rows, T). ``clock`` collects the host
    seconds of each call (the stacking of the outputs is not in them)."""
    T = demand.shape[1]
    outs, t = [], 0
    while t < T:
        a = time.perf_counter()
        if t + K <= T:
            outs.append(rt.step_many(demand[:, t:t + K]))
            t += K
        else:
            outs.append({k: v[:, None] for k, v in rt.step(demand[:, t]).items()})
            t += 1
        if clock is not None:
            clock.append(time.perf_counter() - a)
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}


def kernel_device_ms(fn, reps: int, names, per_call: int = 0) -> dict:
    """Device milliseconds per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``reps`` calls of ``fn`` (for kernels
    whose launch costs the host more than the card spends running them, CUDA
    events around a call measure the launch, not the kernel). With
    ``per_call``, each name must show exactly ``reps * per_call`` launches in
    the trace, or the script fails: a trace that lost launches reads low."""
    out, count = {}, {}
    for e in traced(fn, reps)[1]:
        for n in names:
            if n in e.name:
                out[n] = out.get(n, 0.0) + e.time_range.elapsed_us() / reps / 1e3
                count[n] = count.get(n, 0) + 1
    missing = [n for n in names if n not in out]
    check(not missing, f"profiler recorded no device time for {missing}")
    short = {n: c for n, c in count.items() if per_call and c != reps * per_call}
    check(not short, f"profiler trace holds {short} launches, not {reps * per_call} each")
    return out


def device_busy_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: every kernel and copy it ran
    on the card, summed, from torch.profiler over ``reps`` calls (for a call
    of many small launches, CUDA events around it time the host's launch
    rate, not the card)."""
    busy = sum(e.time_range.elapsed_us() for e in traced(fn, reps)[1])
    check(busy > 0, "profiler recorded no device time")
    return busy / reps / 1e3


def calendar_bound(N: int, K: int, Kt: int) -> dict:
    # demand read and cost written (K, N); tier tables read; carry in and out.
    bytes_moved = 8 * (2 * K * N + 2 * N * Kt + 4 * N)
    # per hour: month sub, carry add, hi add; per tier: min, max, sub, compare, mul, add.
    ops = K * N * (3 + 6 * Kt)
    return lane_bound(bytes_moved, ops, torch.float64)


def scan_bound(N: int, K: int, Kt: int, dtype) -> dict:
    """The month-to-date ``tiered_cost_scan``: demand read and cost written
    (N, K), tier tables (2 x (N, Kt)), cum0 in and cum_out out, reset (K,)
    int32; per hour the carry add and hi add, per tier min, max, sub,
    compare, mul, add."""
    size = torch.empty((), dtype=dtype).element_size()
    return lane_bound(size * (2 * N * K + 2 * N * Kt + 2 * N) + 4 * K, N * K * (2 + 6 * Kt),
                      dtype)


def fsm_chunk_bound(N: int, K: int) -> dict:
    # vpn, cci, pre_v, pre_c read; r_vpn, r_cci, snap_v, snap_c written (f64);
    # x, state written (int32); per-row parameters, carry and prefixes in and out.
    bytes_moved = 8 * 8 * K * N + 4 * 2 * K * N + N * (8 * 2 + 4 * 5) + 2 * N * (4 * 4 + 8 * 2)
    # per hour: 2 prefix adds, 2 window subs, 2 muls, 2 compares.
    ops = K * N * 8
    return lane_bound(bytes_moved, ops, torch.float64)


def pre_reads(pref: np.ndarray, t0: int, K: int, h: np.ndarray) -> np.ndarray:
    """The runtime's host ring reads: the exclusive prefix at max(0, t0+k-h),
    from an (hours + 1, N) prefix table."""
    lo = np.maximum(0, t0 + np.arange(K)[:, None] - h[None, :])
    return np.ascontiguousarray(np.take_along_axis(pref, lo, axis=0))


def stream_chunk_bound(N: int, K: int, Kt: int, endo: bool) -> dict:
    # The block read (demand, the CCI demand when endo, pre_v, pre_c: (K, N) each),
    # the packed (8K + 4, N) result written; per-row operands (6 f64, 5 int32),
    # tier tables (2 x (N, Kt)), the carries in (dcum, dcum_month, prefixes; the
    # int32 FSM carry) and the FSM carry out.
    bytes_moved = (8 * ((3 if endo else 2) + 8) * K * N + 8 * 4 * N
                   + N * (8 * 6 + 4 * 5) + 8 * 2 * N * Kt + 8 * 4 * N + 2 * 4 * 4 * N)
    # per hour: 2 clips, month sub, carry add, hi add, per tier 6, the vpn add,
    # the cci mul and add, 2 prefix adds, 2 window subs, 2 muls, 2 compares.
    ops = K * N * (2 + 3 + 6 * Kt + 3 + 8)
    return lane_bound(bytes_moved, ops, torch.float64)


def head_rows(arrays, n: int):
    """The first n links of stacked FleetArrays (nested ToggleParams too)."""
    cut = lambda f: (type(f)(*(x[:n].contiguous() for x in f)) if isinstance(f, tuple)
                     else f[:n].contiguous())
    return type(arrays)(*(cut(f) for f in arrays))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and types, NaN in the same places, every bit equal elsewhere
    (signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = {torch.float64: torch.int64, torch.float32: torch.int32}.get(a.dtype)
    if as_int is None:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb) and torch.equal(a.view(as_int).masked_fill(na, 0),
                                                b.view(as_int).masked_fill(nb, 0)))


def chunk_case(spec, demand, t_first: int, Ks, cci_demand=None, routing=None) -> float:
    """Stream ``spec`` (and ``routing``, in topology mode) on the card to hour
    ``t_first``, then run each chunk of ``Ks`` hours through the runtime's own
    ``_launch`` (the kernel: ``stream_chunk``, or ``stream_chunk_routed`` in
    topology mode) and through its plain version on the same block and
    carries; fail unless the packed result and the FSM carry agree in every
    bit. Returns the largest absolute difference over non-NaN values (0.0
    when they agree)."""
    from repro_torch.fleet import FleetRuntime
    from repro_torch.kernels import ops, ref

    rt = FleetRuntime(spec, routing=routing)
    name = "stream_chunk_routed" if rt.topology else "stream_chunk"
    plain = ref.stream_chunk_routed_ref if rt.topology else ref.stream_chunk_ref
    cblk = lambda a, b: None if cci_demand is None else cci_demand[:, a:b]
    t = 0
    while t < t_first:
        k = min(STREAM_K, t_first - t)
        rt.step_many(demand[:, t:t + k], cci_demand_block=cblk(t, t + k))
        t += k
    err = 0.0
    for K in Ks:
        block, K_, endo = rt._pack(demand[:, t:t + K], cblk(t, t + K))
        dev_block = torch.from_numpy(block).to(DEVICE)
        want, want_fsm = plain(*rt._chunk_args(dev_block, K_, endo),
                               renew_in_chunks=rt.policy.renew_in_chunks)
        before = ops.LAUNCHES[name]
        host = rt._launch(dev_block, K_, endo)
        check(ops.LAUNCHES[name] == before + 1, f"{name} did not launch")
        check(same_bits(host, want) and same_bits(rt._state.fsm, want_fsm),
              f"{name} != plain at {rt.n_demand_rows} demand rows on {rt.n_rows} decision "
              f"rows, hours {t}..{t + K - 1}, endo={endo}: first differing elements "
              f"{torch.nonzero((host != want) & ~(host.isnan() & want.isnan()))[:4].tolist()}")
        ok = ~torch.isnan(want)
        err = max(err, (host[ok] - want[ok]).abs().max().item())
        rt._commit(host.cpu().numpy(), K_)
        t += K
    return err


def print_step_split(rt, demand, t0: int, rows: str) -> None:
    """Host clock of one step of ``rt`` at K = 1 and K = STREAM_K from hour
    ``t0``, split into the pack, the copy in, the launch and the wait, the
    copy out and the commit (median over 24 steps; the runtime advances)."""
    for K in (1, STREAM_K):
        parts = {k: [] for k in ("pack", "h2d", "device", "d2h", "commit")}
        blk = demand[:, t0:t0 + K]   # the data does not set the time
        for _ in range(24):
            a = time.perf_counter()
            block, K_, endo = rt._pack(blk, None)
            b = time.perf_counter()
            dev_block = torch.from_numpy(block).to(DEVICE)
            torch.cuda.synchronize()
            c_ = time.perf_counter()
            host = rt._launch(dev_block, K_, endo)
            torch.cuda.synchronize()
            d_ = time.perf_counter()
            host_np = host.cpu().numpy()
            e = time.perf_counter()
            rt._commit(host_np, K_)
            f = time.perf_counter()
            for k, v in zip(parts, (b - a, c_ - b, d_ - c_, e - d_, f - e)):
                parts[k].append(v * 1e6)
        print(f"  one step ({rows} x K={K}), median us over 24 steps, host clock: "
              + ", ".join(f"{k} {statistics.median(v):.1f}" for k, v in parts.items())
              + f" (block {block.nbytes / 1e6:.3f} MB in, {host.numel() * 8 / 1e6:.3f} MB out; "
              f"'device' is the launch and the wait for the card)")


# An empty kernel, built beside the port's library: its device time at a
# kernel's grid is the card's launch-and-drain floor for that grid.
FLOOR_SRC = r"""
#include <cuda_runtime.h>
extern "C" __global__ void empty_kernel() {}
extern "C" int empty_grid(int blocks, int threads, int smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
SWEEP_K = (1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 168)   # stream_chunk's K sweep at 2048 rows
SWEEP_T0 = 696                             # the sweep's first hour (K = 168 crosses hour 730)
# The two kernels before their redesign, as kernel_times timed the parent
# commit's kernels (PERF.md, run 24A), profiler device ms, NVIDIA H100 80GB
# HBM3, 700.00 W.
BEFORE_REDESIGN_MS = {
    "stream_chunk 2048x1": 0.0035, "stream_chunk 2048x2": 0.0035,
    "stream_chunk 2048x4": 0.0037, "stream_chunk 2048x8": 0.0037,
    "stream_chunk 2048x16": 0.0043, "stream_chunk 2048x24": 0.0050,
    "stream_chunk 2048x32": 0.0055, "stream_chunk 2048x168": 0.0239,
    "stream_chunk 128x24": 0.0046,
    "tiered_cost_scan 2048x8760 float64": 7.0195, "tiered_cost_scan 2048x24 float64": 0.0186,
    "tiered_cost_scan 2048x8760 float32": 2.5896, "tiered_cost_scan 2048x24 float32": 0.0071,
}


def launch_floor():
    """``empty_grid(blocks, threads, smem, stream)``, compiled from FLOOR_SRC."""
    import ctypes
    from repro_torch.kernels import _lib

    out = ROOT / "build" / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(FLOOR_SRC)
    so = out / "libempty.so"
    res = subprocess.run([_lib._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                          "-Xcompiler", "-fPIC", "-shared", str(out / "empty.cu"), "-o",
                          str(so)], capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"empty kernel build failed: {res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.empty_grid.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.empty_grid.restype = ctypes.c_int
    return lib


def device_ms_per_call(fn, reps: int, name: str, per_call: int, tries: int = 3) -> float:
    """Device milliseconds per call of every kernel whose name holds ``name``
    (torch.profiler over ``reps`` calls), where a call launches ``per_call``
    such kernels. A trace that lost launches (not ``reps * per_call``) reads
    low: it is taken again, up to ``tries`` traces, and the script fails
    unless one of them holds every launch."""
    for _ in range(tries):
        dev = [e for e in traced(fn, reps)[1] if name in e.name]
        if len(dev) == reps * per_call:
            return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
        print(f"    profiler trace holds {len(dev)} launches of {name} over {reps} calls, "
              f"not {reps * per_call}: taken again")
    raise SmokeFailure(f"no profiler trace of {tries} held every launch of {name}")


def floor_ms(lib, blocks: int, threads: int, smem: int = 0, reps: int = 50) -> float:
    stream = torch.cuda.current_stream().cuda_stream
    return device_ms_per_call(
        lambda: check(lib.empty_grid(blocks, threads, smem, stream) == 0, "empty kernel"),
        reps, "empty_kernel", 1)


def kernel_times(scen) -> dict:
    """Profiler device time of one ``stream_chunk`` call at the streaming
    path's three shapes (2048 x K = 24, 2048 x K = 1, 128 x K = 24) and over
    SWEEP_K at 2048 rows, in each launch form (``"auto"`` is the wrapper's
    own choice; ``"tick"`` only where it has an instance), on
    a runtime's blocks from hour SWEEP_T0, each form first held to
    ``stream_chunk_ref`` in every bit; the month-to-date
    ``tiered_cost_scan`` at 2048 x 8760 (f64, f32; resets at month starts)
    and 2048 x 24 (hours 720..743, the month start at 730); and the empty
    kernel's floor at the old and new grids. Prints each beside its bound
    and its time before the redesign; returns {label: ms}, labels "stream_chunk
    {rows}x{K} {form}", "tiered_cost_scan {rows}x{K} {dtype}", "floor ..."."""
    from repro_torch.fleet import FleetRuntime
    from repro_torch.kernels import ref
    from repro_torch.kernels.stream_chunk import TICK_MAX_K, _stream_chunk_launch
    from repro_torch.kernels.tiered_cost_scan import segment_slots, tiered_cost_scan

    was = lambda key: (f", before the redesign {BEFORE_REDESIGN_MS[key]} ms"
                       if key in BEFORE_REDESIGN_MS else "")

    out = {}
    lib = launch_floor()
    rts = {}
    for n in (SIZES[-1][0], SIZES[0][0]):
        sc = scen[n]
        rt = FleetRuntime(sc.fleet)
        stream(rt, sc.demand[:, :SWEEP_T0], STREAM_K)
        rts[n] = (rt, sc)
    shapes = [(SIZES[-1][0], K) for K in SWEEP_K] + [(SIZES[0][0], STREAM_K)]
    for n, K in shapes:
        rt, sc = rts[n]
        block, _, _ = rt._pack(sc.demand[:, SWEEP_T0:SWEEP_T0 + K], None)
        args = rt._chunk_args(torch.from_numpy(block).to(DEVICE), K, False)
        Kt = args[7].shape[1]
        b = stream_chunk_bound(n, K, Kt, False)
        renew = rt.policy.renew_in_chunks
        want = ref.stream_chunk_ref(*args, renew_in_chunks=renew)
        for form in ("auto", "tick", "chunk"):
            if form == "tick" and K > TICK_MAX_K:
                continue
            call = lambda: _stream_chunk_launch(form, *args, renew_in_chunks=renew)
            got = call()
            check(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
                  f"stream_chunk {n} x K={K}, {form} form != stream_chunk_ref")
            ms = device_ms_per_call(call, 20, "stream_chunk", 1)
            out[f"stream_chunk {n}x{K} {form}"] = ms
            print(f"  stream_chunk {n} x K={K} form {form}: == plain (every bit); {ms:.5f} ms "
                  f"device, bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), "
                  f"{ms / b['bound_ms']:.2f}x bound" + was(f"stream_chunk {n}x{K}"))
    n = SIZES[-1][0]
    for label, grid in (("previous chunk grid", (-(-n // 16), 512, 0)),
                        ("tick grid, 32 threads", (-(-n // 32), 32, 0)),
                        ("chunk grid, 480 threads", (-(-n // 16), 480, 0)),
                        ("128 rows, previous chunk grid", (8, 512, 0)),
                        ("128 rows, chunk grid, 480 threads", (8, 480, 0))):
        out[f"floor {label}"] = floor_ms(lib, *grid)
        print(f"  empty kernel, {label} {grid[0]} x {grid[1]}: "
              f"{out[f'floor {label}']:.5f} ms device")
    sc = scen[n]
    T = sc.demand.shape[1]
    arrays = sc.fleet.stack(torch.float64, DEVICE)
    tab = (arrays.tier_bounds, arrays.tier_rates)
    Kt = tab[0].shape[1]
    d = torch.minimum(torch.as_tensor(sc.demand, device=DEVICE), arrays.capacity[:, None])
    hours = torch.arange(T, device=DEVICE)
    reset = (hours % sc.fleet.hours_per_month == 0).to(torch.int32)
    zero = torch.zeros(n, dtype=torch.float64, device=DEVICE)
    for dt in (torch.float64, torch.float32):
        args = [a.to(dt).contiguous() for a in (zero, d, *tab)] + [reset]
        day = [args[0], args[1][:, 720:744].contiguous(), *args[2:4],
               reset[720:744].contiguous()]
        for label, a, K in (("year", args, T), ("day", day, 24)):
            per = 2 if segment_slots(n, K) > 1 else 1        # the plan's pre-pass
            ms = device_ms_per_call(lambda: tiered_cost_scan(*a), 20, "tiered_cost_scan", per)
            b = scan_bound(n, K, Kt, dt)
            key = f"tiered_cost_scan {n}x{K} {str(dt)[6:]}"
            out[key] = ms
            print(f"  {key} (month-to-date): {ms:.5f} ms device ({per} kernel(s) a call), "
                  f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}), {ms / b['bound_ms']:.2f}x"
                  + was(key))
    return out


def scan_edge_checks(d, tab, hpm: int) -> float:
    """The month-to-date ``tiered_cost_scan`` against its plain version on
    the segment plan's and the staged tiles' edges, from the 2048-link
    year's clipped demand ``d`` and tables: no reset, resets at hour 0, on
    consecutive hours and at K - 1, segments shorter than a 64-hour tile, N
    of 1, 31 and 33, K = 1, and NaN and +inf demand. float64 every bit (NaN
    in the same places), float32 at rtol = atol = 1e-6. Returns the largest
    float32 difference."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_cost_scan import tiered_cost_scan

    def reset_of(K, marks):
        r = torch.zeros(K, dtype=torch.int32, device=DEVICE)
        r[[m for m in marks if m < K]] = 1
        return r.contiguous()

    nan_d = d[:33, :1000].clone()
    nan_d[0, 5], nan_d[3, 71], nan_d[2, 990], nan_d[4, 150] = (float("nan"),) * 3 + (
        float("inf"),)
    cases = {
        "no reset, 2048 x 2000": (d[:, :2000], torch.zeros(2000, dtype=torch.int32,
                                                            device=DEVICE)),
        "resets at 0, 1, 2, 63-65 and K - 1, 33 x 1500": (
            d[:33, :1500], reset_of(1500, [0, 1, 2, 63, 64, 65, 1499])),
        "segments of 29 hours, 31 x 900": (
            d[:31, :900], (torch.arange(900, device=DEVICE) % 29 == 3).to(torch.int32)),
        "month starts, 1 x 8760": (d[:1], (torch.arange(d.shape[1], device=DEVICE) % hpm
                                           == 0).to(torch.int32)),
        "resets at 0, 1, 2, 63-65 and K - 1, 33 x 300 (one slot: resets in the carry)": (
            d[:33, :300], reset_of(300, [0, 1, 2, 63, 64, 65, 299])),
        "K = 1, 2048 x 1, reset": (d[:, :1], torch.ones(1, dtype=torch.int32, device=DEVICE)),
        "K = 1, 31 x 1, no reset": (d[:31, :1], torch.zeros(1, dtype=torch.int32,
                                                             device=DEVICE)),
        "NaN and +inf demand, 33 x 1000, segments of 70 hours": (
            nan_d, (torch.arange(1000, device=DEVICE) % 70 == 0).to(torch.int32)),
    }
    err32 = 0.0
    for label, (dd, reset) in cases.items():
        n = dd.shape[0]
        cum0 = torch.linspace(0.0, 5e4, n, dtype=torch.float64, device=DEVICE)
        for dt in (torch.float64, torch.float32):
            args = [a.to(dt).contiguous() for a in (cum0, dd, tab[0][:n], tab[1][:n])]
            got = tiered_cost_scan(*args, reset)
            want = ref.tiered_cost_scan_ref(*args, reset)
            for g, w in zip(got, want):
                if dt == torch.float64:
                    check(same_bits(g, w), f"tiered_cost_scan f64 != plain: {label}")
                else:
                    torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6, equal_nan=True)
                    ok = ~torch.isnan(w)
                    err32 = max(err32, (g[ok] - w[ok]).abs().max().item() if ok.any() else 0.0)
        print(f"  tiered_cost_scan == plain (f64 every bit, f32 1e-6): {label}")
    return err32


def streaming_phase(scen, references, card: str) -> dict:
    """The streaming runtime on the card: the main path with launches
    counted, its checks against the offline planners, each new kernel
    against its plain version, and timings. Returns the kernel rows."""
    from repro_torch.fleet import FleetRuntime, plan_fleet
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fsm_scan import fsm_chunk
    from repro_torch.kernels.stream_chunk import TICK_MAX_K, launch_form, stream_chunk
    from repro_torch.kernels.tiered_cost_scan import tiered_cost_calendar, tiered_cost_scan

    N, T = SIZES[-1]
    N128, T128 = SIZES[0]
    sc = scen[N]
    fields = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
    t_phase = time.perf_counter()

    # -- the main path: FleetRuntime on the default device, launches counted
    ops.reset_launches()
    rt = FleetRuntime(sc.fleet)
    check(rt.device.type == DEVICE.type, "FleetRuntime did not default to the card")
    chunk_clock = []
    chunked = stream(rt, sc.demand, STREAM_K, chunk_clock)
    chunk_s = sum(chunk_clock)
    rt_tick = FleetRuntime(sc.fleet)
    tick_us, ticks = [], []
    t0 = time.perf_counter()
    for t in range(STREAM_TICKS):
        a = time.perf_counter()
        ticks.append(rt_tick.step(sc.demand[:, t]))
        tick_us.append((time.perf_counter() - a) * 1e6)
    tick_s = time.perf_counter() - t0
    small = {}
    for renew in (False, True):
        small[renew] = stream(FleetRuntime(scen[N128].fleet, renew_in_chunks=renew),
                              scen[N128].demand, STREAM_K)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"streaming path launches: {launches}")
    chunks = lambda T_, K_: T_ // K_ + T_ % K_        # stream(): chunks, then a per-tick tail
    want_launches = chunks(T, STREAM_K) + STREAM_TICKS + 2 * chunks(T128, STREAM_K)
    check(launches["stream_chunk"] == want_launches,
          f"stream_chunk launched {launches['stream_chunk']} times on the streaming path, "
          f"not once per chunk and tick ({want_launches})")
    for name in ("tiered_cost_scan", "fsm_chunk"):
        check(launches[name] == 0, f"kernel {name} launched on the streaming path")

    # -- checks ----------------------------------------------------------------
    t0 = time.perf_counter()
    cpu = plan_fleet(sc.fleet, sc.demand, device="cpu")
    for k, want in (("x", cpu["x"]), ("state", cpu["state"]),
                    ("vpn_cost", cpu["vpn_hourly"]), ("cci_cost", cpu["cci_hourly"])):
        check(chunked[k].shape == (N, T), f"stream {k} shape {chunked[k].shape}")
        check(np.array_equal(chunked[k], want.numpy()),
              f"{N} x {T} stream on the card: {k} != CPU plan_fleet")
    print(f"stream {N} x {T} (K = {STREAM_K}) on the card == CPU plan_fleet bit for bit "
          f"in x/state/vpn_cost/cci_cost ({time.perf_counter() - t0:.1f} s for the CPU plan); "
          f"CCI share {chunked['x'].mean():.4f}")
    for k in fields:
        check(np.array_equal(np.stack([o[k] for o in ticks], 1), chunked[k][:, :STREAM_TICKS]),
              f"per-tick step != chunked step_many in {k}")
    print(f"per-tick step over hours 0..{STREAM_TICKS - 1} == chunked stream bit for bit "
          f"(all {len(fields)} fields; crosses the month start at hour 730)")
    for renew in (False, True):
        want = references[renew]
        got = small[renew]
        check(np.array_equal(got["x"], want["x"]) and np.array_equal(got["state"], want["state"]),
              f"{N128}-link stream (renew={renew}) != numpy plan_fleet_reference")
        check(np.allclose(got["cost"].sum(1), want["toggle_cost"], rtol=1e-9, atol=0),
              f"{N128}-link stream (renew={renew}): cost vs reference toggle cost")
    print(f"stream {N128} x {T128}: x/state == numpy per-link reference for both "
          f"renew_in_chunks; summed cost == its toggle cost (rtol 1e-9)")
    small_sc = scen[SMALL[0]]
    gpu = stream(FleetRuntime(small_sc.fleet), small_sc.demand, STREAM_K)
    cpu_rt = FleetRuntime(small_sc.fleet, device="cpu").run(small_sc.demand)
    for k in fields:
        check(np.array_equal(gpu[k], cpu_rt[k]), f"runtime {SMALL}: {k} CUDA != CPU")
    print(f"runtime {SMALL[0]} x {SMALL[1]}: CUDA (chunked) == CPU (per tick), every field")

    # -- each new kernel against its plain version, same inputs ---------------
    arrays = sc.fleet.stack(torch.float64, DEVICE)
    hpm = sc.fleet.hours_per_month
    tab = (arrays.tier_bounds, arrays.tier_rates)
    Kt = tab[0].shape[1]
    d = torch.minimum(torch.as_tensor(sc.demand, device=DEVICE), arrays.capacity[:, None])
    reset = (torch.arange(T, device=DEVICE) % hpm == 0).to(torch.int32)
    zero = torch.zeros(N, dtype=torch.float64, device=DEVICE)
    got = tiered_cost_scan(zero, d, *tab, reset)
    want = ref.tiered_cost_scan_ref(zero, d, *tab, reset)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"tiered_cost_scan f64 != plain at {N} x {T}")
    f32 = [a.float().contiguous() for a in (zero, d, *tab)]
    got32 = tiered_cost_scan(*f32, reset)
    want32 = ref.tiered_cost_scan_ref(*f32, reset)
    for g, w in zip(got32, want32):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    err32 = max((g - w).abs().max().item() for g, w in zip(got32, want32))
    print(f"tiered_cost_scan {N} x {T} (one chunk, resets at month starts): f64 == plain "
          f"(bit for bit); f32 max abs err {err32:.3e}")
    err32 = max(err32, scan_edge_checks(d, tab, hpm))

    vpn_all, cci_all = cpu["vpn_hourly"].numpy(), cpu["cci_hourly"].numpy()
    t_first, n_chunks = 696, 4                       # crosses the month start at 730
    end = t_first + n_chunks * STREAM_K
    pref_v = np.concatenate([np.zeros((1, N)), np.cumsum(vpn_all[:, :end].T, axis=0)])
    pref_c = np.concatenate([np.zeros((1, N)), np.cumsum(cci_all[:, :end].T, axis=0)])
    h_np = arrays.toggle.h.cpu().numpy()
    tp = arrays.toggle
    ones = torch.ones_like(tp.h)
    rows = (tp.theta1, tp.theta2, tp.h, tp.D, tp.T_cci, ones, ones)
    chunk_inputs = []
    for c in range(n_chunks):
        t0 = t_first + c * STREAM_K
        sl = slice(t0, t0 + STREAM_K)
        g = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=DEVICE)
        chunk_inputs.append((t0, d[:, sl].T.contiguous(), g(vpn_all[:, sl].T),
                             g(cci_all[:, sl].T), g(pre_reads(pref_v, t0, STREAM_K, h_np)),
                             g(pre_reads(pref_c, t0, STREAM_K, h_np))))
    carries = {}
    for name, cal_fn, fsm_fn in (("kernel", tiered_cost_calendar, fsm_chunk),
                                 ("plain", ref.tiered_cost_calendar_ref, ref.fsm_chunk_ref)):
        cal = torch.zeros((2, N), dtype=torch.float64, device=DEVICE)
        fsm = torch.zeros((4, N), dtype=torch.int32, device=DEVICE)
        pref = torch.as_tensor(np.stack([pref_v[t_first], pref_c[t_first]]), device=DEVICE)
        outs = []
        for t0, dk, vk, ck, pv, pc in chunk_inputs:
            costs, cal = cal_fn(cal, dk, *tab, t0, hpm)
            o = fsm_fn(vk, ck, pv, pc, *rows, fsm, pref, t0)
            fsm, pref = o["carry"], o["pref"]
            outs.append({"costs": costs, "cal": cal, **o})
        carries[name] = outs
    chunk_err = 0.0
    for a, b in zip(carries["kernel"], carries["plain"]):
        for k in b:
            check(torch.equal(a[k], b[k]), f"chunk kernels: {k} differs from the plain version")
            chunk_err = max(chunk_err, (a[k].double() - b[k].double()).abs().max().item())
    print(f"tiered_cost_calendar and fsm_chunk over {n_chunks} chained K = {STREAM_K} chunks "
          f"from hour {t_first} at {N} links: every output bit == plain")

    # -- stream_chunk against its plain version, every output bit -----------
    t_cases = time.perf_counter()
    fleet, demand = sc.fleet, sc.demand
    hbuf = int(arrays.toggle.h.max().item()) + 1
    K_long = max(hbuf, 32) + 45                      # past the kernel's tile and the ring
    bad = demand.copy()
    bad[5, t_first + 3], bad[5, t_first + 10], bad[9, t_first + 30] = np.nan, np.inf, np.nan
    ragged = head_rows(arrays, N - 5)                # not a multiple of the 16-row block
    cases = {
        f"4 chained K = {STREAM_K} from hour {t_first}": (fleet, demand, t_first,
                                                          [STREAM_K] * n_chunks, None),
        "the same, endogenous CCI demand": (fleet, demand, t_first, [STREAM_K] * n_chunks,
                                            demand * 1.5),
        "K = 1 over hours 728..731": (fleet, demand, 728, [1] * 4, None),
        f"K = {K_long} (tile 32, hbuf {hbuf}) from hour 500": (fleet, demand, 500, [K_long],
                                                               None),
        f"{N - 5} rows, 2 x K = {STREAM_K}": (ragged, demand[:N - 5], t_first,
                                              [STREAM_K] * 2, None),
        "NaN and +inf demand hours, 2 x K = 24": (fleet, bad, t_first, [STREAM_K] * 2, None),
        f"the {N128}-link fleet, 4 chained K = {STREAM_K}": (scen[N128].fleet, scen[N128].demand,
                                                            t_first, [STREAM_K] * n_chunks, None),
    }
    tog = arrays.toggle                              # short windows and no delay in some links
    short = arrays._replace(toggle=tog._replace(
        h=torch.where(torch.arange(N, device=DEVICE) % 4 == 0,
                      (torch.arange(N, device=DEVICE) % 12 + 1).to(torch.int32), tog.h),
        D=torch.where(torch.arange(N, device=DEVICE) % 8 == 1, 0, tog.D).to(torch.int32)))
    cases["windows of 1-12 h in a quarter of the links, D = 0 in an eighth, "
          "K = 24, 1, 30"] = (short, demand, t_first, [STREAM_K, 1, 30], None)
    for K in sorted({2, 3, TICK_MAX_K, TICK_MAX_K + 1, 8, 9, 23, 25}):
        cases[f"3 chained K = {K} from hour 726 ({'tick' if launch_form(K, Kt) == 0 else 'chunk'}"
              f" form)"] = (fleet, demand, 726, [K] * 3, None)
    stream_err = 0.0
    for label, (f_, d_, t_, Ks, c_) in cases.items():
        stream_err = max(stream_err, chunk_case(f_, d_, t_, Ks, c_))
        print(f"  stream_chunk == stream_chunk_ref, every output bit: {label}")
    print(f"stream_chunk: {len(cases)} cases at {N} links equal the plain version on the card "
          f"({time.perf_counter() - t_cases:.1f} s)")

    # -- timings ----------------------------------------------------------------
    print(f"streaming timings on {card} (median ms; bound = max(bytes / 3.35 TB/s, ops / peak))")
    tick = np.array(tick_us)
    print(f"  per-tick step {N} links: p50 {np.percentile(tick, 50):.1f} us, p95 "
          f"{np.percentile(tick, 95):.1f} us, p99 {np.percentile(tick, 99):.1f} us; "
          f"{N * STREAM_TICKS / tick_s:.4g} link-steps/s over {STREAM_TICKS} hours")
    chunk_ms = np.array(chunk_clock) * 1e3
    print(f"  chunked step_many {N} x {T} (K = {STREAM_K}): p50 {np.percentile(chunk_ms, 50):.3f} "
          f"ms, p95 {np.percentile(chunk_ms, 95):.3f} ms, mean {chunk_ms.mean():.3f} ms per "
          f"chunk; {N * T / chunk_s:.4g} link-steps/s; {chunk_s:.3f} s in step_many for the "
          f"year (output stacking not counted)")
    print("  kernel device times (profiler): stream_chunk by launch form (auto = the "
          "wrapper's pick), the month-to-date tiered_cost_scan, the empty kernel's floor")
    times = kernel_times(scen)
    scan_year = (times[f"tiered_cost_scan {N}x{T} float64"],
                 sync_ms(lambda: ref.tiered_cost_scan_ref(zero, d, *tab, reset), 1, warmup=0),
                 scan_bound(N, T, Kt, torch.float64))
    print(f"  tiered_cost_scan (month-to-date) {N} x {T}, one chunk: plain version on the card "
          f"{scan_year[1]:.3f} ms (not on a main path)")

    # stream_chunk and the two kernels it replaced, on one runtime's blocks at hour t_first
    rt_b = FleetRuntime(sc.fleet)
    stream(rt_b, sc.demand[:, :t_first], STREAM_K)
    renew = rt_b.policy.renew_in_chunks
    timing = {}
    for K in (STREAM_K, 1):
        block, _, _ = rt_b._pack(sc.demand[:, t_first:t_first + K], None)
        dev_block = torch.from_numpy(block).to(DEVICE)
        args = rt_b._chunk_args(dev_block, K, False)
        fused = lambda: stream_chunk(*args, renew_in_chunks=renew)
        plain = lambda: ref.stream_chunk_ref(*args, renew_in_chunks=renew)
        cap_, lvpn_, lease_, ccci_, b_, r_, *fsm_rows = rt_b._chunk_rows
        st = rt_b._state
        d_pair = torch.minimum(dev_block[:K * N].view(K, N), cap_[None, :])
        packed = plain()[0]
        vpn_k, cci_k = packed[:K], packed[K:2 * K]
        pre_v = dev_block[K * N:2 * K * N].view(K, N)
        pre_c = dev_block[2 * K * N:].view(K, N)
        cal_call = lambda: tiered_cost_calendar(st.dev_cal, d_pair, b_, r_, st.t, hpm)
        fsm_call = lambda: fsm_chunk(vpn_k, cci_k, pre_v, pre_c, *fsm_rows, st.fsm,
                                     st.dev_pref, st.t)

        def replaced():   # the sequence _launch ran before: eager glue and the two kernels
            dp = torch.minimum(dev_block[:K * N].view(K, N), cap_[None, :])
            tr, cal = tiered_cost_calendar(st.dev_cal, dp, b_, r_, st.t, hpm)
            v = lvpn_[None, :] + tr
            c = lease_[None, :] + ccci_[None, :] * dp
            o = fsm_chunk(v, c, pre_v, pre_c, *fsm_rows, st.fsm, st.dev_pref, st.t)
            return torch.cat([v, c, o["r_vpn"], o["r_cci"], o["snap_v"], o["snap_c"],
                              o["x"].to(torch.float64), o["state"].to(torch.float64), cal,
                              o["pref"]])

        check(same_bits(replaced(), fused()[0]), f"K = {K}: the replaced sequence != "
              f"stream_chunk on the same block")
        dev = kernel_device_ms(lambda: (fused(), cal_call(), fsm_call()), 20,
                               ("stream_chunk", "tiered_cost_scan_kernel",
                                "fsm_chunk_kernel"), per_call=1)
        b_k = stream_chunk_bound(N, K, Kt, False)
        timing[K] = {
            "ms": dev["stream_chunk"], "queued_ms": queued_ms(fused, 50),
            "event_ms": event_ms(fused, 50), "plain_ms": sync_ms(plain, 5), **b_k,
            "calendar_ms": dev["tiered_cost_scan_kernel"],
            "fsm_chunk_ms": dev["fsm_chunk_kernel"],
            "replaced_busy_ms": device_busy_ms(replaced, 20),
            "replaced_wall_ms": sync_ms(replaced, 20), "fused_wall_ms": sync_ms(fused, 20),
            "fsm_chunk_plain_ms": sync_ms(lambda: ref.fsm_chunk_ref(
                vpn_k, cci_k, pre_v, pre_c, *fsm_rows, st.fsm, st.dev_pref, st.t), 5),
            "calendar_bound_ms": calendar_bound(N, K, Kt)["bound_ms"],
            "fsm_chunk_bound_ms": fsm_chunk_bound(N, K)["bound_ms"],
        }
        tk = timing[K]
        print(f"  stream_chunk {N} x K={K}: profiler device time {tk['ms']:.4f} ms, CUDA "
              f"events behind a queue {tk['queued_ms']:.4f} ms, events around one call "
              f"(host launch included) {tk['event_ms']:.4f} ms; bound "
              f"{tk['bound_ms'] * 1e3:.3f} us ({tk['bound_by']}), "
              f"{tk['ms'] / tk['bound_ms']:.2f}x bound; plain {tk['plain_ms']:.3f} ms")
        print(f"    replaced, same inputs, profiler device time: tiered_cost_scan (calendar) "
              f"{tk['calendar_ms']:.4f} ms (bound {tk['calendar_bound_ms'] * 1e3:.3f} us) + "
              f"fsm_chunk {tk['fsm_chunk_ms']:.4f} ms (bound {tk['fsm_chunk_bound_ms'] * 1e3:.3f}"
              f" us); the whole replaced sequence (clip, kernels, planes, casts, cat): device "
              f"busy {tk['replaced_busy_ms']:.4f} ms, {tk['replaced_wall_ms']:.4f} ms host to "
              f"synchronize, against stream_chunk's {tk['fused_wall_ms']:.4f} ms")

    # -- one step, split: host gather + pack, H2D copy, device, D2H, commit ---
    print_step_split(rt_b, sc.demand, t_first, f"{N}")
    blk = sc.demand[:, t_first:t_first + STREAM_K]
    print_breakdown(lambda: rt_b.step_many(blk), reps=6, unit="chunk")
    print(f"streaming phase: {time.perf_counter() - t_phase:.1f} s")

    t24 = timing[STREAM_K]
    ms = {f"{n}x{K}": times[f"stream_chunk {n}x{K} auto"]
          for n, K in ((N, STREAM_K), (N, 1), (N128, STREAM_K))}
    print(f"stream_chunk, profiler device ms (before the redesign; floor): "
          + "; ".join(f"{k} {v:.5f} ({BEFORE_REDESIGN_MS['stream_chunk ' + k]})"
                      for k, v in ms.items())
          + f"; empty kernel {times['floor chunk grid, 480 threads']:.5f}. Launches on the "
          f"streaming path by shape: {T // STREAM_K} x K = {STREAM_K} and "
          f"{T % STREAM_K + STREAM_TICKS} x K = 1 at {N} links, {2 * (T128 // STREAM_K)} x "
          f"K = {STREAM_K} and {2 * (T128 % STREAM_K)} x K = 1 at {N128} links")
    rows_out = {
        "stream_chunk": {
            "launches": launches["stream_chunk"], "max_abs_err": stream_err,
            "ms": ms[f"{N}x{STREAM_K}"], "plain_ms": t24["plain_ms"],
            "bound_ms": t24["bound_ms"], "bound_by": t24["bound_by"], "main_path": True},
        "tiered_cost_scan": {
            "launches": launches["tiered_cost_scan"], "max_abs_err": max(err32, chunk_err),
            "ms": scan_year[0], "plain_ms": scan_year[1], **scan_year[2], "main_path": False},
        "fsm_chunk": {
            "launches": launches["fsm_chunk"], "max_abs_err": chunk_err,
            "ms": t24["fsm_chunk_ms"], "plain_ms": t24["fsm_chunk_plain_ms"],
            **fsm_chunk_bound(N, STREAM_K), "main_path": False},
    }
    return rows_out


LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_NEW, LM_REQUESTS = 4, 1024, 64, 3
SLICE_LAYERS, SLICE_BATCH, SLICE_PROMPT, SLICE_NEW = 2, 2, 256, 8
# float32 with TF32 off, card vs CPU: the two sum the 2048- and 5632-long
# products and the softmax in different orders, ~1e-6 relative each; logits
# are O(1), so 1e-3 leaves room for 2 layers of such differences and still
# catches any wrong index, mask or scale.
SLICE_TOL = 1e-3
# bfloat16, the decode chain (float32 softmax over the cache, probabilities
# rounded to bf16) against forward (the flash kernel, probabilities rounded
# to bf16 inside it) over 22 layers: each path rounds the bf16 residual
# stream at other places (2^-9 relative each), a random walk of ~150
# roundings of ~1 % of the hidden state; the logits are O(1-5).
SERVE_TOL = 0.1
# (B, Hq, Hkv, Sq, Skv, D, Dv), causal, window, q_offset: the TPU kernel's
# contract, in float32 (the general entry) and bf16 (the Hopper entry);
# tests/test_torch_cuda.py runs the same cases.
ATTENTION_CASES = (
    ((2, 4, 2, 256, 384, 64, 64), False, 0, 0),        # non-causal, Sq < Skv
    ((1, 4, 2, 300, 300, 64, 64), True, 100, 0),       # sliding window
    ((2, 4, 2, 64, 320, 64, 64), True, 0, 256),        # q_offset > 0, Sq < Skv
    ((1, 4, 4, 256, 256, 128, 128), True, 0, 0),       # D = 128
    ((1, 2, 1, 200, 260, 192, 128), True, 0, 60),      # D = 192, Dv = 128
    ((1, 4, 2, 1000, 1000, 64, 64), True, 0, 0),       # ragged S
    ((1, 2, 1, 128, 128, 64, 64), True, 16, 100),      # rows 143.. see no key
)
# H2O-Danube3-4B's full-width attention (32 query heads, 8 KV heads, head dim
# 120), causal, with a window shorter than the prompt and the config's own.
DANUBE_SHAPE = (1, 32, 8, 1024, 1024, 120, 120)
DANUBE_WINDOWS = (256, 4096)
GENERAL_BF16 = "flash_attention_bf16"   # the general kernel's bf16 entry


def attention_bound(B, Hq, Hkv, Sq, Skv, D, Dv, causal, dtype, window: int = 0) -> dict:
    size = torch.empty((), dtype=dtype).element_size()
    bytes_moved = size * (B * Hq * Sq * (D + Dv) + B * Hkv * Skv * (D + Dv))
    # the (query, key) pairs the masks allow at q_offset = 0
    i = np.arange(Sq)[:, None]
    j = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= j <= i
    if window > 0:
        keep &= j > i - window
    return bound(bytes_moved, 2 * B * Hq * int(keep.sum()) * (D + Dv), dtype)


def rmsnorm_bound(rows: int, d: int, dtype) -> dict:
    size = torch.empty((), dtype=dtype).element_size()
    # x read, out written, w read; per element: square, add, two multiplies (float32).
    return bound(size * (2 * rows * d + d), 4 * rows * d, torch.float32)


def seeded(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=DEVICE).to(dtype)


def teacher_forced(cfg, model, prompt, forced):
    """Prefill over ``prompt``, then decode steps fed ``forced[:, t]``: the
    logits (B, n, V) of the prefill and the n - 1 steps, float32."""
    from repro_torch.models import lm
    from repro_torch.train.serve import make_decode_step, make_prefill

    B, S = prompt.shape
    n = forced.shape[1]
    with torch.inference_mode():
        cache = lm.init_cache(cfg, B, S + n, device=model.device)
        logits, cache = make_prefill(cfg)(model, prompt, cache)
        out = [logits]
        step = make_decode_step(cfg)
        for t in range(n - 1):
            logits, cache = step(model, forced[:, t:t + 1], cache)
            out.append(logits)
    return torch.cat(out, dim=1)


def lm_phase(card: str) -> dict:
    """The LM serving path on the card: each kernel against its plain
    version (the flash kernel through both entries), the 2-layer slice
    against the CPU, the full-depth served path with launches counted, and
    timings. Returns the kernel rows."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention, run_entry
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.models import lm
    from repro_torch.models.common import LayerKind, uniform_segments
    from repro_torch.train.serve import greedy_generate, make_decode_step, make_prefill

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(LM_ARCH)
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    prefill_shape = (LM_BATCH, H, Hkv, LM_PROMPT, LM_PROMPT, hd, hd)

    # -- each kernel against its plain version, same inputs ------------------
    def sm90_runs(fn):
        """fn()'s result and how many times it launched the Hopper entry."""
        before = ops.LAUNCHES["flash_attention_sm90"]
        out = fn()
        return out, ops.LAUNCHES["flash_attention_sm90"] - before

    q, k, v = (seeded(rng, s, bf16) for s in ((LM_BATCH, H, LM_PROMPT, hd),
                                              (LM_BATCH, Hkv, LM_PROMPT, hd),
                                              (LM_BATCH, Hkv, LM_PROMPT, hd)))
    got, n = sm90_runs(lambda: flash_attention(q, k, v, causal=True))
    check(n == 1, f"flash_attention bf16 {prefill_shape}: the Hopper entry did not launch")
    want = ref.attention(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
    flash_err = (got.float() - want).abs().max().item()
    print(f"flash_attention_sm90 bf16 {prefill_shape} causal vs float32 plain: max abs err "
          f"{flash_err:.3e} (tolerance 2e-2)")
    errs = {}
    bf16_cases = list(ATTENTION_CASES) + [(DANUBE_SHAPE, True, w, 0) for w in DANUBE_WINDOWS]
    for (B, Hq, Hk, Sq, Skv, D, Dv), causal, window, q_offset in bf16_cases:
        a, b, c = (seeded(rng, s, bf16)
                   for s in ((B, Hq, Sq, D), (B, Hk, Skv, D), (B, Hk, Skv, Dv)))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        label = f"flash bf16 {(B, Hq, Hk, Sq, Skv, D, Dv)} window {window} q_offset {q_offset}"
        got16, n = sm90_runs(lambda: flash_attention(a, b, c, **kw))
        check(n == 1, f"{label}: the Hopper entry did not launch")
        want16 = ref.attention(a.float(), b.float(), c.float(), **kw)
        check(bool(torch.isfinite(got16).all()), f"{label}: not finite")
        torch.testing.assert_close(got16.float(), want16, rtol=2e-2, atol=2e-2)
        errs[label] = (got16.float() - want16).abs().max().item()
        if window and q_offset:
            empty = q_offset + torch.arange(Sq, device=DEVICE) - window + 1 >= Skv
            check(bool(empty.any()) and bool((got16[:, :, empty] == 0).all()),
                  f"{label}: rows with no valid key are not 0")
    print(f"flash_attention_sm90 bf16 over the {len(ATTENTION_CASES)} contract cases and "
          f"H2O-Danube3's {DANUBE_SHAPE} causal with windows {DANUBE_WINDOWS}, vs float32 "
          f"plain (tolerance 2e-2), each through the Hopper entry: max abs err "
          f"{max(errs.values()):.3e}; by case: " + ", ".join(f"{e:.2e}" for e in errs.values()))
    err32 = 0.0
    for (B, Hq, Hk, Sq, Skv, D, Dv), causal, window, q_offset in ATTENTION_CASES:
        a, b, c = (seeded(rng, s, f32) for s in ((B, Hq, Sq, D), (B, Hk, Skv, D), (B, Hk, Skv, Dv)))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got32, n = sm90_runs(lambda: flash_attention(a, b, c, **kw))
        check(n == 0, "flash f32 launched the Hopper entry")
        want32 = ref.attention(a, b, c, **kw)
        check(bool(torch.isfinite(got32).all()), f"flash f32 {(B, Hq, Hk, Sq, Skv, D, Dv)}: not finite")
        torch.testing.assert_close(got32, want32, rtol=2e-5, atol=2e-5)
        err32 = max(err32, (got32 - want32).abs().max().item())
        if window and q_offset:
            empty = q_offset + torch.arange(Sq, device=DEVICE) - window + 1 >= Skv
            check(bool(empty.any()) and bool((got32[:, :, empty] == 0).all()),
                  "flash f32: rows with no valid key are not 0")
    print(f"flash_attention f32 (general entry) over {len(ATTENTION_CASES)} contract cases "
          f"(non-causal, window, q_offset with Sq < Skv, D = 128, D = 192 / Dv = 128, ragged "
          f"S = 1000, rows with no key -> 0): max abs err {err32:.3e} (tolerance 2e-5)")
    norm_err = {}
    for rows in (LM_BATCH * LM_PROMPT, LM_BATCH):
        for dtype, tol in ((bf16, 2e-2), (f32, 1e-5)):
            x, w = seeded(rng, (rows, d), dtype), seeded(rng, (d,), dtype)
            got = rmsnorm(x, w, eps=cfg.norm_eps)
            want = ref.rmsnorm(x.float(), w.float(), eps=cfg.norm_eps)
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
            norm_err[rows, dtype] = (got.float() - want).abs().max().item()
    print("rmsnorm vs float32 plain, max abs err: " + ", ".join(
        f"{r} x {d} {str(t).split('.')[-1]} {e:.3e}" for (r, t), e in norm_err.items())
        + " (tolerance bf16 2e-2, f32 1e-5)")

    # -- the slice on the card against the slice on the CPU, float32 --------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, segments=uniform_segments(LayerKind("gqa", "dense"),
                                                              SLICE_LAYERS), dtype="float32")
    card_model = lm.LM(cfg2, seed=SEED)
    check(card_model.device.type == DEVICE.type, "LM did not default to the card")
    cpu_model = lm.LM(cfg2, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in card_model.state_dict().items()})
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (SLICE_BATCH, SLICE_PROMPT)))
    cpu_tokens = greedy_generate(cfg2, cpu_model, prompt, SLICE_NEW)
    card_tokens = greedy_generate(cfg2, card_model, prompt, SLICE_NEW).cpu()
    cpu_chain = teacher_forced(cfg2, cpu_model, prompt, cpu_tokens)
    card_chain = teacher_forced(cfg2, card_model, prompt.to(DEVICE), cpu_tokens.to(DEVICE)).cpu()
    slice_err = (card_chain - cpu_chain).abs().max().item()
    print(f"slice {SLICE_LAYERS} layers at full width, float32, B = {SLICE_BATCH}, S = "
          f"{SLICE_PROMPT}, {SLICE_NEW} new: card vs CPU logits (prefill + teacher-forced "
          f"decode) max abs err {slice_err:.3e} (tolerance {SLICE_TOL}, logits up to "
          f"{cpu_chain.abs().max().item():.2f})")
    torch.testing.assert_close(card_chain, cpu_chain, rtol=SLICE_TOL, atol=SLICE_TOL)
    if not torch.equal(card_tokens, cpu_tokens):
        t = int((card_tokens != cpu_tokens).any(0).nonzero()[0])
        top2 = cpu_chain[:, t].topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        print(f"  greedy token flips at step {t}: CPU top-2 margin {margin:.3e}")
        check(margin < SLICE_TOL, f"greedy tokens differ at step {t} with margin {margin:.3e}")
    else:
        print(f"  greedy tokens equal ({SLICE_NEW} steps)")
    del card_model, cpu_model

    # -- the served path: full tinyllama-1.1b in bf16, launches counted ------
    model = lm.LM(cfg, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    greedy_generate(cfg, model, torch.zeros((1, 16), dtype=torch.long), 2)   # warm-up
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)))
               for _ in range(LM_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    outs, batch_s, per_batch = [], [], []
    ops.reset_launches()
    for p in prompts:
        before = dict(ops.LAUNCHES)
        a = time.perf_counter()
        outs.append(greedy_generate(cfg, model, p, LM_NEW))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - a)
        per_batch.append({n: ops.LAUNCHES[n] - before[n]
                          for n in ("flash_attention", "flash_attention_sm90", "rmsnorm")})
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"served path launches: {launches}; per request batch {per_batch}")
    forwards = LM_NEW                                  # one prefill + LM_NEW - 1 decode steps
    for n in per_batch:
        check(n["flash_attention"] == n["flash_attention_sm90"] == cfg.n_layers,
              f"flash_attention launched {n['flash_attention']} times in a request batch, "
              f"{n['flash_attention_sm90']} through the Hopper entry, not {cfg.n_layers}")
        check(n["rmsnorm"] == forwards * (2 * cfg.n_layers + 1),
              f"rmsnorm launched {n['rmsnorm']} times in {forwards} forwards, not "
              f"{2 * cfg.n_layers + 1} per forward")
    for o in outs:
        check(o.shape == (LM_BATCH, LM_NEW) and bool(((o >= 0) & (o < cfg.vocab)).all()),
              "served tokens out of range")
    print(f"served {LM_REQUESTS} request batches of {LM_ARCH} ({n_params / 1e9:.3f} B params, "
          f"bf16, {cfg.n_layers} layers, seeded init): B = {LM_BATCH}, {LM_PROMPT} prompt "
          f"tokens, {LM_NEW} new; flash_attention_sm90 {cfg.n_layers} per batch, rmsnorm "
          f"{2 * cfg.n_layers + 1} per forward")

    chain = teacher_forced(cfg, model, prompts[0].to(DEVICE), outs[0])
    with torch.inference_mode():
        full, _ = lm.forward(cfg, model, torch.cat([prompts[0].to(DEVICE), outs[0][:, :-1]], 1))
    full = full[:, LM_PROMPT - 1:]
    check(bool(torch.isfinite(chain).all()) and bool(torch.isfinite(full).all()),
          "served logits not finite")
    check(torch.equal(chain.argmax(-1).int(), outs[0]), "decode chain != greedy tokens")
    serve_err = (chain - full).abs().max().item()
    print(f"decode chain vs forward over the same {LM_PROMPT + LM_NEW - 1} tokens, full depth "
          f"bf16: max abs err {serve_err:.3e} (tolerance {SERVE_TOL}; logits up to "
          f"{full.abs().max().item():.2f}), top-1 agrees at "
          f"{(chain.argmax(-1) == full.argmax(-1)).float().mean().item():.4f} of positions")
    torch.testing.assert_close(chain, full, rtol=SERVE_TOL, atol=SERVE_TOL)

    # -- timings ----------------------------------------------------------------
    print(f"LM timings on {card} (median ms; bound = max(bytes / 3.35 TB/s, ops / peak))")
    prefill, step = make_prefill(cfg), make_decode_step(cfg)
    p0 = prompts[0].to(DEVICE)
    with torch.inference_mode():
        cache = lm.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_NEW)
        prefill_ms = sync_ms(lambda: prefill(model, p0, cache), 5)
        prefill(model, p0, cache)
        tok = outs[0][:, :1]
        step_ms = []
        for _ in range(LM_NEW - 1):
            a = time.perf_counter()
            step(model, tok, cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - a) * 1e3)

        def one_step():
            cache["index"] = LM_PROMPT
            step(model, tok, cache)

        step_ms = np.array(step_ms)
        gen_s = float(np.median(batch_s))
        print(f"  prefill B = {LM_BATCH} x {LM_PROMPT}: {prefill_ms:.3f} ms "
              f"({LM_BATCH * LM_PROMPT / prefill_ms * 1e3:.4g} prompt tokens/s)")
        print(f"  decode step B = {LM_BATCH}: p50 {np.percentile(step_ms, 50):.3f} ms, p95 "
              f"{np.percentile(step_ms, 95):.3f} ms per token ({LM_BATCH / np.percentile(step_ms, 50) * 1e3:.4g} "
              f"tokens/s at p50)")
        print(f"  request batch (prefill + {LM_NEW - 1} decode steps, greedy_generate): median "
              f"{gen_s * 1e3:.1f} ms, {LM_BATCH * LM_NEW / gen_s:.4g} generated tokens/s, "
              f"{LM_BATCH * LM_PROMPT / gen_s:.4g} prompt tokens/s")
        print(f"  memory: peak {peak_gb:.3f} GB allocated while serving; {base_gb:.3f} GB were "
              f"held before (the weights, {weights_gb:.3f} GB, and earlier phases' tensors), so "
              f"the served path took {weights_gb + peak_gb - base_gb:.3f} GB with its weights")
        print_breakdown(lambda: prefill(model, p0, cache), reps=3, unit="prefill")
        print_breakdown(one_step, reps=10, unit="decode step")

    # attention at the prefill shape, in one table: the Hopper kernel, the
    # general kernel on the same inputs, SDPA, the plain version, the bound;
    # device time per call (the inputs, 23 MB, stay in L2)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    timing = {
        "flash_attention": (
            queued_ms(lambda: flash_attention(q, k, v, causal=True), 50),
            queued_ms(lambda: ref.attention(q, k, v, causal=True), 5),
            queued_ms(sdpa, 50),
            attention_bound(*prefill_shape, True, bf16)),
    }
    general_ms = queued_ms(lambda: run_entry(GENERAL_BF16, q, k, v, causal=True), 10)
    fl = timing["flash_attention"]
    print(f"  attention bf16 {prefill_shape} causal, device ms: flash_attention_sm90 {fl[0]:.4f} | "
          f"general entry {general_ms:.4f} ({general_ms / fl[0]:.2f}x the Hopper kernel) | "
          f"SDPA {fl[2]:.4f} (Hopper kernel / SDPA {fl[0] / fl[2]:.3f}) | plain "
          f"{fl[1]:.4f} | bound {fl[3]['bound_ms']:.4f} ({fl[3]['bound_by']}; Hopper kernel "
          f"{fl[0] / fl[3]['bound_ms']:.2f}x it)")
    _, dHq, dHk, dSq, dSkv, dD, dDv = DANUBE_SHAPE
    a, b, c = (seeded(rng, s, bf16) for s in ((1, dHq, dSq, dD), (1, dHk, dSkv, dD),
                                              (1, dHk, dSkv, dDv)))
    rows = torch.arange(dSq, device=DEVICE)
    for w in DANUBE_WINDOWS:
        keep = (rows[None, :] <= rows[:, None]) & (rows[None, :] > rows[:, None] - w)
        ms = queued_ms(lambda: flash_attention(a, b, c, causal=True, window=w), 50)
        lib_ms = queued_ms(lambda: F.scaled_dot_product_attention(
            a, b, c, attn_mask=keep, enable_gqa=True), 50)
        gen_ms = queued_ms(lambda: run_entry(GENERAL_BF16, a, b, c, causal=True, window=w), 10)
        bd = attention_bound(*DANUBE_SHAPE, True, bf16, window=w)
        print(f"  attention bf16 {DANUBE_SHAPE} causal window {w}, device ms: "
              f"flash_attention_sm90 {ms:.4f} | general entry {gen_ms:.4f} | SDPA (boolean "
              f"mask) {lib_ms:.4f} | bound {bd['bound_ms']:.4f} ({bd['bound_by']})")
    # RMSNorm: device time with x cold (a read and write of 128 MB between
    # calls evicts the 50 MB L2, so x comes from HBM as the byte bound
    # assumes) and warm (repeated calls, x in L2), and the wall time of one
    # call with its launch
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=DEVICE)
    cold_ms = lambda fn, reps: queued_ms(fn, reps, before=lambda: flush.add_(1.0))
    norm_warm = {}
    for rows in (LM_BATCH * LM_PROMPT, LM_BATCH):
        x, w = seeded(rng, (rows, d), bf16), seeded(rng, (d,), bf16)
        kern = lambda: rmsnorm(x, w, eps=cfg.norm_eps)
        lib = lambda: F.rms_norm(x, (d,), w, eps=cfg.norm_eps)
        key = f"rmsnorm_{rows}"
        timing[key] = (cold_ms(kern, 50), cold_ms(lambda: ref.rmsnorm(x, w, eps=cfg.norm_eps), 20),
                       cold_ms(lib, 50), rmsnorm_bound(rows, d, bf16))
        norm_warm[rows] = (queued_ms(kern, 50), queued_ms(lib, 50), event_ms(kern, 50),
                           event_ms(lib, 50))
        ms, plain_ms, lib_ms, b = timing[key]
        wk, wl, ek, el = norm_warm[rows]
        print(f"  rmsnorm bf16 {rows} x {d}, device ms with x cold: kernel {ms:.4f}, plain "
              f"{plain_ms:.4f}, F.rms_norm {lib_ms:.4f}, bound {b['bound_ms'] * 1e3:.3f} us "
              f"({b['bound_by']}; kernel {ms / b['bound_ms']:.2f}x it); x warm in L2: kernel "
              f"{wk:.4f}, F.rms_norm {wl:.4f}; wall per call with its launch (CUDA events): "
              f"kernel {ek:.4f}, F.rms_norm {el:.4f}")
    del flush
    print(f"LM phase: {time.perf_counter() - t_phase:.1f} s")

    norm = timing[f"rmsnorm_{LM_BATCH * LM_PROMPT}"]
    return {
        "flash_attention": {
            "launches": launches["flash_attention_sm90"], "max_abs_err": flash_err,
            "ms": fl[0], "plain_ms": fl[1], **fl[3], "library_ms": fl[2],
            "general_ms": general_ms},
        "rmsnorm": {
            "launches": launches["rmsnorm"], "max_abs_err": norm_err[LM_BATCH * LM_PROMPT, bf16],
            "ms": norm[0], "plain_ms": norm[1], **norm[3], "library_ms": norm[2],
            "warm_ms": norm_warm[LM_BATCH * LM_PROMPT][0]},
    }


ACT_ARCH = "tinyllama-1.1b"
ACT_STEPS = 3                       # compressed syncs with carried residuals
# sync steps per hour, switching every quarter of the year: 3 toggles
ACT_REGIME_HOURS, ACT_STEPS_LOW, ACT_STEPS_HIGH = 2190, 360, 36000
ACT_WINDOW = 24                     # hours synced around each toggle
ELASTIC_SIZE, ELASTIC_HOURS = 2048, 800
ELASTIC_SCALE = 16e9                # bytes per demand unit: at 1e9 no link leases
SYNC_FLEET, SYNC_HOURS = (16, 2000), 24
WHATIF_P = 2048                     # what-if columns of the year's VPN bill
# float32 month-to-date volumes (up to ~3e7 GB) against the planner's float64
# comparator: 1e-6 to 2e-6 relative measured on the CPU with the same arithmetic.
WHATIF_RTOL = 1e-5


def grad_tree(cfg, gen):
    """A float32 gradient pytree with the shapes of the port's LM at ``cfg``
    (one leaf per parameter, by name), drawn from ``gen`` on the card."""
    from repro_torch.models import lm

    shapes = {n: tuple(p.shape) for n, p in lm.LM(cfg, device="meta").named_parameters()}
    return {n: torch.randn(s, generator=gen, device=DEVICE, dtype=torch.float32).mul_(1e-3)
            for n, s in shapes.items()}


def plain_compressed(g, err):
    """The compressed sync of one leaf on one rank, by the plain versions
    (the JAX collectives' scale guard): ``(deq, u - deq)`` with ``u = g + err``."""
    from repro_torch.kernels import ref

    u = g + err
    q, s = ref.int8_quantize(u.reshape(-1, u.shape[-1]), guard="collectives")
    deq = ref.int8_dequantize(q, s).view(u.shape)
    return deq, u - deq


def print_host_ops(fn, top: int = 8) -> None:
    """Host (CPU) time of one ``fn()`` by operator, from torch.profiler:
    where a call whose device is mostly idle spends its time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops_ = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    total = sum(e.self_cpu_time_total for e in ops_)
    print(f"    host: {total / 1e3:.1f} ms of operator self time on the CPU, top {top}:")
    for e in ops_[:top]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  {e.count:6d} calls  {e.key[:70]}")


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal shapes and types, NaN in the same places, equal values elsewhere
    (``torch.equal`` is False wherever both hold NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def quant_bound(rows_d, dtype) -> dict:
    size = torch.empty((), dtype=dtype).element_size()
    n = sum(r * d for r, d in rows_d)
    rows = sum(r for r, _ in rows_d)
    # x read, q written, one float32 scale per row; per value: abs, max, div, rint, clamp.
    return bound(n * (size + 1) + 4 * rows, 5 * n, torch.float32)


def dequant_bound(rows_d, dtype) -> dict:
    size = torch.empty((), dtype=dtype).element_size()
    n = sum(r * d for r, d in rows_d)
    rows = sum(r for r, _ in rows_d)
    return bound(n * (1 + size) + 4 * rows, n, torch.float32)


def static_tiered_bound(T: int, P: int, K: int) -> dict:
    # month_cum and demand read, cost written (float32); per tier: min, max, sub, max, mul, add.
    return bound(12 * T * P, T * P * (1 + 6 * K), torch.float32)


def actuation_phase(card: str) -> dict:
    """The actuation slice on the card: the int8 and static tiered-cost
    kernels against their plain versions, then, with launches counted, the
    full-width TinyLlama gradient synced in every mode and three compressed
    steps, the single-link planner driving real syncs around its toggles
    (and its year's VPN bill priced as a what-if plane), the elastic fleet
    planner card vs CPU, and ``fleet_sync_grads``; then timings. Returns the
    kernel rows."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import monthly_cumsum
    from repro_torch.core.planner import InterconnectPlanner, dci_scenario
    from repro_torch.core.pricing import AWS_EGRESS_INTERNET
    from repro_torch.dist.collectives import fleet_sync_grads, sync_grads, sync_wire_bytes
    from repro_torch.fleet import ElasticFleetPlanner, build_fleet_scenario
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.int8_quant import int8_dequantize, int8_quantize
    from repro_torch.kernels.tiered_cost import tiered_cost

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(ACT_ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    grads = grad_tree(cfg, gen)
    leaves = list(grads.values())
    n_leaves = len(leaves)
    n_values = sum(g.numel() for g in leaves)
    rows_d = [(g.numel() // g.shape[-1], g.shape[-1]) for g in leaves]
    print(f"actuation: {ACT_ARCH} gradient pytree, {n_leaves} leaves, {n_values / 1e9:.3f} B "
          f"float32 values ({4 * n_values / 1e9:.2f} GB), seeded on the card; leaf shapes "
          f"{sorted(set(tuple(g.shape) for g in leaves))}")

    # -- each kernel against its plain version, same CUDA tensors -------------
    d_model = cfg.d_model
    cases = sorted(set(tuple(g.view(-1, g.shape[-1]).shape) for g in leaves)) + [(17, 2048)]
    quant_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in cases:
            x = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
            if shape[0] > 2:
                x[0] = 0.0                                      # a row of zeros
                x[1] *= 1e-29 / x[1].abs().max()                # amax = 1e-29
            x_cpu = x.cpu()
            for guard in ("collectives", "pallas"):
                q, s = int8_quantize(x, guard=guard)
                wq, ws = ref.int8_quantize(x, guard=guard)
                check(torch.equal(q, wq) and torch.equal(s, ws),
                      f"int8_quantize {shape} {dtype} guard {guard} != plain")
                cq, cs = ref.int8_quantize(x_cpu, guard=guard)
                check(torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs),
                      f"int8_quantize {shape} {dtype} guard {guard} != plain on the CPU")
            for odt in (torch.float32, torch.bfloat16):
                got, want = int8_dequantize(q, s, odt), ref.int8_dequantize(q, s, odt)
                check(torch.equal(got, want), f"int8_dequantize {shape} -> {odt} != plain")
                quant_err = max(quant_err, (got.float() - want.float()).abs().max().item())
    print(f"int8_quantize (both scale guards) / int8_dequantize f32 and bf16 on every leaf "
          f"shape {cases} (a zero row and a row with amax 1e-29 in each): q, scale and both "
          f"dequantized types == plain on the card, q and scale == plain on the CPU (bit for "
          f"bit)")
    # The repair of non-finite rows, and the kernel's scalar branch: rows holding
    # NaN, +inf and -inf; views that start one element past a 16-byte boundary.
    n_nf = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (256, 2047, 2048, 5632, 32000):
            x = torch.randn((6, d), generator=gen, device=DEVICE) * 3.0
            x[0, 5] = float("nan")
            x[1, 0] = float("inf")
            x[2, d - 1] = float("-inf")
            x[3, 2], x[3, 7] = float("inf"), float("nan")
            x[4] = 0.0
            x = x.to(dtype)
            for guard in ("collectives", "pallas"):
                q, s = int8_quantize(x, guard=guard)
                wq, ws = ref.int8_quantize(x, guard=guard)
                cq, cs = ref.int8_quantize(x.cpu(), guard=guard)
                check(torch.equal(q, wq) and same_nan(s, ws) and torch.equal(q.cpu(), cq)
                      and same_nan(s.cpu(), cs), f"int8_quantize non-finite rows d={d} {dtype} "
                      f"guard {guard}: kernel, card plain and CPU plain differ")
                check(bool(torch.isnan(s[[0, 3]]).all()) and bool((s[[1, 2]] == float("inf"))
                                                                  .all())
                      and bool((q[:5] == 0).all()), f"int8_quantize non-finite rows d={d}: "
                      f"scale {s.flatten().tolist()}, not JAX's NaN/inf with q = 0")
                deq = int8_dequantize(q, s)
                check(same_nan(deq, ref.int8_dequantize(q, s)) and bool(torch.isnan(deq[:4])
                                                                          .all()),
                      f"int8_dequantize non-finite rows d={d}: != plain or not NaN")
                n_nf += 1
        for n, d in ((300, 2048), (64, 5632), (33, 2047), (9, 32000)):
            buf = torch.zeros(n * d + 1, dtype=dtype, device=DEVICE)
            view = buf[1:].view(n, d)
            view.copy_(torch.randn((n, d), generator=gen, device=DEVICE))
            check(view.data_ptr() % 16 != 0, "the view is aligned")
            for guard in ("collectives", "pallas"):
                q, s = int8_quantize(view, guard=guard)
                wq, ws = ref.int8_quantize(view, guard=guard)
                cq, cs = ref.int8_quantize(view.cpu(), guard=guard)
                check(torch.equal(q, wq) and torch.equal(s, ws) and torch.equal(q.cpu(), cq)
                      and torch.equal(s.cpu(), cs), f"int8_quantize misaligned view {n} x {d} "
                      f"{dtype} guard {guard}: kernel, card plain and CPU plain differ")
    print(f"int8_quantize on rows holding NaN, +inf, -inf (d in 256, 2047, 2048, 5632, 32000; "
          f"{n_nf} cases, f32 and bf16, both guards): scale NaN or inf and q = 0 as in JAX, "
          f"kernel == card plain == CPU plain, dequantized NaN; misaligned views (300 x 2048, "
          f"64 x 5632, 33 x 2047, 9 x 32000): kernel == card plain == CPU plain")
    # The repair: the sync's guard on a 1e-29 row, card kernel == card plain == CPU plain.
    tiny = torch.randn((2, 2048), generator=gen, device=DEVICE)
    tiny[0] *= 1e-29 / tiny[0].abs().max()
    tq, ts = int8_quantize(tiny, guard="collectives")
    pq, ps = ref.int8_quantize(tiny, guard="collectives")
    cq, cs = ref.int8_quantize(tiny.cpu(), guard="collectives")
    check(torch.equal(tq, pq) and torch.equal(ts, ps) and torch.equal(tq.cpu(), cq)
          and torch.equal(ts.cpu(), cs), "int8_quantize guard collectives, 1e-29 row: kernel, "
          "card plain and CPU plain differ")
    check(ts[0, 0].item() == float(np.float32(1e-30)) and int(tq[0].abs().max()) == 10,
          "int8_quantize guard collectives, 1e-29 row: scale is not 1e-30")
    print(f"int8_quantize guard collectives on a row with |max| 1e-29: scale "
          f"{ts[0, 0].item():.3e}, |q| max {int(tq[0].abs().max())}; card kernel == card plain "
          f"== CPU plain (bit for bit)")
    T_w, P_w = 8760, WHATIF_P
    d = torch.rand((T_w, P_w), generator=gen, device=DEVICE, dtype=torch.float64) * 500.0
    cum32 = monthly_cumsum(d.T, 730).T.float().contiguous()
    d32 = d.float()
    tiers = {"dci_scenario": dci_scenario().vpn_tier, "AWS_EGRESS_INTERNET": AWS_EGRESS_INTERNET}
    for name, tier in tiers.items():
        got = tiered_cost(cum32, d32, tier.bounds_gb, tier.rates)
        want = ref.tiered_cost(cum32, d32, tier.bounds_gb, tier.rates)
        check(torch.equal(got, want), f"tiered_cost {T_w} x {P_w} ({name}) != plain")
    print(f"tiered_cost {T_w} x {P_w} float32, tables {list(tiers)} (infinite last bound): "
          f"== plain (bit for bit)")

    # -- the main path, launches counted --------------------------------------
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
        parts = {}
        t_part = time.perf_counter()
        ops.reset_launches()
        for mode in ("direct", "hierarchical"):
            out, err = sync_grads(grads, mesh, mode=mode)
            check(err is None and all(torch.equal(out[k], grads[k]) for k in grads),
                  f"sync_grads {mode} on one rank != its input")
            del out
        err = None
        before = dict(ops.LAUNCHES)
        for step in range(ACT_STEPS):
            out, new_err = sync_grads(grads, mesh, mode="compressed", err_state=err)
            for k, g in grads.items():
                deq, res = plain_compressed(g, err[k] if err is not None else torch.zeros_like(g))
                check(torch.equal(out[k], deq) and torch.equal(new_err[k], res),
                      f"compressed step {step}, leaf {k}: != the plain path")
                del deq, res
            err = new_err
            del out
        n_q = ops.LAUNCHES["int8_quantize"] - before["int8_quantize"]
        n_dq = ops.LAUNCHES["int8_dequantize"] - before["int8_dequantize"]
        check(n_q == ACT_STEPS * n_leaves, f"int8_quantize launched {n_q} times in "
              f"{ACT_STEPS} compressed syncs of {n_leaves} leaves, not one per leaf")
        check(n_dq == 2 * ACT_STEPS * n_leaves, f"int8_dequantize launched {n_dq} times, not "
              f"two per leaf (the residual, the gathered stack)")
        print(f"sync_grads on a one-rank NCCL (pod, data, model) mesh: direct and "
              f"hierarchical == input; {ACT_STEPS} compressed steps with carried residuals: "
              f"every output and residual == the plain path (bit for bit); per compressed "
              f"sync int8_quantize {n_q // ACT_STEPS} = 1 per leaf, int8_dequantize "
              f"{n_dq // ACT_STEPS} = 2 per leaf")

        parts["sync modes + 3 compressed steps, checked"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # the single-link planner over a year, syncing around its toggles
        full_b = sync_wire_bytes(grads, "hierarchical")
        comp_b = sync_wire_bytes(grads, "compressed")
        steps = np.where((np.arange(8760) // ACT_REGIME_HOURS) % 2 == 0,
                         ACT_STEPS_LOW, ACT_STEPS_HIGH)
        raw = full_b * steps.astype(np.float64)
        dry = InterconnectPlanner()
        modes = [dry.feed_hour(b) for b in raw]
        toggles = [t for t in range(1, len(modes)) if modes[t] != modes[t - 1]]
        check(len(toggles) >= 2, f"planner toggled {len(toggles)} times over the year")
        window = set()
        for t in toggles:
            window.update(range(max(0, t - ACT_WINDOW // 2), t + ACT_WINDOW // 2))
        pl, err, n_sync = InterconnectPlanner(), None, {"hierarchical": 0, "compressed": 0}
        sample = "embed"
        for t, b in enumerate(raw):
            mode = pl.feed_hour(b)
            check(mode == modes[t], f"planner replay differs at hour {t}")
            if t in window:
                e_old = err[sample] if err is not None else None
                out, new_err = sync_grads(grads, mesh, mode=mode,
                                          err_state=err if mode == "compressed" else None)
                if mode == "hierarchical":
                    check(torch.equal(out[sample], grads[sample]), "hierarchical sync != input")
                else:
                    u = grads[sample] + (e_old if e_old is not None else 0.0)
                    check(torch.equal(new_err[sample], u - out[sample]),
                          "compressed sync: residual != u - output")
                    err = new_err
                n_sync[mode] += 1
                del out
        rep = pl.report()
        print(f"InterconnectPlanner, 8760 h of {full_b / 1e9:.3f} GB/step (compressed "
              f"{comp_b / 1e9:.3f} GB/step, ratio {full_b / comp_b:.4f}) x {ACT_STEPS_LOW} or "
              f"{ACT_STEPS_HIGH} steps/h, regimes of {ACT_REGIME_HOURS} h: toggles at {toggles}; "
              f"on_fraction {rep.on_fraction:.4f}, cost {rep.total_cost:.1f} vs always-VPN "
              f"{rep.cost_always_vpn:.1f}, always-CCI {rep.cost_always_cci:.1f}; ran the sync "
              f"{n_sync} times in the {ACT_WINDOW} h around each toggle")
        # its year's pay-per-GB bill, priced for WHATIF_P sync sizes in one plane
        p = pl.params
        gb = torch.as_tensor(raw / 1e9 / pl.COMPRESS_RATIO, device=DEVICE)
        frac = torch.arange(1, WHATIF_P + 1, device=DEVICE, dtype=torch.float64) / WHATIF_P
        dplane = gb[:, None] * frac[None, :]
        cplane = monthly_cumsum(dplane.T, p.hours_per_month).T
        bill = (ops.tiered_cost(cplane, dplane, p.vpn_tier.bounds_gb, p.vpn_tier.rates)
                .double().sum(0) + len(raw) * p.L_vpn)
        whatif_rel = abs(bill[-1].item() / rep.cost_always_vpn - 1.0)
        check(whatif_rel < WHATIF_RTOL, f"what-if year bill {bill[-1].item()} vs the planner's "
              f"always-VPN {rep.cost_always_vpn}: rel {whatif_rel:.3e}")
        print(f"what-if: the year's VPN bill at {WHATIF_P} sync sizes (8760 x {WHATIF_P}, "
              f"ops.tiered_cost); the full size vs the planner's always-VPN comparator: rel "
              f"{whatif_rel:.3e} (tolerance {WHATIF_RTOL}); at 1/{WHATIF_P} of the size "
              f"{bill[0].item():.1f}")
        del err, dplane, cplane

        parts["planner year + syncs around toggles + what-if"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # the elastic fleet planner: card against CPU, bit for bit
        sc = build_fleet_scenario(ELASTIC_SIZE, horizon=ELASTIC_HOURS, seed=SEED)
        traffic = sc.demand.T * ELASTIC_SCALE
        card_pl = ElasticFleetPlanner(sc.fleet)
        check(card_pl.runtime.device.type == DEVICE.type, "ElasticFleetPlanner not on the card")
        cpu_pl = ElasticFleetPlanner(sc.fleet, device="cpu")
        feed_us = []
        for t, b in enumerate(traffic):
            a = time.perf_counter()
            m_card = card_pl.feed_hour(b)
            feed_us.append((time.perf_counter() - a) * 1e6)
            check(m_card == cpu_pl.feed_hour(b), f"elastic planner modes card != CPU at hour {t}")
        r_card, r_cpu = card_pl.report(), cpu_pl.report()
        for k in ("total_cost", "cost_always_vpn", "cost_always_cci", "total_gb"):
            check(getattr(r_card, k) == getattr(r_cpu, k), f"elastic report {k}: card != CPU")
        for a_, b_, k in ((card_pl.cost, cpu_pl.cost, "cost"),
                          (card_pl.cost_vpn_only, cpu_pl.cost_vpn_only, "cost_vpn_only"),
                          (card_pl.cost_cci_only, cpu_pl.cost_cci_only, "cost_cci_only"),
                          (card_pl.gb, cpu_pl.gb, "gb"), (card_pl.gb_saved, cpu_pl.gb_saved,
                                                         "gb_saved"),
                          (r_card.on_fraction, r_cpu.on_fraction, "on_fraction")):
            check(np.array_equal(a_, b_), f"elastic planner {k}: card != CPU")
        print(f"ElasticFleetPlanner {ELASTIC_SIZE} links x {ELASTIC_HOURS} h "
              f"(build_fleet_scenario seed {SEED}, demand x {ELASTIC_SCALE:.3g} bytes/h): modes "
              f"every tick and cost/cost_vpn_only/cost_cci_only/gb/gb_saved card == CPU bit for "
              f"bit; leased share {r_card.on_fraction.mean():.4f}, wire savings "
              f"{r_card.wire_savings_fraction:.4f}")

        parts["elastic planner card + CPU"] = time.perf_counter() - t_part
        t_part = time.perf_counter()
        # fleet_sync_grads: 16 jobs of one full-width layer, 24 ticks over a toggle
        n_jobs, hours = SYNC_FLEET
        sc16 = build_fleet_scenario(n_jobs, horizon=hours, seed=SEED)
        pl16 = ElasticFleetPlanner(sc16.fleet)
        layer = [k for k in grads if k.startswith("layers.0.")]
        layer_vals = sum(grads[k].numel() for k in layer)
        jobs = [{k: torch.randn(grads[k].shape, generator=gen, device=DEVICE).mul_(1e-3)
                 for k in layer} for _ in range(n_jobs)]
        all_modes = [pl16.feed_hour(b) for b in sc16.demand.T * ELASTIC_SCALE]
        flips = [t for t in range(1, hours) if all_modes[t] != all_modes[t - 1]]
        check(flips, "the 16-link planner never changed a mode")
        t0 = max(0, flips[0] - SYNC_HOURS // 2)
        errs_g = errs_u = None
        for t in range(t0, t0 + SYNC_HOURS):
            m = all_modes[t]
            gs, errs_g, bg = fleet_sync_grads(jobs, mesh, m, errs_g, groups=pl16.sync_groups())
            us, errs_u, bu = fleet_sync_grads(jobs, mesh, m, errs_u)
            check(bg == bu == [sync_wire_bytes(j, mm) for j, mm in zip(jobs, m)],
                  "fleet_sync_grads: billed bytes != sync_wire_bytes")
            for i in range(n_jobs):
                check(all(torch.equal(gs[i][k], us[i][k]) for k in layer),
                      f"fleet_sync_grads grouped != ungrouped, job {i}, hour {t}")
            del gs, us
        print(f"fleet_sync_grads {n_jobs} jobs x one full-width layer ({layer_vals / 1e6:.1f} M "
              f"values each), hours {t0}..{t0 + SYNC_HOURS - 1} over the first mode change at "
              f"{flips[0]}: grouped == ungrouped, billed == sync_wire_bytes")
        torch.cuda.synchronize()
        parts["16-link planner + fleet_sync_grads"] = time.perf_counter() - t_part
        launches = dict(ops.LAUNCHES)
        print("  seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
        print(f"actuation path launches: { {k: launches[k] for k in ('int8_quantize', 'int8_dequantize', 'tiered_cost')} }")
        for name in ("int8_quantize", "int8_dequantize", "tiered_cost"):
            check(launches[name] >= 1, f"kernel {name} was not launched on the actuation path")
        print(f"  memory: peak {torch.cuda.max_memory_allocated() / 1e9 - base_gb:.3f} GB "
              f"allocated by the phase so far (net of the {base_gb:.3f} GB earlier phases hold)")
        del jobs, errs_g, errs_u

        # -- timings ------------------------------------------------------------
        print(f"actuation timings on {card} (median ms; bound = max(bytes / 3.35 TB/s, "
              f"ops / peak))")
        for mode in ("direct", "hierarchical", "compressed"):
            ms = sync_ms(lambda: sync_grads(grads, mesh, mode=mode), 3)
            print(f"  sync_grads {mode}, whole pytree ({4 * n_values / 1e9:.2f} GB): {ms:.3f} ms")
        print_breakdown(lambda: sync_grads(grads, mesh, mode="compressed"), reps=2,
                        unit="compressed sync")
        print_host_ops(lambda: sync_grads(grads, mesh, mode="compressed"))
    finally:
        dist.destroy_process_group()
    fa = np.array(feed_us)
    print(f"  ElasticFleetPlanner.feed_hour {ELASTIC_SIZE} links on the card: p50 "
          f"{np.percentile(fa, 50):.1f} us, p95 {np.percentile(fa, 95):.1f} us")

    qs = [int8_quantize(g.view(-1, g.shape[-1]), guard="collectives") for g in leaves]
    # The yardstick: one torch.mul promotes int8 q times the float32 scales to
    # float32, every bit as the kernel (and, cast, as its bfloat16 output).
    for q, s in qs:
        lib_out = torch.mul(q, s)
        check(torch.equal(int8_dequantize(q, s), lib_out)
              and torch.equal(int8_dequantize(q, s, torch.bfloat16), lib_out.bfloat16())
              and torch.equal(lib_out, ref.int8_dequantize(q, s)),
              f"int8_dequantize {tuple(q.shape)} != torch.mul(q, scale)")
    del lib_out
    print(f"int8_dequantize on every leaf ({n_leaves}): float32 == torch.mul(q, scale) == "
          f"plain, bfloat16 == torch.mul(q, scale) cast (bit for bit)")
    quant_all = lambda: [int8_quantize(g.view(-1, g.shape[-1]), guard="collectives")
                         for g in leaves]
    dequant_all = lambda: [int8_dequantize(q, s) for q, s in qs]
    # Over the pytree (201 launches) the device time is the kernels' own; the
    # wall time of the loop is the host's launch rate.
    print(f"  wall time of one pass over the {n_leaves} leaves (CUDA events, host launches "
          f"included): int8_quantize {event_ms(quant_all, 5):.4f} ms, int8_dequantize "
          f"{event_ms(dequant_all, 5):.4f} ms")
    vpn_tier = dci_scenario().vpn_tier
    static_call = lambda: tiered_cost(cum32, d32, vpn_tier.bounds_gb, vpn_tier.rates)
    timing = {
        "int8_quantize": (
            device_busy_ms(quant_all, 3),
            device_busy_ms(lambda: [ref.int8_quantize(g.view(-1, g.shape[-1]),
                                                      guard="collectives") for g in leaves], 2),
            quant_bound(rows_d, torch.float32)),
        "int8_dequantize": (
            kernel_device_ms(dequant_all, 3, ["int8_dequantize"],
                             per_call=n_leaves)["int8_dequantize"],
            device_busy_ms(lambda: [ref.int8_dequantize(q, s) for q, s in qs], 2),
            dequant_bound(rows_d, torch.float32)),
        "tiered_cost": (
            kernel_device_ms(static_call, 20, ["tiered_cost_static"],
                             per_call=1)["tiered_cost_static"],
            device_busy_ms(lambda: ref.tiered_cost(cum32, d32, vpn_tier.bounds_gb,
                                                   vpn_tier.rates), 5),
            static_tiered_bound(T_w, P_w, 3)),
    }
    library = {"int8_dequantize": device_busy_ms(lambda: [torch.mul(q, s) for q, s in qs], 3)}
    del qs
    static_events = (queued_ms(static_call, 20), event_ms(static_call, 20))
    emb = grads["embed"]
    emb_q = event_ms(lambda: int8_quantize(emb, guard="collectives"), 20)
    labels = {"int8_quantize": f"int8_quantize f32, whole pytree ({n_leaves} launches), "
                               f"profiler device busy",
              "int8_dequantize": f"int8_dequantize to f32, whole pytree ({n_leaves} launches), "
                                 f"profiler device time",
              "tiered_cost": f"tiered_cost {T_w} x {P_w} f32, 3 tiers, profiler device time"}
    no_library = {
        "int8_quantize": "torch.quantize_per_channel takes the scales as input",
        "tiered_cost": "no single call folds a tier table"}
    for key, (ms, plain_ms, b) in timing.items():
        lib = (f"torch.mul(q, scale) {library[key]:.4f} ms (profiler device time)"
               if key in library else f"library_ms null: {no_library[key]}")
        print(f"  {labels[key]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}), {ms / b['bound_ms']:.2f}x bound; "
              f"{lib}"
              + (f"; run M (before the redesign) {RUN_M_MS[key]} ms" if key in RUN_M_MS else "")
              + (f"; run Q (before the redesign) {RUN_Q_MS[key]} ms" if key in RUN_Q_MS else ""))
    print(f"  tiered_cost {T_w} x {P_w}: CUDA events around one call queued behind a sleep "
          f"(device only) {static_events[0]:.4f} ms, around one call (launch included) "
          f"{static_events[1]:.4f} ms")
    b_emb = quant_bound([tuple(emb.shape)], torch.float32)
    print(f"  int8_quantize f32 {tuple(emb.shape)} alone: {emb_q:.4f} ms, bound "
          f"{b_emb['bound_ms'] * 1e3:.2f} us, {emb_q / b_emb['bound_ms']:.2f}x bound")
    print(f"actuation phase: {time.perf_counter() - t_phase:.1f} s")
    del grads, leaves

    rows = {}
    for key in timing:
        ms, plain_ms, b = timing[key]
        rows[key] = {"launches": launches[key],
                     "max_abs_err": quant_err if key != "tiered_cost" else 0.0,
                     "ms": ms, "plain_ms": plain_ms, **b, "library_ms": library.get(key)}
    return rows


TIER_NAN_CELLS = 64      # NaN month-to-date volumes, and as many NaN demands


def tier_nan_checks(cum, d, tab) -> None:
    """Hours whose month-to-date volume or demand is NaN through the three
    tiered kernels, at the main paths' shapes: ``tiered_cost_batched`` (f64,
    f32) and the month-to-date ``tiered_cost_scan`` (f64, f32; the year as one
    chunk) on the (N, T) planes, the calendar entry on the first K = 24 hours
    across a month start, the static ``tiered_cost`` on the (T, N) plane.
    Each against its plain version on the same CUDA tensors, NaN-aware: every
    bit (float32 batched and month-to-date at ``rtol=atol=1e-6``, as on finite
    input); the fold kernels price a NaN hour +0.0, the static one gives NaN."""
    from repro_torch.core.pricing import AWS_EGRESS_INTERNET
    from repro_torch.kernels import ref
    from repro_torch.kernels.tiered_cost import tiered_cost, tiered_cost_batched
    from repro_torch.kernels.tiered_cost_scan import tiered_cost_calendar, tiered_cost_scan

    N, T = d.shape
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 18)
    pick = lambda: torch.randint(0, N * T, (TIER_NAN_CELLS,), generator=gen, device=DEVICE)
    cum, d = cum.clone(), d.clone()
    cum.view(-1)[pick()] = float("nan")
    d.view(-1)[pick()] = float("nan")
    nan_in = torch.isnan(cum) | torch.isnan(d)
    zero_at = lambda got, mask: bool((got[mask] == 0).all()) and not bool(
        torch.signbit(got[mask]).any())
    hour = torch.arange(T, device=DEVICE)
    reset = ((hour % 730 == 0) & (hour > 0)).to(torch.int32)
    for dtype in (torch.float64, torch.float32):
        c, dd, b, r = (a.to(dtype).contiguous() for a in (cum, d, *tab))
        got, want = tiered_cost_batched(c, dd, b, r), ref.tiered_cost_batched_ref(c, dd, b, r)
        check(not bool(torch.isnan(got).any()) and zero_at(got, nan_in),
              f"tiered_cost_batched {dtype} on NaN hours: not +0.0")
        cum0 = c[:, 0].contiguous()
        cum0[::97] = float("nan")                    # NaN until the reset at hour 730
        sc, scum = tiered_cost_scan(cum0, dd, b, r, reset)
        wc, wcum = ref.tiered_cost_scan_ref(cum0, dd, b, r, reset)
        check(not bool(torch.isnan(sc).any()) and zero_at(sc, torch.isnan(dd))
              and zero_at(sc[::97, :730], torch.ones_like(sc[::97, :730], dtype=torch.bool)),
              f"tiered_cost_scan {dtype} on NaN hours: not +0.0")
        check(same_bits(scum, wcum), f"tiered_cost_scan {dtype} NaN rows: carry != plain")
        if dtype == torch.float64:
            check(same_bits(got, want), "tiered_cost_batched f64 NaN rows != plain")
            check(same_bits(sc, wc), "tiered_cost_scan f64 NaN rows != plain")
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(sc, wc, rtol=1e-6, atol=1e-6)
    K, t0 = STREAM_K, 720
    carry = torch.stack([cum[:, t0], torch.zeros_like(cum[:, t0])]).contiguous()
    carry[0, ::89] = float("nan")
    blk = d[:, t0:t0 + K].T.contiguous()
    blk[5, ::13] = float("nan")
    got, c_got = tiered_cost_calendar(carry, blk, *tab, t0, 730)
    want, c_want = ref.tiered_cost_calendar_ref(carry, blk, *tab, t0, 730)
    check(same_bits(got, want) and same_bits(c_got, c_want),
          "tiered_cost_scan calendar entry NaN rows != plain")
    check(not bool(torch.isnan(got).any()) and zero_at(got, torch.isnan(blk))
          and zero_at(got[:, ::89], torch.ones_like(got[:, ::89], dtype=torch.bool)),
          "tiered_cost_scan calendar entry on NaN hours: not +0.0")
    ct, dt = cum.T.float().contiguous(), d.T.float().contiguous()
    tier = AWS_EGRESS_INTERNET
    got = tiered_cost(ct, dt, tier.bounds_gb, tier.rates)
    want = ref.tiered_cost(ct, dt, tier.bounds_gb, tier.rates)
    check(same_bits(got, want) and torch.equal(torch.isnan(got), nan_in.T),
          "static tiered_cost NaN rows: != plain, or not NaN exactly on the NaN hours")
    print(f"tiered kernels on NaN hours ({TIER_NAN_CELLS} NaN month-to-date volumes and "
          f"{TIER_NAN_CELLS} NaN demands in {N} x {T}; NaN carries into the scan and the "
          f"calendar): tiered_cost_batched f64/f32 and tiered_cost_scan (month-to-date "
          f"f64/f32, calendar {N} x {K} from hour {t0}) == plain, those hours +0.0; static "
          f"tiered_cost {T} x {N} == plain, NaN exactly there (bit for bit, NaN-aware)")


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


FSM_EDGE_N = (1, 17, 128)
FSM_EDGE_T = (1, 63, 2001, 8760)


def fsm_edge_args(N: int, T: int, hold: int, device) -> list:
    """Seeded FSM inputs at an edge shape: windows from 1 hour to past T (h >=
    T never lags), hold counts 1 (reactive) or 1-6 (hysteresis), and, on the
    card, vpn/cci planes that start 8 bytes past a 16-byte boundary (odd T
    misaligns every other row as well)."""
    rng = np.random.default_rng(1000 * N + T)
    vpn = rng.uniform(5.0, 50.0, size=(N, T))
    regime = np.repeat(rng.uniform(0.6, 1.4, size=(N, T // 40 + 1)), 40, axis=1)[:, :T]
    cci = vpn * regime * rng.uniform(0.95, 1.05, size=(N, T))
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    rows = [f64(rng.uniform(0.85, 0.95, N)), f64(rng.uniform(1.05, 1.2, N)),
            i32(1 + (np.arange(N) * (T + 2)) // max(N - 1, 1)),
            i32(np.resize([0, 3, 10, 0], N)), i32(np.resize([1, 5, 24, 1, 12], N))]
    if hold == 1:
        rows += [i32(np.ones(N)), i32(np.ones(N))]
    else:
        rows += [i32(np.resize([1, 2, 3, 6], N)), i32(np.resize([6, 1, 4], N))]

    def plane(a):
        buf = torch.zeros(N * T + 1, dtype=torch.float64, device=device)
        view = buf[1:].view(N, T)
        view.copy_(f64(a))
        return view

    return [plane(vpn), plane(cci)] + rows


def fsm_edge_checks() -> int:
    """``fsm_scan`` at the edge shapes of its staged tiles, both policies and
    both renewal rules: every output bit-equal to the plain version on the
    CPU, and x/state equal (total_cost to 1e-12) to the plain version on the
    card. Returns the number of cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fsm_scan import fsm_scan

    cases = 0
    for N in FSM_EDGE_N:
        for T in FSM_EDGE_T:
            for hold in (1, 6):
                args = fsm_edge_args(N, T, hold, DEVICE)
                check(args[0].data_ptr() % 16 == 8, "edge planes not misaligned")
                cpu_args = [a.cpu() for a in args]
                for renew in (False, True):
                    got = fsm_scan(*args, renew_in_chunks=renew)
                    cpu = ref.fsm_scan_ref(*cpu_args, renew_in_chunks=renew)
                    for k in ("x", "state", "total_cost"):
                        check(torch.equal(got[k].cpu(), cpu[k]), f"fsm_scan {N} x {T} hold "
                              f"{hold} renew={renew}: {k} != the CPU plain version")
                    card = ref.fsm_scan_ref(*args, renew_in_chunks=renew)
                    check(torch.equal(got["x"], card["x"]) and torch.equal(got["state"],
                                                                            card["state"]),
                          f"fsm_scan {N} x {T} hold {hold} renew={renew}: decisions != the "
                          f"plain version on the card")
                    torch.testing.assert_close(got["total_cost"], card["total_cost"],
                                               rtol=1e-12, atol=0)
                    cases += 1
    return cases


# -- the topology slice -------------------------------------------------------
TOPO_PAIRS = 2048                       # plan_fleet's 2048 x 8760 year ...
TOPO_KW = dict(n_facilities=32, ports_per_facility=4, reach=2)   # ... on 128 shared ports
TOPO_HOURS = 8760
LEG_CHECK = (2048, 8760, 128, 6144)     # P, T, M, E of the kernel-vs-plain check
SAVINGS_HOURS = 1200                    # relay and multicast scenarios
SAVINGS_WANT = {"relay_savings": 0.3785, "tree_sharing_savings": 0.1101}
RELAY_SWITCH = 600                      # replay: direct, then the relay from this hour


def leg_segment_bound(P: int, T: int, M: int, E: int, planes: int) -> dict:
    # source planes, weights and the leg list (leg_pair, order, start) read
    # once, the port planes written once; a product and an add a leg and hour.
    bytes_moved = planes * (P * T + M * T + E) * 8 + (2 * E + M + 1) * 4
    ops = planes * E * T * 2
    return bound(bytes_moved, ops, torch.float64)


def leg_check(P: int, T: int, M: int, E: int) -> None:
    """``leg_segment_sum`` against its plain version on the card, every bit,
    on seeded leg lists of 1-, 2- and 3-hop rows padded to E legs, with a NaN
    and an inf hour in row 0 (the padding legs' row) and -0.0 sources."""
    from repro_torch.fleet import RoutingPlan
    from repro_torch.kernels import ops, ref

    rng = np.random.default_rng(SEED)
    paths = tuple(tuple(rng.choice(M, size=int(rng.integers(1, 4)), replace=False).tolist())
                  for _ in range(P))
    plan = RoutingPlan(paths=paths, n_ports=M)
    check(plan.total_hops < E, f"leg check: {plan.total_hops} legs do not fit {E}")
    op = plan.pad_to(E).operand(torch.float64, DEVICE)
    src = torch.tensor(rng.normal(scale=100.0, size=(2, P, T)), device=DEVICE)
    src[:, 0, 3], src[:, 0, 5], src[:, 1, 7], src[:, 2, :4] = float("nan"), float("inf"), -0.0, -0.0
    ws = (op.vpn_w, op.attach_w)
    got = ops.leg_segment_sum((src[0], src[1]), op.leg_pair, op.leg_port, ws, M,
                              index=(op.index.order, op.index.start))
    for s_, w, g in zip(src, ws, got):
        want = ref.leg_segment_sum_ref(s_, op.leg_pair, op.leg_port, w, M)
        check(same_bits(g, want), "leg_segment_sum != plain on the seeded leg list")
    check(bool(torch.isnan(got[0][0, 3])), "padding legs lost row 0's NaN on port 0")
    hops = np.bincount([len(p) for p in paths], minlength=4)[1:].tolist()
    print(f"leg_segment_sum {P} x {T} -> {M} ports, {E} legs ({plan.total_hops} routed, rows "
          f"of 1/2/3 hops {hops}, {E - plan.total_hops} padding), NaN/inf in row 0, -0.0 "
          f"sources, both planes in one launch: every bit == plain on the card")


def topology_phase(card: str, fleet_scen) -> dict:
    """The topology slice on the card: ``plan_topology`` of the 2048-pair,
    128-port year through the entry point with launches counted, against
    the numpy reference and the CPU path; padding and the identity topology
    bit for bit; ``leg_segment_sum`` against its plain version;
    ``refine_routing`` and ``replay_plan_topology`` on the relay scenario;
    then timings. Returns the kernel's row and the scenarios, routing and
    plans the later phases reuse."""
    from repro_torch.fleet import (
        build_multicast_scenario,
        build_relay_scenario,
        build_topology_scenario,
        identity_topology,
        optimize_routing,
        plan_fleet,
        plan_topology,
        plan_topology_reference,
        refine_routing,
        replay_plan_topology,
    )
    from repro_torch.fleet.engine import _pair_stage
    from repro_torch.kernels import ops, ref

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sc = build_topology_scenario(TOPO_PAIRS, **TOPO_KW, horizon=TOPO_HOURS, seed=SEED)
    P, T, M = sc.n_pairs, TOPO_HOURS, sc.n_ports
    print(f"topology scenario {P} pairs x {T} h, {M} ports: {time.perf_counter() - t0:.2f} s "
          f"on the host")

    # -- the main path: routing=None routes on the host, then plans ---------
    ops.reset_launches()
    t0 = time.perf_counter()
    plan = plan_topology(sc.topo, sc.demand)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"topology main path launches per plan: "
          f"{ {k: v for k, v in launches.items() if v} } (first plan {first_s:.2f} s, "
          f"optimize_routing on the host included)")
    for name in ("tiered_cost_batched", "leg_segment_sum", "fsm_scan"):
        check(launches[name] >= 1, f"kernel {name} was not launched on the topology path")
    t0 = time.perf_counter()
    routing = optimize_routing(sc.topo, sc.demand)
    route_s = time.perf_counter() - t0
    used = len(routing.ports_used())
    print(f"optimize_routing: {route_s:.3f} s on the host; {routing.total_hops} legs on {used} "
          f"of {M} ports, hop depth {routing.hop_depth}")
    check(plan["x"].shape == (M, T) and plan["x"].device.type == DEVICE.type,
          f"topology plan: shape {tuple(plan['x'].shape)} on {plan['x'].device}")
    for k in ("toggle_cost", "static_vpn", "static_cci", "vpn_hourly", "cci_hourly"):
        check(bool(torch.isfinite(plan[k]).all()), f"topology plan: {k} not finite")
    check(int(plan["n_pairs"].sum().item()) == routing.total_hops, "n_pairs != routed legs")

    t0 = time.perf_counter()
    want = plan_topology_reference(sc.topo, sc.demand, routing)
    for k in ("x", "state"):
        check(np.array_equal(plan[k].cpu().numpy(), want[k]),
              f"topology plan: {k} differs from plan_topology_reference")
    check(np.allclose(plan["toggle_cost"].cpu().numpy(), want["toggle_cost"], rtol=1e-9, atol=0),
          "topology toggle cost vs plan_topology_reference")
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = plan_topology(sc.topo, sc.demand, routing=routing, device="cpu")
    for k in ("x", "state", "n_pairs", "pair_demand"):
        check(torch.equal(plan[k].cpu(), cpu[k]), f"topology plan: {k} CUDA != CPU")
    for k in ("toggle_cost", "static_vpn", "static_cci", "vpn_hourly", "cci_hourly",
              "port_demand"):
        torch.testing.assert_close(plan[k].cpu(), cpu[k], rtol=1e-9, atol=0)
    print(f"topology {P} x {T}: CUDA plan == numpy per-port reference in x/state, toggle cost "
          f"rtol 1e-9 ({ref_s:.1f} s); == CPU plan, decisions equal, costs rtol 1e-9 "
          f"({time.perf_counter() - t0:.1f} s); CCI share "
          f"{plan['x'].double().mean().item():.4f}, toggle/static_vpn "
          f"{(plan['toggle_cost'].sum() / plan['static_vpn'].sum()).item():.6f}")

    # -- padding legs and the identity topology, bit for bit ----------------
    padded = plan_topology(sc.topo, sc.demand, routing=routing.pad_to(routing.total_hops + 64))
    for k in plan:
        check(same_bits(padded[k], plan[k]), f"padded routing changed {k}")
    itopo, iplan = identity_topology(fleet_scen.fleet)
    got = plan_topology(itopo, fleet_scen.demand, routing=iplan)
    fl = plan_fleet(fleet_scen.fleet, fleet_scen.demand)
    for k in got:
        check(same_bits(got[k], fl[k]), f"identity topology != plan_fleet in {k}")
    print(f"routing padded by 64 legs == unpadded, every output bit; identity topology of the "
          f"{fleet_scen.n_links}-link fleet == plan_fleet, every output bit")

    leg_check(*LEG_CHECK)

    # -- relay and multicast economics, refine, replay ----------------------
    relay = build_relay_scenario(horizon=SAVINGS_HOURS, seed=SEED)
    mcast = build_multicast_scenario(n_leaves=4, horizon=SAVINGS_HOURS, seed=SEED)
    ops.reset_launches()
    start = optimize_routing(relay.topo, relay.demand, max_hops=1)
    refined, info = refine_routing(relay.topo, relay.demand, start)
    check(info["move_mix"]["relay"] >= 1 and info["cost_after"] < info["cost_before"],
          f"refine_routing applied no relay move: {info['move_mix']}")
    check(ops.LAUNCHES["fsm_scan"] >= 1, "refine_routing did not run fsm_scan")
    print(f"refine_routing from the 1-hop routing: moves {info['move_mix']}, cost "
          f"{info['cost_before']:.2f} -> {info['cost_after']:.2f}, {ops.LAUNCHES['fsm_scan']} "
          f"fsm_scan launches; paths {refined.paths}")
    relay_plan = optimize_routing(relay.topo, relay.demand)
    arr = relay.topo.stack(relay_plan, torch.float64, DEVICE)
    one, full = replay_plan_topology(arr, relay.demand, [(0, relay_plan)]), plan_topology(
        arr, relay.demand)
    for k in one:
        check(same_bits(one[k], full[k]), f"one-segment replay != plan_topology in {k}")
    sched = [(0, start), (RELAY_SWITCH, relay_plan)]
    g2 = replay_plan_topology(arr, relay.demand, sched)
    c2 = replay_plan_topology(arr, relay.demand, sched, device="cpu")
    for k in ("x", "state"):
        check(torch.equal(g2[k].cpu(), c2[k]), f"two-segment replay: {k} CUDA != CPU")
    for k in ("toggle_cost", "vpn_hourly", "cci_hourly"):
        torch.testing.assert_close(g2[k].cpu(), c2[k], rtol=1e-9, atol=0)
    print(f"replay: one segment == plan_topology, every bit; direct then relay from hour "
          f"{RELAY_SWITCH}: CUDA == CPU (decisions equal, costs rtol 1e-9), cost "
          f"{g2['toggle_cost'].sum().item():.2f} vs relay all along "
          f"{full['toggle_cost'].sum().item():.2f}")

    # -- the kernel at the main path's inputs, then timings -----------------
    arrays = sc.topo.stack(routing, torch.float64, DEVICE)
    demand = torch.as_tensor(sc.demand, dtype=torch.float64, device=DEVICE)
    d_pair, vpn_pair = _pair_stage(arrays, demand, hours_per_month=sc.topo.hours_per_month)
    op = arrays.routing
    E = op.n_legs
    planes, ws = (vpn_pair, d_pair), (op.vpn_w, op.attach_w)
    seg = lambda: ops.leg_segment_sum(planes, op.leg_pair, op.leg_port, ws, M,
                                      index=(op.index.order, op.index.start))
    plain = lambda: [ref.leg_segment_sum_ref(s_, op.leg_pair, op.leg_port, w, M)
                     for s_, w in zip(planes, ws)]
    lp64, lm64 = op.leg_pair.long(), op.leg_port.long()
    library = lambda: [torch.zeros((M, T), dtype=torch.float64, device=DEVICE).index_add_(
        0, lm64, s_[lp64] * w[:, None]) for s_, w in zip(planes, ws)]
    got, want, lib = seg(), plain(), library()
    err = 0.0
    for g, w_, l_ in zip(got, want, lib):
        check(same_bits(g, w_), "leg_segment_sum != plain at the main path's inputs")
        err = max(err, (g - l_).abs().max().item())
    check(same_bits(got[0], plan["vpn_hourly"]), "the kernel's VPN plane != the plan's")
    ops.reset_launches()
    plan_topology(arrays, demand)
    per_plan = {k: v for k, v in ops.LAUNCHES.items() if v}
    b = leg_segment_bound(P, T, M, E, 2)
    ms = kernel_device_ms(seg, 20, ["leg_segment_sum"], per_call=1)["leg_segment_sum"]
    ev_ms = queued_ms(seg, 20)
    plain_ms = sync_ms(plain, 2)
    lib_ms = device_busy_ms(library, 5)
    plan_ms = sync_ms(lambda: plan_topology(arrays, demand), 10)
    spec_ms = sync_ms(lambda: plan_topology(sc.topo, sc.demand, routing=routing), 3)
    print(f"timings on {card} (median ms)")
    print(f"  leg_segment_sum {P} x {T} -> {M} ports, {E} legs, both planes: kernel {ms:.4f} ms "
          f"(profiler device time; CUDA events queued behind a sleep {ev_ms:.4f}), plain "
          f"{plain_ms:.3f} ms, bound {b['bound_ms'] * 1e3:.1f} us ({b['bound_by']}), "
          f"{ms / b['bound_ms']:.2f}x bound; index_add_ both planes (gather and product "
          f"included) {lib_ms:.4f} ms of device time, max abs diff from the kernel {err:.3e}")
    print(f"  plan_topology {P} x {T} on {M} ports: {plan_ms:.3f} ms from arrays and demand on "
          f"the card; {spec_ms:.3f} ms from TopologySpec + numpy demand with the routing given "
          f"(stack + copy in); optimize_routing {route_s * 1e3:.1f} ms on the host; "
          f"launches/plan {per_plan}")
    print_breakdown(lambda: plan_topology(arrays, demand), reps=3)
    print(f"topology phase: {time.perf_counter() - t_phase:.1f} s")
    row = {"launches": launches["leg_segment_sum"], "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, **b, "library_ms": lib_ms}
    return row, {"scenario": sc, "routing": routing, "plan": plan, "cpu_plan": cpu,
                 "relay": relay, "multicast": mcast}


# -- the topology stream -------------------------------------------------------
REROUTE = dict(horizon=2000, shift_hour=800, seed=SEED)   # examples/reroute_demo.py's swap
REPACK_EVERY, REPACK_WINDOW = 24, 168                     # hours
NAN_PAD = 64                                              # padding legs of the NaN case
LEG_TILE = 128                                            # legs a tile of the port stage
# Pairs on 2 facilities x 2 ports, 200 h: the hottest port holds 76 legs (200
# pairs) or 165, two leg tiles (400 pairs).
HOT_PAIRS, HOT_KW = (200, 400), dict(n_facilities=2, ports_per_facility=2, horizon=200)


def routed_chunk_bound(P: int, M: int, K: int, Kt: int, E: int, endo: bool) -> dict:
    # In: the block (the demand (K, P), the CCI demand when endo, pre_v and pre_c
    # (K, M)); per pair capacity, L_vpn (f64) and the tier tables (P, Kt) x 2; per
    # port lease, c_cci, capacity, theta1, theta2 (f64) and h, D, T_cci and the two
    # holds (int32); the legs (leg_pair, order int32; vpn_w, attach_w f64) and the
    # (M + 1,) offsets; the carries (cal (2, P), pref (2, M) f64; fsm (4, M) int32).
    # Out: the flat result (8KM + 2P + 2M f64) and the FSM carry (4, M) int32. The
    # kernel's (2, K, P) scratch is its own traffic, not the function's.
    bytes_moved = (8 * ((2 if endo else 1) * K * P + 2 * K * M) + 8 * (2 * P + 2 * P * Kt)
                   + M * (8 * 5 + 4 * 5) + E * (4 + 4 + 8 + 8) + 4 * (M + 1)
                   + 8 * (2 * P + 2 * M) + 4 * 4 * M + 8 * (8 * K * M + 2 * P + 2 * M)
                   + 4 * 4 * M)
    # Per pair-hour: the clips, month sub, carry add, hi add, per tier 6, the VPN
    # add; per leg-hour: 2 products and 2 adds; per port-hour: min, mul, add (CCI),
    # 2 prefix adds, 2 window subs, 2 muls, 2 compares.
    ops = K * P * ((2 if endo else 1) + 3 + 6 * Kt + 1) + K * E * 4 + K * M * 11
    return bound(bytes_moved, ops, torch.float64)


def repack_stream(sc, *, live: bool, device=None):
    """``examples/reroute_demo.py``'s two runs, in ``step_many`` chunks of
    REPACK_EVERY hours: the routing of the first week's demand, frozen, or
    re-packed at every chunk boundary on the trailing REPACK_WINDOW-hour means
    and swapped in with ``reroute()`` when it changes. Returns (summed cost,
    stacked outputs, the schedule of routings)."""
    from repro_torch.fleet import FleetRuntime, optimize_routing

    r0 = optimize_routing(sc.topo, sc.demand[:, :REPACK_WINDOW])
    rt = FleetRuntime(sc.topo, routing=r0, device=device)
    T = sc.demand.shape[1]
    cost, schedule, outs, t = 0.0, [(0, r0)], [], 0
    while t < T:
        if live and t > 0:
            seen = sc.demand[:, max(0, t - REPACK_WINDOW):t].mean(axis=1)
            r_new = optimize_routing(sc.topo, mean_demand=seen)
            if not np.array_equal(r_new.primary, rt.routing_plan.primary):
                rt.reroute(r_new)
                schedule.append((t, r_new))
        k = min(REPACK_EVERY, T - t)
        outs.append(rt.step_many(sc.demand[:, t:t + k]))
        cost += float(outs[-1]["cost"].sum())
        t += k
    return cost, {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}, schedule


def topology_stream_phase(card: str, topo_ctx: dict) -> dict:
    """The streaming runtime's topology mode on the card: the 2048-pair,
    128-port year streamed with launches counted, against the CPU
    ``plan_topology``; ``stream_chunk_routed`` against its plain version on
    the listed cases; the re-routing scenario against the replay oracle;
    then timings. Returns the kernel's row."""
    from repro_torch.fleet import (
        FleetRuntime,
        build_reroute_scenario,
        build_topology_scenario,
        optimize_routing,
        replay_plan_topology,
    )
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stream_chunk import stream_chunk_routed

    sc, routing, cpu = topo_ctx["scenario"], topo_ctx["routing"], topo_ctx["cpu_plan"]
    P, M, T = sc.n_pairs, sc.n_ports, sc.demand.shape[1]
    fields = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
    t_phase = time.perf_counter()

    # -- the main path: FleetRuntime in topology mode, launches counted -----
    ops.reset_launches()
    rt = FleetRuntime(sc.topo, routing=routing)
    check(rt.device.type == DEVICE.type and rt.topology,
          "FleetRuntime(topo, routing=) did not stream topology mode on the card")
    chunk_clock = []
    chunked = stream(rt, sc.demand, STREAM_K, chunk_clock)
    chunk_s = sum(chunk_clock)
    rt_tick = FleetRuntime(sc.topo, routing=routing)
    tick_us, ticks = [], []
    t0 = time.perf_counter()
    for t in range(STREAM_TICKS):
        a = time.perf_counter()
        ticks.append(rt_tick.step(sc.demand[:, t]))
        tick_us.append((time.perf_counter() - a) * 1e6)
    tick_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"topology streaming path launches: { {k: v for k, v in launches.items() if v} }")
    want_launches = T // STREAM_K + T % STREAM_K + STREAM_TICKS
    check(launches["stream_chunk_routed"] == want_launches,
          f"stream_chunk_routed launched {launches['stream_chunk_routed']} times on the "
          f"topology streaming path, not once per chunk and tick ({want_launches})")
    for name in ("stream_chunk", "leg_segment_sum", "tiered_cost_scan", "fsm_chunk"):
        check(launches[name] == 0, f"kernel {name} launched on the topology streaming path")

    # -- checks -----------------------------------------------------------------
    for k, want in (("x", cpu["x"]), ("state", cpu["state"]),
                    ("vpn_cost", cpu["vpn_hourly"]), ("cci_cost", cpu["cci_hourly"])):
        check(chunked[k].shape == (M, T), f"topology stream {k} shape {chunked[k].shape}")
        check(np.array_equal(chunked[k], want.numpy()),
              f"{P}-pair topology stream on the card: {k} != CPU plan_topology")
    print(f"topology stream {P} pairs x {T} h on {M} ports (K = {STREAM_K}) on the card == CPU "
          f"plan_topology bit for bit in x/state/vpn_cost/cci_cost; CCI share "
          f"{chunked['x'].mean():.4f}")
    for k in fields:
        check(np.array_equal(np.stack([o[k] for o in ticks], 1), chunked[k][:, :STREAM_TICKS]),
              f"topology per-tick step != chunked step_many in {k}")
    print(f"per-tick step over hours 0..{STREAM_TICKS - 1} == chunked stream bit for bit "
          f"(all {len(fields)} fields; crosses the month start at hour 730)")

    # -- stream_chunk_routed against its plain version, every output bit ------
    t_cases = time.perf_counter()
    relay, mcast = topo_ctx["relay"], topo_ctx["multicast"]
    relay_plan = optimize_routing(relay.topo, relay.demand)
    t_first = 696                                           # crosses the month start at 730
    bad = sc.demand.copy()
    bad[0, [t_first - 30, t_first + 3, t_first + 10]] = np.nan
    padded = routing.pad_to(routing.total_hops + NAN_PAD)
    port_legs = lambda r, n: np.bincount([m for path in r.paths for m in path], minlength=n)
    hot_cases = {}
    for n in HOT_PAIRS:
        hot = build_topology_scenario(n, **HOT_KW, seed=SEED)
        hot_plan = optimize_routing(hot.topo, hot.demand)
        hot_legs = port_legs(hot_plan, hot.n_ports).max()
        hot_cases[f"a {hot_legs}-leg port ({n} pairs on {hot.n_ports} ports), K = {STREAM_K}, "
                  f"1, 33 from hour 48"] = (hot.topo, hot_plan, hot.demand, 48,
                                            [STREAM_K, 1, 33], None)
    check(hot_legs > LEG_TILE, f"the hot-port cases' largest port holds {hot_legs} legs, "
          f"one {LEG_TILE}-leg tile")
    legs = port_legs(routing, M)
    check(legs.min() == 0, "the cell's routing leaves no port without legs")
    cases = {
        f"relay (1- and 2-hop rows, 3 padding legs), 3 x K = {STREAM_K}":
            (relay.topo, relay_plan.pad_to(relay_plan.total_hops + 3), relay.demand, 48,
             [STREAM_K] * 3, None),
        f"multicast tree, 3 x K = {STREAM_K}":
            (mcast.topo, optimize_routing(mcast.topo, mcast.demand), mcast.demand, 48,
             [STREAM_K] * 3, None),
        f"NaN demand in pair 0, {NAN_PAD} padding legs, 2 x K = {STREAM_K}":
            (sc.topo, padded, bad, t_first, [STREAM_K] * 2, None),
        "K = 1 over hours 728..731": (sc.topo, routing, sc.demand, 728, [1] * 4, None),
        f"4 chained K = {STREAM_K} from hour {t_first}":
            (sc.topo, routing, sc.demand, t_first, [STREAM_K] * 4, None),
        f"K = {rt.hbuf + 23} (past the ring, hbuf {rt.hbuf}) from hour 500":
            (sc.topo, routing, sc.demand, 500, [rt.hbuf + 23], None),
        f"endogenous CCI demand, 2 x K = {STREAM_K}":
            (sc.topo, routing, sc.demand, t_first, [STREAM_K] * 2, sc.demand * 1.5),
        **hot_cases,
        f"the cell's routing over {HOT_KW['horizon']} h ({int((legs == 0).sum())} ports "
        f"with no legs, a {legs.max()}-leg port), K = {STREAM_K}, 5 from hour 48":
            (sc.topo, routing, sc.demand[:, :HOT_KW["horizon"]], 48, [STREAM_K, 5], None),
    }
    routed_err = 0.0
    for label, (topo_, r_, d_, t_, Ks, c_) in cases.items():
        routed_err = max(routed_err, chunk_case(topo_, d_, t_, Ks, c_, routing=r_))
        print(f"  stream_chunk_routed == stream_chunk_routed_ref, every output bit: {label}")
    check(0 not in routing.paths[0], "the NaN case needs pair 0 off port 0")
    print(f"stream_chunk_routed: {len(cases)} cases equal the plain version on the card "
          f"({time.perf_counter() - t_cases:.1f} s)")

    # -- live re-routing: frozen vs re-packed, against the replay oracle ------
    t0 = time.perf_counter()
    rsc = build_reroute_scenario(**REROUTE)
    frozen, _, _ = repack_stream(rsc, live=False)
    live, live_out, schedule = repack_stream(rsc, live=True)
    check(live < frozen and len(schedule) > 1,
          f"live re-routing ({live:.2f}) did not beat the frozen routing ({frozen:.2f})")
    arrays = rsc.topo.stack(schedule[0][1], torch.float64, DEVICE)
    hpm = rsc.topo.hours_per_month
    for dev in (DEVICE, "cpu"):
        rep = replay_plan_topology(arrays, rsc.demand, schedule, hours_per_month=hpm, device=dev)
        for k in ("x", "state"):
            check(np.array_equal(live_out[k], rep[k].cpu().numpy()),
                  f"live re-routing: {k} != replay_plan_topology on {dev}")
    cpu_live = repack_stream(rsc, live=True, device="cpu")[0]
    check(abs(live - cpu_live) <= 1e-12 * abs(cpu_live), f"live cost card {live!r} != CPU "
          f"{cpu_live!r}")
    saving = 1.0 - live / frozen
    print(f"re-routing {REROUTE}: frozen ${frozen:,.2f}, live ${live:,.2f} (swaps at hours "
          f"{[t for t, _ in schedule[1:]]}), saving {saving:.5f}; live decisions == "
          f"replay_plan_topology on the card and the CPU; live cost card == CPU "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- timings ----------------------------------------------------------------
    print(f"topology streaming timings on {card} (median ms; bound = max(bytes / 3.35 TB/s, "
          f"ops / peak))")
    tick = np.array(tick_us)
    print(f"  per-tick step {P} pairs on {M} ports: p50 {np.percentile(tick, 50):.1f} us, p95 "
          f"{np.percentile(tick, 95):.1f} us, p99 {np.percentile(tick, 99):.1f} us; "
          f"{P * STREAM_TICKS / tick_s:.4g} pair-steps/s over {STREAM_TICKS} hours")
    chunk_ms = np.array(chunk_clock) * 1e3
    print(f"  chunked step_many {P} x {T} (K = {STREAM_K}): p50 {np.percentile(chunk_ms, 50):.3f} "
          f"ms, p95 {np.percentile(chunk_ms, 95):.3f} ms, mean {chunk_ms.mean():.3f} ms per "
          f"chunk; {P * T / chunk_s:.4g} pair-steps/s; {chunk_s:.3f} s in step_many for the "
          f"year (output stacking not counted)")
    rt_b = FleetRuntime(sc.topo, routing=routing)
    stream(rt_b, sc.demand[:, :t_first], STREAM_K)
    Kt = rt_b.arrays.tier_bounds.shape[1]
    E = rt_b.arrays.routing.n_legs
    timing = {}
    for K in (STREAM_K, 1):
        block, _, _ = rt_b._pack(sc.demand[:, t_first:t_first + K], None)
        dev_block = torch.from_numpy(block).to(DEVICE)
        args = rt_b._chunk_args(dev_block, K, False)
        renew = rt_b.policy.renew_in_chunks
        fused = lambda: stream_chunk_routed(*args, renew_in_chunks=renew)
        plain = lambda: ref.stream_chunk_routed_ref(*args, renew_in_chunks=renew)
        check(same_bits(fused()[0], plain()[0]), f"K = {K}: kernel != plain at the timed block")
        dev = kernel_device_ms(fused, 20, ("routed_pair_kernel", "routed_port_kernel"),
                               per_call=1)
        b_k = routed_chunk_bound(P, M, K, Kt, E, False)
        timing[K] = {"ms": dev["routed_pair_kernel"] + dev["routed_port_kernel"],
                     "pair_ms": dev["routed_pair_kernel"], "port_ms": dev["routed_port_kernel"],
                     "queued_ms": queued_ms(fused, 50), "event_ms": event_ms(fused, 50),
                     "plain_ms": sync_ms(plain, 3), **b_k}
        tk = timing[K]
        print(f"  stream_chunk_routed {P} pairs x K={K} on {M} ports, {E} legs: profiler device "
              f"time {tk['ms']:.4f} ms (pair stage {tk['pair_ms']:.4f}, port stage "
              f"{tk['port_ms']:.4f}), CUDA events behind a queue {tk['queued_ms']:.4f} ms, "
              f"events around one call (host launch included) {tk['event_ms']:.4f} ms; bound "
              f"{tk['bound_ms'] * 1e3:.3f} us ({tk['bound_by']}), {tk['ms'] / tk['bound_ms']:.1f}x "
              f"bound; plain {tk['plain_ms']:.3f} ms")
    print_step_split(rt_b, sc.demand, t_first, f"{P} pairs")
    blk = sc.demand[:, t_first:t_first + STREAM_K]
    print_breakdown(lambda: rt_b.step_many(blk), reps=6, unit="chunk")
    print(f"topology streaming phase: {time.perf_counter() - t_phase:.1f} s")
    t24 = timing[STREAM_K]
    return {"launches": launches["stream_chunk_routed"], "max_abs_err": routed_err,
            "ms": t24["ms"], "plain_ms": t24["plain_ms"], "bound_ms": t24["bound_ms"],
            "bound_by": t24["bound_by"], "library_ms": None, "main_path": True}


# -- the evaluation: reports and the offline oracle ----------------------------
ORACLE_CPU_ROWS = 64       # links held against the plain version on the CPU
ORACLE_NUMPY_ROWS = 4      # ... and against the scalar numpy DP
OPT_SLACK = 1e-9           # OPT <= ToggleCCI and <= best static, up to this relative slack
ORACLE_PAST_ROWS = 256     # links of the batch past the register form ...
ORACLE_PAST_TCCI = 600     # ... half of them with this commitment (K1 = 19 > 12)


def oracle_work(D: np.ndarray, T_cci: np.ndarray, T: int):
    """(bytes, operations) of the offline DP over N rows and T hours: vpn,
    cci read once (f64), D, T_cci read (int32), total (f64) and start_on
    (bool) written; per row-hour one add a state (D + T_cci + 2) plus the
    request and release adds and the two comparisons."""
    N = len(D)
    bytes_moved = 2 * N * T * 8 + N * (4 + 4 + 8 + 1)
    ops = int(np.sum(D.astype(np.int64) + T_cci + 2 + 4)) * T
    return bytes_moved, ops


def oracle_bound(D: np.ndarray, T_cci: np.ndarray, T: int) -> dict:
    """``bound`` with the DP's adds and compares over F64_LANE_OPS_PER_S:
    each is one float64 lane-operation, not half of a counted FMA."""
    bytes_moved, ops = oracle_work(D, T_cci, T)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F64_LANE_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ptxas_report(kernel: str) -> dict:
    """Registers, stack frame and spill bytes ``-Xptxas -v`` gave the entry
    function whose name holds ``kernel`` in the last build."""
    import re
    from repro_torch.kernels import _lib

    out, name = {}, ""
    for line in _lib.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif kernel in name:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                out.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m[1])
    check(len(out) == 4, f"no ptxas report for {kernel} in the build log")
    return out


def report_phase(card: str, fleet_scen, fleet_plan, topo_ctx: dict) -> dict:
    """The paper's evaluation on the card: ``build_report`` of the 2048-link
    year with the OPT column and ``build_topology_report`` of the relay and
    multicast scenarios and of the 2048-pair year with the oracle, each
    driven with launches counted; ``oracle_dp`` against its plain version
    and the numpy DP; OPT below ToggleCCI and the best static policy; the
    savings card == CPU; then timings. Returns the kernel's row."""
    from repro_torch.core.costmodel import HourlyCosts
    from repro_torch.core.oracle import offline_optimal
    from repro_torch.fleet import (
        build_report,
        build_topology_report,
        optimize_routing,
        plan_topology,
        topology_port_costs_reference,
    )
    from repro_torch.fleet.engine import _fleet_cost_planes
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.oracle_dp import launch_plan
    from repro_torch.kernels.oracle_dp import oracle_dp as oracle_kernel

    t_phase = time.perf_counter()
    fleet, demand = fleet_scen.fleet, fleet_scen.demand
    N, T = demand.shape
    launches = 0

    # -- the fleet report, launches counted ---------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = build_report(fleet_scen, fleet_plan, include_oracle=True)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(counts == {"oracle_dp": 1}, f"build_report launched {counts}, not one oracle_dp")
    launches += counts["oracle_dp"]
    opt = np.array([link.oracle_cost for link in rep.links])
    tog = np.array([link.toggle_cost for link in rep.links])
    best = np.array([link.best_static for link in rep.links])
    check(len(rep.links) == N and bool(np.isfinite(opt).all()), "fleet report: OPT not finite")
    check(bool((opt <= tog * (1 + OPT_SLACK)).all()), "fleet report: OPT above ToggleCCI")
    check(bool((opt <= best * (1 + OPT_SLACK)).all()), "fleet report: OPT above best static")
    t = rep.totals
    print(f"fleet report {N} x {T} with the OPT column: {report_s:.3f} s wall, launches {counts}; "
          f"portfolio ToggleCCI ${t['togglecci']:.2f}, best static per link "
          f"${t['best_static_per_link']:.2f}, oracle ${t['oracle']:.2f} (ToggleCCI / OPT "
          f"{t['togglecci'] / t['oracle']:.4f}, vs best static "
          f"{100 * (1 - t['togglecci'] / t['best_static_per_link']):+.2f}%); OPT <= ToggleCCI "
          f"and <= best static on all {N} links")

    # -- fleet_oracle's host split, and the kernel at its inputs -------------
    t0 = time.perf_counter()
    vpn, cci = _fleet_cost_planes(fleet, demand)
    t1 = time.perf_counter()
    D = np.array([link.params.D for link in fleet.links], np.int32)
    Tc = np.array([link.params.T_cci for link in fleet.links], np.int32)
    args = [torch.from_numpy(a).to(DEVICE) for a in (vpn, cci, D, Tc)]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    total, start_on = ops.oracle_dp(*args)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    host_total = total.cpu().numpy()
    t4 = time.perf_counter()
    check(host_total.tobytes() == opt.tobytes(), "oracle_dp at the report's inputs != its OPT")
    print(f"  fleet_oracle host split, host clock: cost series {1e3 * (t1 - t0):.1f} ms, copy in "
          f"({(vpn.nbytes + cci.nbytes) / 1e6:.0f} MB) {1e3 * (t2 - t1):.1f} ms, launch and wait "
          f"{1e3 * (t3 - t2):.2f} ms, copy out {1e3 * (t4 - t3):.2f} ms; {int(start_on.sum())} "
          f"links start ON; states a row {int(D.min() + Tc.min() + 2)}-"
          f"{int((D + Tc).max() + 2)}, mean {float(np.mean(D + Tc + 2)):.1f}")
    t0 = time.perf_counter()
    want, want_on = ref.oracle_dp_ref(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(total, want) and torch.equal(start_on, want_on),
          "oracle_dp != plain on the card at the fleet year")
    cpu_args = [torch.from_numpy(a[:ORACLE_CPU_ROWS]) for a in (vpn, cci, D, Tc)]
    t0 = time.perf_counter()
    cpu_total, cpu_on = ref.oracle_dp_ref(*cpu_args)
    cpu_s = time.perf_counter() - t0
    check(same_bits(total[:ORACLE_CPU_ROWS].cpu(), cpu_total)
          and torch.equal(start_on[:ORACLE_CPU_ROWS].cpu(), cpu_on),
          f"oracle_dp != plain on the CPU on the first {ORACLE_CPU_ROWS} links")
    z = np.zeros(T)
    numpy_s = []
    for i in range(ORACLE_NUMPY_ROWS):
        t0 = time.perf_counter()
        r = offline_optimal(fleet.links[i].params, costs=HourlyCosts(z, vpn[i], z, cci[i]))
        numpy_s.append(time.perf_counter() - t0)
        check(np.float64(r.total_cost).tobytes() == host_total[i:i + 1].tobytes()
              and r.start_on == bool(start_on[i]), f"oracle_dp != offline_optimal on link {i}")
    err = (total - want).abs().max().item()
    print(f"oracle_dp {N} x {T}: every bit == plain on the card, == plain on the CPU on "
          f"{ORACLE_CPU_ROWS} links ({cpu_s:.1f} s), == numpy offline_optimal on "
          f"{ORACLE_NUMPY_ROWS} links (one link {statistics.median(numpy_s):.3f} s on the host, "
          f"so ~{statistics.median(numpy_s) * N / 60:.1f} min for the fleet)")

    # -- both forms against the plain version on the card ----------------------
    ptx = ptxas_report("oracle_dp_rows_kernel")
    print(f"  oracle_dp register form (oracle_dp_rows_kernel), -Xptxas -v: {ptx['registers']} "
          f"registers, {ptx['stack']} bytes stack frame, {ptx['spill_stores']} bytes spill "
          f"stores, {ptx['spill_loads']} bytes spill loads")
    check(ptx["stack"] == ptx["spill_stores"] == ptx["spill_loads"] == 0,
          "the register form spills or keeps a stack frame (local memory)")
    plan = launch_plan(args[2], args[3])
    check(not bool(plan.large.any()), "a fleet link took the large-row form")
    for form in ("register", "large"):
        before = ops.LAUNCHES["oracle_dp"]
        got, got_on = oracle_kernel(*args, form=form)
        check(ops.LAUNCHES["oracle_dp"] == before + 1, f"form {form}: not one launch")
        check(same_bits(got, want) and torch.equal(got_on, want_on),
              f"oracle_dp {form} form != plain on the card at the fleet year")
    past = [a[:ORACLE_PAST_ROWS].clone() for a in args]
    past[3][:ORACLE_PAST_ROWS // 2] = ORACLE_PAST_TCCI
    n_large = int(launch_plan(past[2], past[3]).large.sum())
    check(n_large == ORACLE_PAST_ROWS // 2, f"{n_large} rows past the register form")
    t0 = time.perf_counter()
    want_past, want_past_on = ref.oracle_dp_ref(*past)
    torch.cuda.synchronize()
    past_plain_s = time.perf_counter() - t0
    for form, n_launch in (("auto", 2), ("large", 1)):
        before = ops.LAUNCHES["oracle_dp"]
        got, got_on = oracle_kernel(*past, form=form)
        check(ops.LAUNCHES["oracle_dp"] == before + n_launch, f"form {form}: launches")
        check(same_bits(got, want_past) and torch.equal(got_on, want_past_on),
              f"oracle_dp {form} form != plain on the card past the register form")
    try:
        oracle_kernel(*past, form="register")
        check(False, "the register form took rows past its largest instance")
    except ValueError:
        pass
    print(f"oracle_dp forms: register and large-row each == plain on the card at {N} x {T}, "
          f"one launch each; {ORACLE_PAST_ROWS} links x {T} with {n_large} at T_cci = "
          f"{ORACLE_PAST_TCCI}: auto (both forms, two launches) and large-row == plain on "
          f"the card ({past_plain_s:.1f} s), register refused")

    # -- topology reports: the savings, then the 2048-pair year with the oracle
    for name in ("relay", "multicast"):
        sc = topo_ctx[name]
        routing = optimize_routing(sc.topo, sc.demand)
        ops.reset_launches()
        t0 = time.perf_counter()
        plan = plan_topology(sc.topo, sc.demand, routing=routing)
        got = build_topology_report(sc, plan, routing).totals
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(counts.get("fsm_scan", 0) >= 3, f"{name} report: replans launched {counts}")
        cpu = plan_topology(sc.topo, sc.demand, routing=routing, device="cpu")
        want = build_topology_report(sc, cpu, routing, device="cpu").totals
        k = "relay_savings" if name == "relay" else "tree_sharing_savings"
        v = got[k]
        check(abs(v - want[k]) <= 1e-12 * abs(want[k]), f"{k}: card {v!r} != CPU {want[k]!r}")
        check(abs(v - SAVINGS_WANT[k]) < 1e-4, f"{k} {v:.5f}, not {SAVINGS_WANT[k]}")
        print(f"{name} report {SAVINGS_HOURS} h: {k} {v!r} (card == CPU within rtol 1e-12), "
              f"lease_sharing_savings {got['lease_sharing_savings']:.4f}; plan and report "
              f"{wall_ms:.1f} ms wall, launches {counts}")

    sc, routing, plan = topo_ctx["scenario"], topo_ctx["routing"], topo_ctx["plan"]
    P, M = sc.n_pairs, sc.n_ports
    ops.reset_launches()
    t0 = time.perf_counter()
    trep = build_topology_report(sc, plan, routing, include_oracle=True)
    torch.cuda.synchronize()
    topo_s = time.perf_counter() - t0
    counts = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(counts.get("oracle_dp") == 1, f"build_topology_report launched {counts}")
    launches += counts["oracle_dp"]
    popt = np.array([p.oracle_cost for p in trep.ports])
    ptog = np.array([p.toggle_cost for p in trep.ports])
    check(bool(np.isfinite(popt).all()) and bool((popt <= ptog * (1 + OPT_SLACK)).all()),
          "topology report: OPT above ToggleCCI on a port")
    tt = trep.totals
    t0 = time.perf_counter()
    series = topology_port_costs_reference(sc.topo, sc.demand, routing)
    series_s = time.perf_counter() - t0
    pD = np.array([p.D for p in sc.topo.ports], np.int32)
    pT = np.array([p.T_cci for p in sc.topo.ports], np.int32)
    zeros = np.zeros(series["vpn"].shape)
    pargs = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (zeros + series["vpn"], zeros + series["cci"], pD, pT)]
    ptotal, pon = ops.oracle_dp(*(a.to(DEVICE) for a in pargs))
    cpu_total, cpu_on = ref.oracle_dp_ref(*pargs)
    check(same_bits(ptotal.cpu(), cpu_total) and torch.equal(pon.cpu(), cpu_on)
          and ptotal.cpu().numpy().tobytes() == popt.tobytes(),
          "topology oracle_dp != plain on the CPU or != the report's OPT")
    print(f"topology report {P} pairs x {T} h on {M} ports with the oracle: {topo_s:.3f} s wall "
          f"(port series on the host {series_s:.3f} s; launches {counts}); ToggleCCI "
          f"${tt['togglecci']:.2f}, oracle ${tt['oracle']:.2f}, oracle gap "
          f"{tt['oracle_gap']:.4f}x, lease_sharing_savings {tt['lease_sharing_savings']:.4f}; "
          f"OPT <= ToggleCCI on all {M} ports; oracle_dp on the port series == plain on the "
          f"CPU, every bit")

    # -- timings: both forms in turns, at the fleet year and the 128 ports -------
    b = oracle_bound(D, Tc, T)
    pb = oracle_bound(pD, pT, T)
    fma = {k: bound(*oracle_work(d, tc, T), torch.float64)["bound_ms"]
           for k, (d, tc) in (("fleet", (D, Tc)), ("ports", (pD, pT)))}
    print(f"  oracle_dp bound: {b['bound_ms']:.4f} ms at {N} x {T} and {pb['bound_ms']:.4f} "
          f"ms at {M} ports ({b['bound_by']}: each add and compare one float64 lane-op at "
          f"{F64_LANE_OPS_PER_S:.3g}/s); over the FMA-counted {PEAK_FLOPS[torch.float64]:.3g} "
          f"FLOP/s, as PR 22 printed it: {fma['fleet']:.4f} and {fma['ports']:.4f} ms")
    dp = lambda: ops.oracle_dp(*args)
    pdev = [a.to(DEVICE) for a in pargs]
    # Both forms in turns (large, register, register, large) in one trace a
    # shape; each kernel is told apart by its name.
    kname = {"large": "oracle_dp_block_kernel", "register": "oracle_dp_rows_kernel"}
    form_ms = {}
    for shape, a in (("fleet", args), ("ports", pdev)):
        def turns(a=a):
            for form in ("large", "register", "register", "large"):
                oracle_kernel(*a, form=form)
        got = kernel_device_ms(turns, 2, list(kname.values()), per_call=2)
        for form, name in kname.items():
            form_ms[form, shape] = got[name] / 2      # per launch
    ms, pms = form_ms["register", "fleet"], form_ms["register", "ports"]
    ev_ms = queued_ms(dp, 5)
    report_ms = sync_ms(lambda: build_report(fleet_scen, fleet_plan, include_oracle=True), 1,
                        warmup=0)
    print(f"timings on {card} (median ms)")
    for (form, shape), t in form_ms.items():
        bb = b if shape == "fleet" else pb
        rows = f"{N} links" if shape == "fleet" else f"{M} ports"
        print(f"  oracle_dp {form:8s} form, {rows} x {T}: {t:.4f} ms (profiler device time, "
              f"mean of 4 launches in turns with the other form), {t / bb['bound_ms']:.2f}x "
              f"the bound; run 22A (PR 22's kernel) {RUN_22A_MS[shape]} ms")
    print(f"  oracle_dp {N} x {T} as the report calls it: {ms:.4f} ms (CUDA events queued "
          f"behind a sleep {ev_ms:.4f}), plain on the card {plain_ms:.1f} ms, bound "
          f"{b['bound_ms']:.4f} ms, {ms / b['bound_ms']:.2f}x; {M} ports x {T}: {pms:.4f} ms, "
          f"bound {pb['bound_ms']:.4f} ms, {pms / pb['bound_ms']:.2f}x; register form "
          f"{form_ms['large', 'fleet'] / ms:.1f}x and "
          f"{form_ms['large', 'ports'] / pms:.1f}x faster than the "
          f"large-row form")
    print(f"  build_report {N} x {T} with the OPT column: {report_ms:.1f} ms wall (again); "
          f"build_topology_report {P} pairs with the oracle {topo_s * 1e3:.1f} ms")
    print_breakdown(dp, reps=2, unit="oracle_dp call")
    print(f"report phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


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
    kernel = "?"
    for line in _lib.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas ...{kernel[-56:]}: {line.strip()}")   # the tail holds template args

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
    for name in ("tiered_cost_batched", "fsm_scan"):
        check(main_launches[name] >= 1, f"kernel {name} was not launched on the main path")

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
    references = {}
    for renew in (False, True):
        t0 = time.perf_counter()
        want = references[renew] = plan_fleet_reference(
            scen[N128].fleet, scen[N128].demand, renew_in_chunks=renew)
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

    t_edge = time.perf_counter()
    n_edge = fsm_edge_checks()
    print(f"fsm_scan edge shapes, N in {FSM_EDGE_N} x T in {FSM_EDGE_T}, windows 1 h to past T, "
          f"holds 1 and 1-6, both renewals, planes 8 bytes off a 16-byte boundary: {n_edge} "
          f"cases, every bit == plain on the CPU, decisions == plain on the card "
          f"({time.perf_counter() - t_edge:.1f} s)")

    tier_nan_checks(inputs[N_big][3], inputs[N_big][2], inputs[N_big][4])

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
                  f"{per_plan['fsm_scan' if name == 'fsm_scan' else 'tiered_cost_batched']}"
                  + (f"; run M (before the redesign) {RUN_M_MS['fsm_scan']} ms"
                     if name == "fsm_scan" and N == SIZES[-1][0] else ""))
        print(f"  fsm_scan {N:5d} x {T} renew_in_chunks: "
              f"{event_ms(lambda: fsm_scan(*args, renew_in_chunks=True), 10):.4f} ms")
        plan_ms = sync_ms(lambda: plan_fleet(arrays, demand), 10)
        spec_ms = sync_ms(lambda: plan_fleet(scen[N].fleet, scen[N].demand), 3)
        print(f"  plan_fleet {N:5d} x {T}: {plan_ms:.3f} ms from arrays and demand on "
              f"the card; {spec_ms:.3f} ms from FleetSpec + numpy demand (stack + copy "
              f"in); launches/plan {per_plan}")
        print_breakdown(lambda: plan_fleet(arrays, demand), reps=3)
        timing[N] = row

    stream_rows = streaming_phase(scen, references, card.splitlines()[0])
    lm_rows = lm_phase(card.splitlines()[0])
    act_rows = actuation_phase(card.splitlines()[0])
    topo_row, topo_ctx = topology_phase(card.splitlines()[0], scen[SIZES[-1][0]])
    routed_row = topology_stream_phase(card.splitlines()[0], topo_ctx)
    oracle_row = report_phase(card.splitlines()[0], scen[N_big], plans[N_big, False], topo_ctx)

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
        {"name": "stream_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_chunk.cu",
         "replaces": "src/repro/fleet/runtime.py:339",
         **stream_rows["stream_chunk"], "library_ms": None},
        {"name": "tiered_cost_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/tiered_cost_scan.cu",
         "replaces": "src/repro/kernels/tiered_cost.py:168",
         **stream_rows["tiered_cost_scan"], "library_ms": None},
        {"name": "fsm_chunk", "route": "cuda",
         "source": "src/repro_torch/csrc/fsm_scan.cu",
         "replaces": "src/repro/fleet/runtime.py:577",
         **stream_rows["fsm_chunk"], "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:108",
         **lm_rows["flash_attention"]},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:27",
         **lm_rows["rmsnorm"]},
        {"name": "int8_quantize", "route": "cuda",
         "source": "src/repro_torch/csrc/int8_quant.cu",
         "replaces": "src/repro/kernels/int8_quant.py:32",
         **act_rows["int8_quantize"]},
        {"name": "int8_dequantize", "route": "cuda",
         "source": "src/repro_torch/csrc/int8_quant.cu",
         "replaces": "src/repro/kernels/int8_quant.py:57",
         **act_rows["int8_dequantize"]},
        {"name": "tiered_cost", "route": "cuda",
         "source": "src/repro_torch/csrc/tiered_cost.cu",
         "replaces": "src/repro/kernels/tiered_cost.py:48",
         **act_rows["tiered_cost"]},
        {"name": "leg_segment_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/leg_segment_sum.cu",
         "replaces": "src/repro/fleet/engine.py:170", **topo_row},
        {"name": "stream_chunk_routed", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_chunk_routed.cu",
         "replaces": "src/repro/fleet/runtime.py:465", **routed_row},
        {"name": "oracle_dp", "route": "cuda",
         "source": "src/repro_torch/csrc/oracle_dp.cu",
         "replaces": "src/repro/core/oracle.py:64", **oracle_row},
    ]
    print(f"profiler: {len(PAD_SEEN)} traces; pad kernels recorded of {TRACE_PADS}, by trace: "
          f"{PAD_SEEN}")
    for row in kernels:   # whether the kernel launches on one of the paths driven above
        row.setdefault("main_path", True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
