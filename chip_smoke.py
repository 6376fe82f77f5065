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
    launched once per chunk and tick (1165), each in its port-block form
    (the routing's hottest port holds ~100 legs), and ``stream_chunk``,
    ``leg_segment_sum``, ``tiered_cost_scan`` and ``fsm_chunk`` never, unless
    the stream equals the CPU ``plan_topology`` of the same routing bit for
    bit in ``x``/``state``/``vpn_cost``/``cci_cost`` and the per-tick hours
    the chunked ones in every field; it holds ``stream_chunk_routed``
    against ``stream_chunk_routed_ref`` in every output bit on the relay
    (padded) and multicast scenarios, NaN demand in pair 0 under padding
    legs, K = 1 across the month start, chained K = 24 across it, one K past
    the window ring, endogenous CCI demand, ports of 76 and 165 legs (one
    and two of the kernel's 128-leg tiles) at K = 24, 1 and 33, and the
    cell's routing, with its empty ports and 95-leg port, over 200 hours at
    K = 24 and 5, each case (but live ones) also in the other launch form
    where that form takes the routing (:func:`chunk_case`); it prints both
    forms' registers and fails on a spill; it
    streams
    ``build_reroute_scenario(2000, 800, seed 0)`` frozen and with live
    re-packing every 24 hours (``reroute()`` at chunk boundaries), fails
    unless the live run costs less and its decisions equal
    ``replay_plan_topology`` on the card and on the CPU, and prints the
    saving; then it times the tick, the chunk, the host split of a step and
    the kernel (profiler device time, its span) beside its bound, its
    latency floor and its plain version, with a device breakdown of one
    chunk;
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
13. the forecast-gated policy (:func:`forecast_phase`): the 2048-link year
    after 4380 hours of history (``build_fleet_scenario(..., history_hours=
    4380)``), with the forecaster's persistence init and a copy whose
    readout weights and bias are drawn from the seed; with every launch
    count at 0, ``demand_forecaster_predict`` over history and year, the
    cost fit on ``routed_cost_series`` and ``plan_fleet`` with the gated
    policy (per-family margins), from numpy through the entry points; it
    fails unless each run launched one ``forecaster_scan``, one gated
    ``fsm_scan`` and the two pricings, unless margin 1e30 gives the reactive
    plan in every bit, unless ``forecaster_scan`` equals its plain version
    on the card in every bit on N in (1, 17, 2048) x T in (1, 63, 13140) x S
    in (1, 8, 16, 17, 33, 100) with a zero and a seeded h0 and a NaN hour (and
    once without the readout; S past 16 the run-time instance), the same for
    the backward kernel, unless a 32-state ``forecast_fleet_policy`` of 256
    links trains on the card to the CPU's bits and plans as the CPU port
    does, unless the gated ``fsm_scan`` (which reads the prediction and the
    cost coefficients) equals the plain gating on the CPU of the predicted
    costs torch's ops form on the card in every bit at the FSM edge shapes
    with margins 0, 0.05 and 1e30, predictions -1, below -1 and NaN and both
    renewals, and at the main path's inputs, unless its gate stage
    (``gate_masks``) gives those costs' bits on 9.5 million hours, most near
    a threshold, unless the gated plan's profile holds no torch ``exp`` or
    ``log1p`` kernel, and unless the card's
    plan decides as the CPU port's (costs ``rtol=1e-9``), a differing row
    allowed only where a gate lies within the card-vs-CPU difference of the
    predicted costs of its threshold (printed, with the count); then it
    times both kernels (profiler device time) beside their bounds and
    ``forecaster_scan`` beside its time before the redesign and its chain
    floor, the reactive and hysteresis instances in the same run, the plan beside the
    reactive one with a device breakdown, and prints the fleet's
    ``forecast_gain`` against the OPT column;
14. the forecast-gated policy streamed in replay mode
    (:func:`forecast_stream_phase`): with every launch count at 0,
    ``FleetRuntime(fleet, policy=...)`` streams the forecast phase's
    2048-link year (its seeded-readout policy) in K = 24 chunks and, on a
    second runtime, 800 ticks; it fails unless the year launched exactly 365
    gated ``stream_chunk`` and the ticks 800, and nothing else, unless the
    stream equals the card's ``plan_fleet`` of the same policy bit for bit in
    ``x``/``state``/``vpn_cost``/``cci_cost`` and the ticks the chunks in
    every field, and unless margin 1e30 streams the reactive year in every
    field; it holds the gated ``stream_chunk`` against ``stream_chunk_ref``
    with the gate in every output bit on fourteen cases (chained chunks
    across the month start, endogenous CCI demand, K = 1, a policy cut to
    740 hours so that later hours read its last column, NaN predictions,
    per-link margins 0 to 1e30, K around both launch forms' edges); streams
    the topology phase's 2048 pairs on 128 ports with a per-port policy
    (``demand_forecaster_predict`` on the port demand, ``fit_cost_coef`` on
    the port series) and a ``reroute()`` at hour 4368, failing unless it
    launched 365 gated ``stream_chunk_routed`` and nothing else and equals
    the card's ``replay_plan_topology`` of the two-segment schedule bit for
    bit; holds the gated routed chunk against its plain version on four
    cases; prints the gated instances' registers and spills; then times the
    gated ``stream_chunk`` at 2048 x K = 24 (chunk form) and K = 1-5 (tick
    form) and the gated routed chunk (the call's span), each beside the
    reactive instance in the same run, its bound (the routed chunk also its
    latency floor) and its plain version, the chunk's
    p50/p99 beside the reactive stream's, and the device breakdowns;
15. the forecast-gated policy streamed in live mode
    (:func:`forecast_live_phase`): the live kernels' transcendentals
    (``log1p``, ``exp``, ``expm1``, ``log1pf``) against torch's CUDA ops on
    2^20 values each, every bit; the forecaster warmed through the forecast
    phase's 4380-hour history (one ``forecaster_scan``); with every launch
    count at 0, ``FleetRuntime(fleet, policy=..., forecaster=...)`` streams the
    2048-link year in K = 24 chunks and, on a second runtime, 800 ticks; it
    fails unless the year launched exactly 365 live ``stream_chunk`` and the
    ticks 800, and nothing else, unless the forecasts equal the card's
    ``demand_forecaster_predict`` columns H + t over history and clipped
    stream bit for bit, every field equals the replay stream of phase 14 and
    x/state the card's ``plan_fleet`` of the forecast policy, and the ticks
    equal the chunks; builds ``build_topology_scenario(2048, ...,
    history_hours=4380)``, warms a per-port forecaster through the history's
    port demand, fits the cost coefficients on the history's port series and
    streams the year live with a ``reroute()`` of 64 pairs at hour 4368,
    failing unless it launched 365 live ``stream_chunk_routed`` and nothing
    else, its forecasts equal the card's predictions over the realised port
    demand and its decisions the card's ``replay_plan_topology`` fed them;
    holds the live ``stream_chunk`` (sixteen cases: chained chunks across the
    month start, endogenous CCI demand, K = 1, NaN demand, per-link margins,
    S = 1, 16, 17, 33 and 100, K around both launch forms' edges) and the
    live routed chunk (seven cases, S up to 100) against their plain versions
    in every output bit and the forecaster's state; prints the live
    instances' registers and spills and fails on a spill or a stack frame in
    any of them; then times the live ``stream_chunk`` at 2048 x K = 24 and
    K = 1-5 beside the replay instance in the same run and its time before
    the redesign, and the routed chunk's live, replay
    and reactive instances at K = 24 and 1 in turns (the call's span),
    each beside its bound and latency floor, and the live years' chunk
    p50/p99 beside the replay years', with the device breakdowns;
16. observability on the streaming runtime (:func:`obs_phase`; no new
    kernel: the metrics ring is host work on the planes each chunk brings
    home): with every launch count at 0, the 2048-link year streams with
    ``FleetRuntime(obs=ObsConfig(cadence=72))`` in K = 24 chunks, in turns with
    the same stream without observability; it fails unless the two launched
    exactly 2 x 365 ``stream_chunk`` and nothing else, unless every output, the
    host carries and the FSM carry are bit-equal, and unless the drained lease
    counts are the state matrix's; it prints both streams' chunk p50/p99 and
    their ratio, the host microseconds a chunk of the ring update and of the
    observer's per-hour fan-out apart, and the report's first lines; the same
    year with ``divergence=True`` and ``max_oracle_ratio=inf`` must pass
    ``obs_check(final=True)`` (the replay on the card: one ``plan_fleet``; the
    regret oracle: one ``oracle_dp`` call), its realized / oracle ratio
    printed beside ``build_report``'s toggle / OPT; the 2048-pair topology year
    with a ``reroute()`` of 64 pairs at hour 4368 (365 ``stream_chunk_routed``)
    must pass the divergence check across the swap and trace the reroute; the
    live forecast year of phase 15 (365 live ``stream_chunk``) must equal that
    phase's year in every output, disable divergence with the reference's
    reason and report a calibration bias; 800 ticks at the default cadence
    (800 ``stream_chunk``) must decide as the chunked year; at 256 x 720, fleet
    and topology, the card's drained windows, monitor summaries and trace
    must equal the CPU's and the card's per-tick stream's bit for bit; and a
    decision flipped in the divergence monitor's record must raise
    ``ContractViolation``, the one exception the phase catches;
17. the multi-tenant gateway (``gateway_phase``; the pooled instances
    of ``stream_chunk`` and ``stream_chunk_routed``, each row with its own
    clock): with every launch count at 0, 256 fleet tenants of 32 links
    (``benchmarks/bench_gateway.py``'s shape) in one bucket tick 80 hours,
    then 400 timed hours in turns with one standalone runtime over the same
    8192 links, then a leave and a join into the freed slot (no new launch
    shape); a fresh pool of them in 18 chunks of 24 (cadence 72) in turns with
    the standalone runtime's chunks; 256 heterogeneous 2-link tenants over 6
    ticks and a chunk; a mixed gateway of topology tenants (32 pairs on 8
    ports) under the reactive, hysteresis and replay-gated policies and
    replay-gated fleet tenants, ticking then chunking, with a reroute and a
    leave, and a late tenant on 40-hour months joining into the freed slot;
    256 of those topology tenants, reactive and replay-gated, in two buckets
    of 128 slots (1024 ports of at most 12 legs each) over 4 ticks and a
    chunk. It fails unless every gateway call launched the pooled instances
    exactly once per non-empty bucket and nothing else, each topology
    bucket's launch in the routed chunk's form that the selection rule takes
    for it (the 128-slot buckets the small-port form, the mixed gateway's
    4-slot buckets of 32 ports the port-block form), unless the probe, the
    fresh (joined after the churn's leave), the heterogeneous, the mixed
    (the late one too) and the 128-slot topology buckets' first and last
    tenants equal their standalone card runtimes on
    every field, every hour, and unless a small gateway on the card equals the CPU's in
    every output, billing total and drained window; it prints
    tenant-link-steps/s, the tick p50/p95/p99 and drain ticks, the chunked
    rate and the join seconds beside the standalone runtime; then holds each
    pooled instance, in both fleet launch forms, against its plain version
    at 256 slots on staggered clocks (joins over 64 hours, months of 24, 40,
    168 and 730 hours: month starts at and inside the chunk, replay columns
    past a slot's own T_pred), and, on one common clock, against its plain
    version and the scalar instance bit for bit, and times both by profiler
    device time at 256 slots, K = 1 and 24, beside its bound; a topology
    bucket's call (2048 ports of at most 12 legs) also in the port-block form
    forced on the same operands (the same bits), both forms timed in turns
    beside their latency floors; it prints both routed forms' registers and
    fails on a spill;
18. prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` as
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
TRACE_TRIES, TRACE_RETRY_S = 5, (0.2, 0.5, 1.0, 2.0)   # traces that lost every device event
PAD_SEEN = []                          # per trace: how many pads it recorded
EVENT_TIMED = []                       # kernels timed by CUDA events: no trace held their launches


def traced(fn, reps: int):
    """Host and device events of ``reps`` calls of ``fn`` from torch.profiler
    (after one call untraced), and the device events alone. Minutes into a
    run on the H100 host, a trace can lose the device events of its first
    ~0.5 ms of device activity (7 of 20 launches of a 0.07-ms kernel; all of
    16 one-cycle spin kernels), and the later the trace the more it loses
    (0 to 17 first events over 32-40 traces in one run). So the trace opens
    with TRACE_PADS such spin kernels and TRACE_QUIET_S of idle card, and
    keeps only the events of the annotated calls after them. A trace can
    also lose every device event (no pad recorded; a few in 150 traces, and
    up to three in a row): such a trace is taken again after a pause, up to
    TRACE_TRIES traces. The callers that know how many launches a call makes
    check the count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    for attempt in range(TRACE_TRIES):
        if attempt:
            print(f"    profiler trace recorded no device event: taken again "
                  f"after {TRACE_RETRY_S[attempt - 1]} s")
            time.sleep(TRACE_RETRY_S[attempt - 1])
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
        on_card = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "traced calls"]
        PAD_SEEN.append(sum("spin_kernel" in e.name for e in on_card))
        if on_card:
            break
    mark = [e.time_range.start for e in events if e.name == "traced calls"]
    t0 = mark[0] if mark else float("-inf")
    events = [e for e in events if "spin_kernel" not in e.name and e.time_range.start >= t0]
    return events, [e for e in events if e.device_type == DeviceType.CUDA
                    and e.name != "traced calls"]     # kineto mirrors the annotation there


def print_breakdown(fn, reps: int, unit: str = "plan"):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    and the share of the traced window the device was busy. Returns the
    device's busy ms a call (None when the trace holds no device time)."""
    events, dev = traced(fn, reps)
    if not dev:
        print("    profiler: no device activity recorded (device time not measured)")
        return None
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
    return busy / reps / 1e3


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


def kernel_device_ms(fn, reps: int, names, per_call: int = 0, tries: int = 3) -> dict:
    """Device milliseconds per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``reps`` calls of ``fn`` (for kernels
    whose launch costs the host more than the card spends running them, CUDA
    events around a call measure the launch, not the kernel). Every name must
    show device time and, with ``per_call``, exactly ``reps * per_call``
    launches: a trace that lost launches reads low. Such a trace is taken
    again, up to ``tries`` traces, and the script fails unless one of them
    holds every launch (as device_ms_per_call does)."""
    for _ in range(tries):
        out, count = {}, {}
        for e in traced(fn, reps)[1]:
            for n in names:
                if n in e.name:
                    out[n] = out.get(n, 0.0) + e.time_range.elapsed_us() / reps / 1e3
                    count[n] = count.get(n, 0) + 1
        missing = [n for n in names if n not in out]
        short = {n: c for n, c in count.items() if per_call and c != reps * per_call}
        if not missing and not short:
            return out
        want = f", not {reps * per_call} each" if per_call else ""
        print(f"    profiler trace over {reps} calls holds {count} launches of {list(names)}"
              f"{want}: taken again")
    raise SmokeFailure(f"no profiler trace of {tries} held every launch of {list(names)}")


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


def stream_chunk_work(N: int, K: int, Kt: int, endo: bool, gated: bool = False):
    """(bytes, float64 operations) of the fleet chunk, reactive or gated."""
    # The block read (demand, the CCI demand when endo, pre_v, pre_c: (K, N) each),
    # the packed (8K + 4, N) result written; per-row operands (6 f64, 5 int32),
    # tier tables (2 x (N, Kt)), the carries in (dcum, dcum_month, prefixes; the
    # int32 FSM carry) and the FSM carry out.
    bytes_moved = (8 * ((3 if endo else 2) + 8) * K * N + 8 * 4 * N
                   + N * (8 * 6 + 4 * 5) + 8 * 2 * N * Kt + 8 * 4 * N + 2 * 4 * 4 * N)
    # per hour: 2 clips, month sub, carry add, hi add, per tier 6, the vpn add,
    # the cci mul and add, 2 prefix adds, 2 window subs, 2 muls, 2 compares.
    ops = K * N * (2 + 3 + 6 * Kt + 3 + 8)
    if gated:   # the predicted costs (K, N) x 2 and the margins read; the four
        # thresholds a row; per hour four products, four compares, and, or
        bytes_moved += 2 * K * N * 8 + N * 8
        ops += 4 * N + K * N * 10
    return bytes_moved, ops


def stream_chunk_bound(N: int, K: int, Kt: int, endo: bool, gated: bool = False) -> dict:
    return lane_bound(*stream_chunk_work(N, K, Kt, endo, gated), torch.float64)


def live_bound(bytes_moved: float, ops64: float, M: int, K: int, S: int) -> dict:
    """A chunk's bound in live mode, from its reactive (bytes, float64
    operations): plus the live operands' bytes (the forecaster's state in and
    out (M, S) float32, the carried forecast in, the forecast plane out (K,
    M), scale, cost_coef and margin: 6 float64 a row) and operations. Float64
    a row: the four thresholds; an hour: the gates (four products, four
    compares, and, or), the predicted costs (log1p, two products, two adds,
    two exp), the forecast (expm1, max, product), the input's quotient and
    rounding, each transcendental counted as one operation. Float32 an hour:
    log1pf, then per state the EMA's two products and add and the readout's
    sub, product and add, and the readout's two adds. The two types run on
    separate units: the operations' time is the larger of the two, each over
    its own lane-cycle peak."""
    bytes_moved += 2 * M * S * 4 + M * 8 + K * M * 8 + 6 * M * 8
    ops64 += 4 * M + K * M * (10 + 7 + 3 + 2)
    ops32 = K * M * (1 + 6 * S + 2)
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops64 / (PEAK_FLOPS[torch.float64] / 2), ops32 / (PEAK_FLOPS[torch.float32] / 2))
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


def chunk_case(spec, demand, t_first: int, Ks, cci_demand=None, routing=None,
               policy=None, forecaster=None) -> float:
    """Stream ``spec`` (and ``routing``, in topology mode; ``policy``, a
    forecast-gated one for the gated instances, with ``forecaster`` for the
    live ones) on the card to hour ``t_first``, then run each chunk of ``Ks``
    hours through the runtime's own ``_launch`` (the kernel: ``stream_chunk``,
    or ``stream_chunk_routed`` in topology mode, gated or live when the
    policy is) and through its plain version on the same block, carries and
    gate or live operands; fail unless the packed result, the FSM carry and
    (live) the forecaster's state agree in every bit. In topology mode, but
    live, the routed chunk's other launch form (:data:`ROUTED_FORMS`, forced;
    the small-port form only where it takes the routing) must give the same
    bits. Returns the largest absolute difference over non-NaN values (0.0
    when they agree)."""
    from repro_torch.fleet import FleetRuntime
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stream_chunk import small_port_fits, stream_chunk_routed

    rt = FleetRuntime(spec, routing=routing, policy=policy, forecaster=forecaster)
    name = ("stream_chunk_routed" if rt.topology else "stream_chunk") + (
        "_live" if rt._live is not None else "" if rt._gate is None else "_gated")
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
        st = rt._state
        live = None if rt._live is None else (st.ssm_h, st.pred_live, *rt._live)
        args = rt._chunk_args(dev_block, K_, endo)     # the carries before the launch
        res = plain(*args, renew_in_chunks=rt.policy.renew_in_chunks, gate=rt._gate, live=live)
        want, want_fsm = res[0], res[1]
        want_h = res[2] if live is not None else None
        before = ops.LAUNCHES[name]
        host = rt._launch(dev_block, K_, endo)
        check(ops.LAUNCHES[name] == before + 1, f"{name} did not launch")
        check(live is None or same_bits(rt._state.ssm_h, want_h),
              f"{name}: the forecaster's state != plain, hours {t}..{t + K - 1}")
        check(same_bits(host, want) and same_bits(rt._state.fsm, want_fsm),
              f"{name} != plain at {rt.n_demand_rows} demand rows on {rt.n_rows} decision "
              f"rows, hours {t}..{t + K - 1}, endo={endo}: first differing elements "
              f"{torch.nonzero((host != want) & ~(host.isnan() & want.isnan()))[:4].tolist()}")
        idx = rt.arrays.routing.index if rt.topology else None
        for form in ROUTED_FORMS if rt.topology and live is None else ():
            Kt = args[5].shape[-1]                      # args[5]: the pairs' tier bounds
            if form == "small_port" and not small_port_fits(idx, rt.n_demand_rows, K_, Kt, endo):
                continue
            got = stream_chunk_routed(*args, form=form, renew_in_chunks=rt.policy.renew_in_chunks,
                                      gate=rt._gate)
            check(same_bits(got[0], want) and same_bits(got[1], want_fsm),
                  f"{name} in the {form} form != plain, hours {t}..{t + K - 1}")
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


# forecaster_scan and stream_chunk's live instance before their redesign (the
# readout after the chains in each tile; the forecaster on the calendar
# warp's lanes), as PERF.md's kernel table keeps them: profiler device ms,
# NVIDIA H100 80GB HBM3, 700.00 W.
BEFORE_OVERLAP_MS = {
    "forecaster_scan 2048x4380": 0.0655, "forecaster_scan 2048x4380 ckpt": 0.0669,
    "forecaster_scan 2048x13140": 0.1900,
    "stream_chunk live 2048x24": 0.01602, "stream_chunk live 2048x1": 0.00362,
    "stream_chunk live 2048x2": 0.00407, "stream_chunk live 2048x3": 0.00533,
    "stream_chunk live 2048x4": 0.00647, "stream_chunk live 2048x5": 0.00671,
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
    low: it is taken again, up to ``tries`` traces. When none of them holds
    every launch, the calls are timed by CUDA events instead: ``reps`` calls
    queued behind a sleep kernel, between two events (every kernel of the
    call and the gaps between launches, so it reads a little high); the
    script prints which and lists them at its end."""
    for _ in range(tries):
        dev = [e for e in traced(fn, reps)[1] if name in e.name]
        if len(dev) == reps * per_call:
            return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3
        print(f"    profiler trace holds {len(dev)} launches of {name} over {reps} calls, "
              f"not {reps * per_call}: taken again")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * 1_000_000)   # ~0.5 ms of card time per call to queue
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    EVENT_TIMED.append(name)
    print(f"    no profiler trace of {tries} held every launch of {name}: timed by CUDA events "
          f"over {reps} queued calls instead, {ms:.5f} ms a call")
    return ms


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


MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 16                     # of 32: 23.5 B values, ~47 GB in bf16, on the 80 GB card
MOE_BATCH, MOE_PROMPT, MOE_NEW, MOE_REQUESTS = 4, 1024, 64, 3
MOE_SLICE_BATCH, MOE_SLICE_PROMPT, MOE_SLICE_NEW = 2, 256, 8   # the float32 1-layer slice
# float32 with TF32 off, one full-width MoE layer, card vs CPU (and decode vs
# forward on the card): the router's 4096-long products, the experts'
# 4096- and 14336-long ones and the softmax sums in different orders, ~1e-6
# relative each; logits are O(1), so 1e-3 leaves room and still catches a
# wrong slot, weight, capacity or index, which moves a token's logits by
# O(0.1-1). A routing decision whose top-k scores lie closer than this may
# flip between two such runs: the positions it touches are left out of the
# logit check and counted.
MOE_SLICE_TOL = 1e-3
# label, G, N, E, k, C, router, logits: Mixtral's prefill and decode groups,
# DeepSeek-V3's router, and the all-zero router (every token picks experts 0
# and 1, most slots drop); tests/test_torch_cuda.py runs the same cases.
MOE_ROUTE_CASES = (
    ("mixtral prefill", 4, 1024, 8, 2, 320, "softmax", "normal"),
    ("mixtral decode", 4, 1, 8, 2, 8, "softmax", "normal"),
    ("deepseek-v3 router", 4, 1024, 256, 8, 40, "sigmoid", "normal"),
    ("all-zero router", 4, 1024, 8, 2, 320, "softmax", "zeros"),
)
MOE_KERNELS = ("moe_route", "moe_dispatch", "moe_combine")
# combine keeps the plain version's roundings, so it is expected to agree bit for bit
MOE_COMBINE_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-6}
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's matrix-product kernels


class RouteLog:
    """Records every routing the MoE layers compute while active (each
    ``ops.moe_route`` result), for the decision checks."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig, self.calls = ops, ops.moe_route, []

        def logged(*args, **kw):
            r = self.orig(*args, **kw)
            self.calls.append(r)
            return r

        ops.moe_route = logged
        return self

    def __exit__(self, *exc):
        self.ops.moe_route = self.orig


def routing_on(r, device):
    return type(r)(*(t.to(device) for t in r))


def token_routing(r, n: int):
    """The routing of token n of every group (N = 1)."""
    k = r.gate_idx.shape[-1]
    n = n % r.gate_idx.shape[1]
    one = lambda t: t[:, n:n + 1]
    return type(r)(one(r.probs), one(r.gate_idx), one(r.gate_w), r.pos[:, n * k:(n + 1) * k],
                   r.keep[:, n * k:(n + 1) * k], r.src, r.aux)


def route_bound(G: int, N: int, E: int, k: int, C: int) -> dict:
    # logits read, probs written; gate_idx, gate_w, pos (4 B) and keep (1 B)
    # a slot; the capacity map and the aux loss; per score: max, sub, exp,
    # sum, divide, and a compare a choice
    bytes_moved = 8 * G * N * E + 13 * G * N * k + 4 * G * E * C + 4 * G
    return bound(bytes_moved, G * N * E * (5 + k), torch.float32)


def dispatch_bound(src: torch.Tensor, N: int, k: int, d: int, size: int) -> dict:
    # each token row that a kept slot takes read once (a token kept in two
    # experts is one read), every buffer row written, the map read
    g = torch.arange(src.shape[0], device=src.device)[:, None, None].expand_as(src)
    kept = src >= 0
    rows = int(torch.unique(g[kept] * N + src[kept] // k).numel())
    return bound(rows * d * size + src.numel() * d * size + 4 * src.numel(), 0, torch.float32)


def combine_bound(keep: torch.Tensor, G: int, N: int, k: int, d: int, size: int) -> dict:
    # the kept slots' rows read, y written, gate_idx/pos/gate_w (4 B) and
    # keep (1 B) a slot; a multiply and an add a kept element
    kept = int(keep.sum())
    return bound(kept * d * size + G * N * d * size + 13 * G * N * k, 2 * kept * d,
                 torch.float32)


def routing_diff(pairs, k: int):
    """Decisions of two runs of the same MoE calls, call by call: ``pairs``
    of (got, want) routings on one device. Returns per call the (G, N) mask
    of tokens whose top-k or keep differ, the count of differing slots and
    the largest ``want`` top-k margin among flipped tokens. A token whose
    top-k differs must have a margin (the least gap between its k + 1 best
    scores in ``want``) below MOE_SLICE_TOL; a keep that differs under an
    equal top-k must sit in a group that holds such a flip (an earlier slot
    moved to another expert)."""
    masks, n_slots, worst = [], 0, None
    for got, want in pairs:
        G, N, _ = got.gate_idx.shape
        gate = (got.gate_idx != want.gate_idx).any(-1)
        keep = (got.keep != want.keep).reshape(G, N, k).any(-1) & ~gate
        n_slots += int((got.gate_idx != want.gate_idx).sum()) + k * int(keep.sum())
        if bool(gate.any()):
            top = want.probs.sort(-1, descending=True).values[..., :k + 1]
            margin = (top[..., :-1] - top[..., 1:]).min(-1).values[gate].max().item()
            check(margin < MOE_SLICE_TOL,
                  f"a routing decision flipped with a top-k margin of {margin:.3e}")
            worst = margin if worst is None else max(worst, margin)
        check(bool((gate.any(1) | ~keep.any(1)).all()),
              "a keep decision differs in a group with no flipped top-k")
        masks.append(gate | keep)
    return masks, n_slots, worst


def masked_close(got: torch.Tensor, want: torch.Tensor, skip: torch.Tensor, what: str) -> float:
    """Max abs difference of (B, n, V) logits over the (B, n) positions not
    in ``skip``, held to MOE_SLICE_TOL."""
    kept = ~skip
    check(bool(kept.any()), f"{what}: every position's routing differs")
    torch.testing.assert_close(got[kept], want[kept], rtol=MOE_SLICE_TOL, atol=MOE_SLICE_TOL,
                               msg=lambda m: f"{what}: {m}")
    return (got[kept] - want[kept]).abs().max().item()


def moe_split(fn, reps: int, unit: str) -> None:
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler):
    the three MoE kernels against the expert products (the kernels of
    ``aten::bmm``) and every cuBLAS product, beside the device's busy time
    and idle share."""
    events, dev = traced(fn, reps)
    if not dev:
        print(f"    profiler, {unit}: no device activity recorded (not measured)")
        return
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    window = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events))
    per = lambda us: f"{us / reps / 1e3:.4f} ms ({us / busy:.1%})"
    moe = {n: sum(us for name, us in by_name.items() if f"{n}_kernel" in name)
           for n in MOE_KERNELS}
    bmm = sum(getattr(e, "device_time_total", 0.0) for e in events if e.name == "aten::bmm")
    gemm = sum(us for name, us in by_name.items() if any(t in name.lower() for t in GEMM_NAMES))
    print(f"    profiler, {unit}: device busy {busy / reps / 1e3:.3f} ms a call, idle share "
          f"{1 - busy / window:.3f}; " + ", ".join(f"{n} {per(us)}" for n, us in moe.items())
          + "; the expert products (aten::bmm) "
          + (per(bmm) if bmm > 0 else "not measured (no kernel tied to aten::bmm)")
          + f"; every cuBLAS product (the attention and head projections too) {per(gemm)}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    {us / reps / 1e3:9.4f} ms  {us / busy:6.1%}  {name[:90]}")


def moe_kernel_checks(rng, d: int) -> dict:
    """Each MoE kernel against its plain version on the card: the routing's
    decisions element for element (the plain top-k on the kernel's own
    scores), dispatch bit for bit, combine at MOE_COMBINE_TOL. Returns the
    prefill case's inputs and the largest errors."""
    from repro_torch.kernels import ops, ref

    errs, prefill = {"probs": 0.0, "gate_w": 0.0, "aux": 0.0}, {}
    for label, G, N, E, k, C, router, kind in MOE_ROUTE_CASES:
        logits = (torch.zeros((G, N, E), device=DEVICE) if kind == "zeros"
                  else seeded(rng, (G, N, E), torch.float32))
        got = ops.moe_route(logits, k, C, router=router, aux_coef=0.01)
        want = ref.moe_decide_ref(got.probs, k, C, router=router, aux_coef=0.01)
        scores = ref.moe_scores_ref(logits, router)
        torch.testing.assert_close(got.probs, scores, rtol=1e-6, atol=1e-7)
        for f in ("gate_idx", "pos", "keep", "src"):
            check(torch.equal(getattr(got, f), getattr(want, f)),
                  f"moe_route {label}: {f} differs from the plain version")
        torch.testing.assert_close(got.gate_w, want.gate_w, rtol=1e-6, atol=0)
        torch.testing.assert_close(got.aux, want.aux, rtol=1e-5, atol=1e-8)
        errs["probs"] = max(errs["probs"], (got.probs - scores).abs().max().item())
        errs["gate_w"] = max(errs["gate_w"], (got.gate_w - want.gate_w).abs().max().item())
        errs["aux"] = max(errs["aux"], (got.aux - want.aux).abs().max().item())
        dropped = int((~got.keep).sum())
        if kind == "zeros":
            check(bool((got.gate_idx[..., 0] == 0).all() & (got.gate_idx[..., 1] == 1).all()),
                  "all-zero router: the top-2 is not experts 0 and 1")
            check(dropped == G * k * (N - C), f"all-zero router dropped {dropped} slots")
        print(f"moe_route {label} (G {G}, N {N}, E {E}, k {k}, C {C}, {router}): gate_idx, "
              f"pos, keep, src == plain on the kernel's scores; gate_w bit-equal "
              f"{torch.equal(got.gate_w, want.gate_w)}; {dropped} of {G * N * k} slots dropped")
        if not label.startswith("mixtral"):
            continue
        x = seeded(rng, (G, N, d), torch.bfloat16)
        buf = ops.moe_dispatch(x, got.src, k)
        check(torch.equal(buf, ref.moe_dispatch_ref(x, got.src, k)),
              f"moe_dispatch {label}: not bit-equal to the plain version")
        for dtype, tol in MOE_COMBINE_TOL.items():
            out = seeded(rng, (E, G, C, d), dtype)
            y = ops.moe_combine(out, got.gate_idx, got.pos, got.keep, got.gate_w)
            want_y = ref.moe_combine_ref(out, got.gate_idx, got.pos, got.keep, got.gate_w)
            torch.testing.assert_close(y.float(), want_y.float(), rtol=tol, atol=tol)
            e = (y.float() - want_y.float()).abs().max().item()
            errs[f"combine {label} {str(dtype)[6:]}"] = e
            print(f"moe_dispatch / moe_combine {label}, d {d}, {str(dtype)[6:]}: dispatch "
                  f"bit-equal; combine max abs err {e:.3e} (tolerance {tol}), bit-equal "
                  f"{torch.equal(y, want_y)}")
        if label == "mixtral prefill":
            prefill = {"logits": logits, "route": got, "x": x}
    print(f"moe_route vs plain: probs max abs err {errs['probs']:.3e} (rtol 1e-6), gate_w "
          f"{errs['gate_w']:.3e} (rtol 1e-6), aux {errs['aux']:.3e} (rtol 1e-5)")
    return {**prefill, "errs": errs}


def moe_phase(card: str) -> dict:
    """The MoE layer on the card, Mixtral-8x7B at full width: each kernel
    against its plain version; one float32 layer against the CPU, and its
    decode against its forward; 16 of 32 layers in bf16 serving 3 request
    batches through ``greedy_generate`` with launches counted; timings.
    Returns the kernel rows."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.models.common import LayerKind, uniform_segments
    from repro_torch.train.serve import greedy_generate, make_decode_step, make_prefill

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED + 36)
    cfg = get_config(MOE_ARCH)
    m, d = cfg.moe, cfg.d_model
    moe_kind = LayerKind("gqa", "moe")

    # -- (a) each kernel against its plain version, same inputs --------------
    checked = moe_kernel_checks(rng, d)
    logits, route, x = checked["logits"], checked["route"], checked["x"]
    G, N, E = logits.shape
    k, C = m.top_k, route.src.shape[-1]

    # -- (b) one full-width layer in float32: the card against the CPU ------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg1 = dataclasses.replace(cfg, segments=uniform_segments(moe_kind, 1), dtype="float32")
    card_model = lm.LM(cfg1, seed=SEED)
    check(card_model.device.type == DEVICE.type, "LM did not default to the card")
    cpu_model = lm.LM(cfg1, device="meta")
    cpu_model.load_state_dict({n: t.cpu() for n, t in card_model.state_dict().items()},
                              assign=True)
    n1 = sum(p.numel() for p in card_model.parameters())
    B1, S1, n_new = MOE_SLICE_BATCH, MOE_SLICE_PROMPT, MOE_SLICE_NEW
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B1, S1)))
    forced = torch.as_tensor(rng.integers(0, cfg.vocab, (B1, n_new)))
    t0 = time.perf_counter()
    with RouteLog() as cpu_log:
        cpu_chain = teacher_forced(cfg1, cpu_model, prompt, forced)
    cpu_s = time.perf_counter() - t0
    with RouteLog() as card_log:
        card_chain = teacher_forced(cfg1, card_model, prompt.to(DEVICE), forced.to(DEVICE)).cpu()
    check(len(card_log.calls) == len(cpu_log.calls) == n_new, "MoE calls of the two chains")
    masks, n_flip, margin = routing_diff(
        [(routing_on(g, "cpu"), c) for g, c in zip(card_log.calls, cpu_log.calls)], k)
    # chain position 0 is the prefill's last token (group b is row b), t >= 1 decode step t
    skip = torch.stack([masks[0][:, -1]] + [mk[:, 0] for mk in masks[1:]], dim=1)
    n_slots = sum(r.keep.numel() for r in cpu_log.calls)
    err = masked_close(card_chain, cpu_chain, skip, "MoE slice card vs CPU")
    top1 = (card_chain.argmax(-1) == cpu_chain.argmax(-1)).float().mean().item()
    print(f"MoE slice: 1 {MOE_ARCH} layer at full width ({n1 / 1e9:.3f} B values, float32, "
          f"TF32 off), B = {B1}, S = {S1}, {n_new} teacher-forced steps: card vs CPU logits max "
          f"abs err {err:.3e} over {int((~skip).sum())} of {skip.numel()} positions "
          f"(tolerance {MOE_SLICE_TOL}; logits up to {cpu_chain.abs().max().item():.2f}); "
          f"routing decisions differ in {n_flip} of {n_slots} slots"
          + (f" (largest CPU top-k margin among flips {margin:.3e})" if margin is not None
             else "") + f"; top-1 equal at {top1:.4f} of positions; the CPU chain took "
          f"{cpu_s:.1f} s")

    cfg8 = dataclasses.replace(cfg1, moe=dataclasses.replace(
        m, capacity_factor=float(m.n_experts)))
    with RouteLog() as chain_log:
        chain = teacher_forced(cfg8, card_model, prompt.to(DEVICE), forced.to(DEVICE))
    with RouteLog() as fwd_log, torch.inference_mode():
        full, _ = lm.forward(cfg8, card_model, torch.cat([prompt, forced[:, :-1]], 1).to(DEVICE))
    full = full[:, S1 - 1:]
    f = fwd_log.calls[0]
    check(bool(f.keep.all()) and all(bool(r.keep.all()) for r in chain_log.calls),
          "a slot dropped at capacity factor n_experts")
    # the chain's routing of each logit's token (got) against the forward's (want)
    masks, n_flip8, margin8 = routing_diff(
        [(token_routing(chain_log.calls[0], -1), token_routing(f, S1 - 1))]
        + [(chain_log.calls[t], token_routing(f, S1 - 1 + t)) for t in range(1, n_new)], k)
    skip8 = torch.cat(masks, dim=1)
    err8 = masked_close(chain, full, skip8, "MoE decode vs forward")
    print(f"  decode vs forward at capacity factor {m.n_experts} (no slot dropped), float32, the "
          f"same weights: logits max abs err {err8:.3e} over {int((~skip8).sum())} of "
          f"{skip8.numel()} positions (tolerance {MOE_SLICE_TOL}); routing differs in "
          f"{n_flip8} slots" + (f" (largest top-k margin {margin8:.3e})" if margin8 is not None
                                else ""))
    del card_model, cpu_model, chain, full, cpu_log, card_log, chain_log, fwd_log, f
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the served path: 16 of 32 layers at every published width, bf16 -
    cfg16 = dataclasses.replace(cfg, segments=uniform_segments(moe_kind, MOE_LAYERS))
    L = MOE_LAYERS
    t0 = time.perf_counter()
    model = lm.LM(cfg16, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm.param_count(cfg16)
    check(n_params == sum(p.numel() for p in model.parameters()), "param_count != the model's")
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    greedy_generate(cfg16, model, torch.zeros((1, 16), dtype=torch.long), 2)   # warm-up
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, (MOE_BATCH, MOE_PROMPT)))
               for _ in range(MOE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = MOE_KERNELS + ("rmsnorm", "flash_attention", "flash_attention_sm90")
    outs, batch_s, per_batch = [], [], []
    ops.reset_launches()
    for p in prompts:
        before = dict(ops.LAUNCHES)
        a = time.perf_counter()
        outs.append(greedy_generate(cfg16, model, p, MOE_NEW))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - a)
        per_batch.append({n: ops.LAUNCHES[n] - before[n] for n in names})
    launches = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"MoE served path launches per request batch: {per_batch}")
    for n in per_batch:
        for name in MOE_KERNELS:
            check(n[name] == L * MOE_NEW, f"{name} launched {n[name]} times in a request "
                  f"batch, not {L} x {MOE_NEW}")
        check(n["rmsnorm"] == (2 * L + 1) * MOE_NEW,
              f"rmsnorm launched {n['rmsnorm']} times in a request batch")
        check(n["flash_attention"] == n["flash_attention_sm90"] == L,
              f"flash_attention launched {n['flash_attention']} times, not {L}")
    for o in outs:
        check(o.shape == (MOE_BATCH, MOE_NEW) and bool(((o >= 0) & (o < cfg.vocab)).all()),
              "served tokens out of range")
    print(f"served {MOE_REQUESTS} request batches of {MOE_ARCH} at every published width, "
          f"{L} of {cfg.n_layers} layers ({n_params / 1e9:.3f} B values by lm.param_count, "
          f"{weights_gb:.2f} GB, bf16 with float32 routers; seeded init {init_s:.1f} s): B = "
          f"{MOE_BATCH}, {MOE_PROMPT} prompt tokens, {MOE_NEW} new; peak "
          f"torch.cuda.max_memory_allocated {peak_gb:.2f} GB")

    prefill, step = make_prefill(cfg16), make_decode_step(cfg16)
    p0 = prompts[0].to(DEVICE)
    with torch.inference_mode():
        cache = lm.init_cache(cfg16, MOE_BATCH, MOE_PROMPT + MOE_NEW)
        with RouteLog() as log:
            prefill(model, p0, cache)
        dropped = sum(int((~r.keep).sum()) for r in log.calls)
        slots = sum(r.keep.numel() for r in log.calls)
        print(f"  the prefill dropped {dropped} of {slots} slots ({dropped / slots:.4%}; "
              f"capacity {C} a group of {MOE_PROMPT} tokens, {len(log.calls)} MoE layers)")
        prefill_ms = sync_ms(lambda: prefill(model, p0, cache), 3)
        prefill(model, p0, cache)
        tok = outs[0][:, :1]
        step_ms = []
        for _ in range(MOE_NEW - 1):
            a = time.perf_counter()
            step(model, tok, cache)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - a) * 1e3)

        def one_step():
            cache["index"] = MOE_PROMPT
            step(model, tok, cache)

        step_ms = np.array(step_ms)
        gen_s = float(np.median(batch_s))
        print(f"MoE timings on {card} (median ms)")
        print(f"  prefill B = {MOE_BATCH} x {MOE_PROMPT}: {prefill_ms:.3f} ms "
              f"({MOE_BATCH * MOE_PROMPT / prefill_ms * 1e3:.4g} prompt tokens/s)")
        print(f"  decode step B = {MOE_BATCH}: p50 {np.percentile(step_ms, 50):.3f} ms, p95 "
              f"{np.percentile(step_ms, 95):.3f} ms per token "
              f"({MOE_BATCH / np.percentile(step_ms, 50) * 1e3:.4g} tokens/s at p50)")
        print(f"  request batch (prefill + {MOE_NEW - 1} decode steps, greedy_generate): median "
              f"{gen_s * 1e3:.1f} ms, {MOE_BATCH * MOE_NEW / gen_s:.4g} generated tokens/s")
        moe_split(lambda: prefill(model, p0, cache), 1, "prefill")
        moe_split(one_step, 5, "decode step")

        # top-1 of the decode chain against forward over the same tokens: a
        # prompt of 960 and 64 teacher-forced steps, the forward over 1023
        # (a length past 1024 must be a multiple of the group); routing
        # flips make bf16 logits no test
        cut = MOE_PROMPT - MOE_NEW
        cfg16_8 = dataclasses.replace(cfg16, moe=dataclasses.replace(
            m, capacity_factor=float(m.n_experts)))
        agree = {}
        for c, label in ((cfg16, f"capacity factor {m.capacity_factor} as served"),
                         (cfg16_8, f"capacity factor {m.n_experts}, no slot dropped")):
            chain = teacher_forced(c, model, p0[:, :cut], p0[:, cut:])
            full, _ = lm.forward(c, model, p0[:, :MOE_PROMPT - 1])
            full = full[:, cut - 1:]
            check(bool(torch.isfinite(chain).all()) and bool(torch.isfinite(full).all()),
                  "served logits not finite")
            agree[label] = (chain.argmax(-1) == full.argmax(-1)).float().mean().item()
    print(f"  decode chain vs forward over the same {MOE_PROMPT - 1} tokens, {L} layers bf16, "
          f"top-1 agreement over {chain.shape[0] * chain.shape[1]} positions (logits not held: "
          "routing flips): " + "; ".join(f"{a:.4f} at {lb}" for lb, a in agree.items()))
    del model, cache, chain, full, log
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) each kernel at Mixtral's prefill shape, device time --------------
    out = seeded(rng, (E, G, C, d), torch.bfloat16)
    idx = (torch.arange(G, device=DEVICE)[:, None, None] * N
           + route.src.clamp_min(0) // k).transpose(0, 1).reshape(-1)
    xr = x.reshape(-1, d)
    rt = (route.gate_idx, route.pos, route.keep, route.gate_w)
    kernels = {
        "moe_route": (lambda: ops.moe_route(logits, k, C, aux_coef=m.aux_coef),
                      lambda: ref.moe_route_ref(logits, k, C, aux_coef=m.aux_coef),
                      None, route_bound(G, N, E, k, C), checked["errs"]["gate_w"]),
        "moe_dispatch": (lambda: ops.moe_dispatch(x, route.src, k),
                         lambda: ref.moe_dispatch_ref(x, route.src, k),
                         lambda: torch.index_select(xr, 0, idx),
                         dispatch_bound(route.src, N, k, d, 2), 0.0),
        "moe_combine": (lambda: ops.moe_combine(out, *rt), lambda: ref.moe_combine_ref(out, *rt),
                        None, combine_bound(route.keep, G, N, k, d, 2),
                        checked["errs"]["combine mixtral prefill bfloat16"]),
    }
    rows = {}
    print(f"  MoE kernels at Mixtral's prefill shape (G {G}, N {N}, E {E}, k {k}, C {C}, d {d}, "
          f"bf16): profiler device ms; the plain version and the library call by queued CUDA "
          f"events")
    for name, (kern, plain, lib, b, err) in kernels.items():
        ms = kernel_device_ms(kern, 20, (f"{name}_kernel",), per_call=1)[f"{name}_kernel"]
        plain_ms = queued_ms(plain, 5)
        lib_ms = queued_ms(lib, 20) if lib is not None else None
        rows[name] = {"launches": launches[name], "max_abs_err": err, "ms": ms,
                      "plain_ms": plain_ms, **b, "library_ms": lib_ms}
        print(f"    {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f}, bound "
              f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}; kernel {ms / b['bound_ms']:.1f}x "
              f"it)" + (f", index_select of the same rows (no zero rows) {lib_ms:.4f}"
                        if lib_ms is not None else "")
              + f"; {launches[name]} launches on the served path")
    print(f"MoE phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


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
LEG_TILE = 128                                            # legs a leg tile of the routed chunk
# Pairs on 2 facilities x 2 ports, 200 h: the hottest port holds 76 legs (200
# pairs) or 165, two leg tiles (400 pairs).
HOT_PAIRS, HOT_KW = (200, 400), dict(n_facilities=2, ports_per_facility=2, horizon=200)


def routed_chunk_bound(P: int, M: int, K: int, Kt: int, E: int, endo: bool,
                       gated: bool = False) -> dict:
    return bound(*routed_chunk_work(P, M, K, Kt, E, endo, gated), torch.float64)


def routed_chunk_work(P: int, M: int, K: int, Kt: int, E: int, endo: bool,
                      gated: bool = False):
    """(bytes, float64 operations) of the topology chunk, reactive or gated."""
    # In: the block (the demand (K, P), the CCI demand when endo, pre_v and pre_c
    # (K, M)); per pair capacity, L_vpn (f64) and the tier tables (P, Kt) x 2; per
    # port lease, c_cci, capacity, theta1, theta2 (f64) and h, D, T_cci and the two
    # holds (int32); the port-major legs (leg_pair int32; vpn_w, attach_w f64) and
    # the (M + 1,) offsets; the carries (cal (2, P), pref (2, M) f64; fsm (4, M)
    # int32). Out: the flat result (8KM + 2P + 2M f64) and the FSM carry (4, M)
    # int32. What the kernel reads again (a pair on several legs; a leg's carry
    # between hour tiles) is its own traffic, not the function's.
    bytes_moved = (8 * ((2 if endo else 1) * K * P + 2 * K * M) + 8 * (2 * P + 2 * P * Kt)
                   + M * (8 * 5 + 4 * 5) + E * (4 + 8 + 8) + 4 * (M + 1)
                   + 8 * (2 * P + 2 * M) + 4 * 4 * M + 8 * (8 * K * M + 2 * P + 2 * M)
                   + 4 * 4 * M)
    # Per pair-hour: the clips, month sub, carry add, hi add, per tier 6, the VPN
    # add; per leg-hour: 2 products and 2 adds; per port-hour: min, mul, add (CCI),
    # 2 prefix adds, 2 window subs, 2 muls, 2 compares.
    ops = K * P * ((2 if endo else 1) + 3 + 6 * Kt + 1) + K * E * 4 + K * M * 11
    if gated:   # the per-port predicted costs (K, M) x 2 and margins; the gates
        bytes_moved += 2 * K * M * 8 + M * 8
        ops += 4 * M + K * M * 10
    return bytes_moved, ops


# The routed chunk's latency floor: an empty kernel at its grid and dynamic
# shared memory, plus the dependent chain of its hottest port's block. The
# latencies are taken low (Hopper; not measured here): a load that hits L2, a
# dependent float64 add, a dependent integer or float32 operation, and the
# dependent float64 operations of one expm1, log1p or exp.
ROUTED_KERNEL = "routed_chunk_kernel"   # a call's one launch: its device time is the span
SMALL_KERNEL = "routed_small_kernel"    # the small-port form's kernel
ROUTED_ANY = "routed_"                  # either form's kernel
ROUTED_FORMS = ("port_block", "small_port")
SMALL_PORT = "stream_chunk_routed_small_port"   # the small-port form's launch count
ROUTED_THREADS = 512                    # kThreads: a port block, and a calendar block's pairs
ROUTED_LEG_TILE = 128                   # kLegTile: legs a leg tile
ROUTED_TILE = 32                        # kTile: hours an hour tile
L2_HIT_CYCLES = 200
FP64_DEP_CYCLES = 8
INT_DEP_CYCLES = 4
TRANSC_DEP_OPS = 20
_FLOOR_LIB = []


def routed_smem(K: int, Kt: int, endo: bool, live: bool) -> int:
    """The routed chunk's dynamic shared memory, as its C entry sizes it: two
    leg planes (three with CCI demand) of kLegTile rows of min(K, kTile) | 1
    doubles, the legs' tier rows (padded to a multiple of 4 tiers), 32 rows
    for the block's slice of the calendars, and the live instance's
    scratch."""
    stride = min(K, ROUTED_TILE) | 1
    doubles = ((3 if endo else 2) * ROUTED_LEG_TILE * stride
               + ROUTED_LEG_TILE * 2 * (-(-Kt // 4) * 4) + 32 * stride)
    live_bytes = 8 * (4 + 3 * ROUTED_TILE + 1) + 4 * (ROUTED_TILE + 16 * (ROUTED_TILE + 1))
    return 8 * doubles + (live_bytes if live else 0)


def routed_latency_floor(P: int, M: int, K: int, Kt: int, E_max: int, *, live: bool = False,
                         S: int = 0, form: str = "port_block") -> dict:
    """The least time a launch of the routed chunk could take on its hottest
    port's chain: the empty kernel's floor at the form's grid and dynamic
    shared memory (the port-block form: M port blocks of 512 threads, each
    also walking its slice of the pairs' calendars; the small-port form: a
    warp a port, SMALL_PORTS ports a block, its shared memory as
    its C entry sizes it for the hottest port's E_max legs), plus, at the
    card's highest SM clock, three dependent round trips
    that hit L2 (start[m], the leg descriptors, the gather), K calendar adds,
    one tier fold's Kt adds and the L_vpn add, the hottest port's E_max leg
    adds, then the longer of the K prefix adds with the window sum and
    trigger (3 dependent operations) and, live, the forecaster's state chain
    (K dependent multiply-adds, S readout adds) with one pass of expm1, log1p
    and exp; then K flat FSM steps (5 dependent integer operations each)."""
    from repro_torch.kernels.stream_chunk import small_port_geometry

    if not _FLOOR_LIB:
        _FLOOR_LIB.append(launch_floor())
    if form == "small_port":
        geo = small_port_geometry(P, M, K, Kt, False, E_max)
        blocks, threads, smem = geo["blocks"], geo["threads"], geo["smem"]
    else:
        blocks, threads, smem = max(M, 1), ROUTED_THREADS, routed_smem(K, Kt, False, live)
    empty = floor_ms(_FLOOR_LIB[0], blocks, threads, smem)
    mhz = float(sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                   "--format=csv,noheader,nounits").splitlines()[0])
    half = (K + 3) * FP64_DEP_CYCLES
    if live:
        half = max(half, (2 * K + S) * FP32_DEP_CYCLES + 3 * TRANSC_DEP_OPS * FP64_DEP_CYCLES)
    cycles = (3 * L2_HIT_CYCLES + (K + Kt + 1 + E_max) * FP64_DEP_CYCLES + half
              + 5 * K * INT_DEP_CYCLES)
    chain = cycles / (mhz * 1e6) * 1e3
    return {"floor_ms": empty + chain, "empty_ms": empty, "chain_ms": chain, "grid": blocks,
            "threads": threads}


def hottest_port_legs(routing) -> int:
    """Legs of the routing operand's busiest port, as its LegIndex recorded
    them from its runs on the host (no device read)."""
    check(routing.index.max_legs >= 0, "the routing's index holds no hottest port")
    return routing.index.max_legs


def print_routed_registers() -> None:
    """-Xptxas -v's registers, stack frame and spills of the routed chunk's
    instances: the port-block form (three gate modes, two of them also
    pooled) and the small-port form (reactive and replay, scalar and
    pooled); fails on a spill or a stack frame."""
    for kernel in (ROUTED_KERNEL, SMALL_KERNEL):
        for name, rep in sorted(ptxas_instances(kernel).items()):
            check(rep.get("stack") == rep.get("spill_stores") == rep.get("spill_loads") == 0,
                  f"{name} spills or keeps a stack frame: {rep}")
            mode, pooled = stream_instance(name)
            print(f"  ptxas {kernel} {mode}{' pooled' if pooled else ''}: "
                  f"{rep['registers']} registers, {rep['stack']} bytes stack frame, "
                  f"{rep['spill_stores']} bytes spill stores, {rep['spill_loads']} bytes "
                  f"spill loads")


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
    from repro_torch.kernels.stream_chunk import routed_form, stream_chunk_routed

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
    hot = hottest_port_legs(rt.arrays.routing)
    check(routed_form(hot, M) == "port_block" and launches[SMALL_PORT] == 0,
          f"the {M}-port stream (a {hot}-leg port) took the small-port form "
          f"{launches[SMALL_PORT]} times, not the port-block form")
    print(f"  the {M}-port stream (hottest port {hot} legs): every launch in the port-block "
          f"form, as the selection rule takes it")

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
    print_routed_registers()

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
        ms = device_ms_per_call(fused, 20, ROUTED_KERNEL, 1)
        ms2 = device_ms_per_call(fused, 20, ROUTED_KERNEL, 1)
        b_k = routed_chunk_bound(P, M, K, Kt, E, False)
        lat = routed_latency_floor(P, M, K, Kt, hottest_port_legs(rt_b.arrays.routing))
        timing[K] = {"ms": ms, "ms2": ms2,
                     "queued_ms": queued_ms(fused, 50), "event_ms": event_ms(fused, 50),
                     "plain_ms": sync_ms(plain, 3), **b_k, **lat}
        tk = timing[K]
        print(f"  stream_chunk_routed {P} pairs x K={K} on {M} ports, {E} legs: profiler device "
              f"time (one launch, its span) {tk['ms']:.5f} / {tk['ms2']:.5f} ms, CUDA events "
              f"behind a queue {tk['queued_ms']:.4f} ms, events around one call (host launch "
              f"included) {tk['event_ms']:.4f} ms; bound {tk['bound_ms'] * 1e3:.3f} us "
              f"({tk['bound_by']}), {tk['ms'] / tk['bound_ms']:.1f}x bound; latency floor "
              f"{tk['floor_ms']:.5f} ms (empty kernel at {tk['grid']} x {tk['threads']} "
              f"{tk['empty_ms']:.5f} + chain {tk['chain_ms']:.5f}), "
              f"{tk['ms'] / tk['floor_ms']:.2f}x it; plain {tk['plain_ms']:.3f} ms")
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
    function whose name holds ``kernel`` in the last build (the last such
    instance: :func:`ptxas_instances` lists them all)."""
    out = list(ptxas_instances(kernel).values())[-1]
    check(len(out) == 4, f"no ptxas report for {kernel} in the build log")
    return out


def ptxas_instances(kernel: str) -> dict:
    """``-Xptxas -v``'s registers, stack frame and spills of every instance
    (mangled entry name) whose name holds ``kernel`` in the last build."""
    import re
    from repro_torch.kernels import _lib

    out, name = {}, ""
    for line in _lib.build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif kernel in name:
            rep = out.setdefault(name, {})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                rep.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rep["registers"] = int(m[1])
    check(out, f"no ptxas report for {kernel} in the build log")
    return out


GATE_MODES = ("ungated", "replay", "live")   # the streaming kernels' gate mode template argument


def stream_instance(name: str) -> tuple:
    """(gate mode, pooled) of a streaming kernel's mangled instance name: its
    last two template arguments, the gate mode (0 ungated, 1 replay, 2 live)
    and the pooled flag (per-row clocks)."""
    import re

    m = re.search(r"Li(\d)ELb([01])EE+v", name)
    return (GATE_MODES[int(m[1])], m[2] == "1") if m else ("?", False)


def print_stream_registers(modes) -> None:
    """-Xptxas -v's registers, stack frame and spills of the streaming
    kernels' instances in the gate ``modes`` ("pooled": every pooled
    instance). Fails on a spill or a stack frame in any live or pooled
    instance."""
    for kernel in ("stream_chunk_tick_kernel", "stream_chunk_pipe_kernel", ROUTED_KERNEL,
                   SMALL_KERNEL):
        for name, rep_ in sorted(ptxas_instances(kernel).items()):
            mode, pooled = stream_instance(name)
            if (mode in modes and not pooled) or (pooled and "pooled" in modes):
                print(f"  ptxas {mode:8s}{' pooled' if pooled else ''} {name[-48:]}: {rep_}")
            if mode == "live" or pooled:
                check(rep_.get("stack") == rep_.get("spill_stores") == rep_.get("spill_loads")
                      == 0, f"the instance {name} spills or keeps a stack frame: {rep_}")


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


# -- the forecast slice ----------------------------------------------------------
FC_LINKS, FC_HOURS = 2048, 8760
FC_HISTORY = 4380                       # benchmarks/bench_policy.py's half-horizon history
FC_STATE = 8
# N, T, S; S past 16 takes the kernels' run-time instances
FC_STATES = (1, 8, 16, 17, 33, 100)
FC_CHECK = ((1, 17, 2048), (1, 63, FC_HISTORY + FC_HOURS), FC_STATES)
FC_MARGINS = (0.0, 0.05, 1e30)
GATE_STRESS = ((2048, 4380), (33, 8760))   # N, T of gate_mask_checks' near-threshold cases
FC_TRAIN_STEPS = 300                    # benchmarks/bench_policy.py:102's train_steps
FC_BWD_CHECK = ((1, 17, 2048), (2, 63, 65, FC_HISTORY), FC_STATES)   # N, T, S
FC_TRAIN_CHECK = (256, 30)              # links and steps of the card-vs-CPU training
# links, training steps, state_dim and history hours of the card-vs-CPU
# forecast_fleet_policy past 16 states (the kernels' run-time instances)
FC_WIDE = (256, 30, 32, 730)
FP32_DEP_CYCLES = 4                     # a dependent float32 multiply's or add's latency (Hopper)
# the gated fsm_scan at 2048 x 8760 before its redesign (run 25B, profiler
# device ms, NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
BEFORE_GATE_MS = 0.4656
# forecast_fleet_policy then plan_fleet: the training's steps (a forward and a
# backward scan each), the prediction over history and year, the cost fit's
# and the plan's pricings, the gated plan.
FC_WANT = {"forecaster_scan": FC_TRAIN_STEPS + 1, "forecaster_scan_bwd": FC_TRAIN_STEPS,
           "tiered_cost_batched": 2, "fsm_scan_gated": 1}


def forecaster_bound(N: int, T: int, S: int, write_y: bool = True) -> dict:
    # u read and y written (float32), h0 read and h written. Per element and
    # state: a·h, (1−a)·u, their sum, h − u, the product with w and the fold's
    # add, each a whole lane-cycle; the readout's two adds less the fold's first.
    bytes_moved = N * T * 4 * (2 if write_y else 1) + 2 * N * S * 4
    ops = N * T * (6 * S + 1 if write_y else 3 * S)
    return lane_bound(bytes_moved, ops, torch.float32)


def gated_fsm_bound(N: int, T: int, gate_ops: int) -> dict:
    # vpn, cci and pred read (f64); x, state written (int32); row parameters,
    # margins, cost coefficients and totals. fsm_bound's 11 operations an
    # hour and the exact gate form's gate_ops (gate_fp64_ops: a log1p, two
    # exp, their products and sums, the four products and compares), each a
    # whole float64 lane-cycle, as if every hour took it (the screen spares
    # most hours that work).
    bytes_moved = N * T * (3 * 8 + 4 + 4) + N * (8 * 3 + 4 * 5 + 8 + 4 * 8)
    return lane_bound(bytes_moved, N * T * (11 + gate_ops), torch.float64)


def gate_fp64_ops() -> dict:
    """The float64 instructions (DADD, DMUL, DFMA, DSETP, DMNMX) of one
    hour's exact gate form in the built library's SASS (cuobjdump): the body
    of fsm_scan.cu's gate_exact_call, the largest subroutine the gate stage's
    check kernel (gate_masks_kernel) calls: a log1p, two exp, their sums and
    products and the four compares (the rare paths of divisions are
    subroutines of their own and not counted). The gated fsm_scan inlines the
    same code. A static count: the path a normal prediction takes and the
    branches it skips. Returns the count and the subroutines'."""
    import re
    from repro_torch.kernels import _lib

    cuobjdump = str(Path(_lib._nvcc()).parent / "cuobjdump")
    sass = sh(cuobjdump, "-sass", _lib.load()._name)
    block = [b for b in sass.split("Function : ")[1:]
             if re.match(r"\S*gate_masks_kernel", b)]
    check(len(block) == 1, "gate_masks_kernel is not in the SASS")
    code = [(int(m[1], 16), m[2]) for m in
            re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block[0])]
    exit_at = max(a for a, op in code if re.search(r"\bEXIT\b", op))
    fp64 = {}
    for start in {int(m[1], 16) for a, op in code if a <= exit_at
                  for m in [re.search(r"CALL\.REL\.NOINC (0x[0-9a-f]+)", op)] if m}:
        n = 0
        for a, op in code:
            if a >= start:
                n += bool(re.search(r"\b(?:DADD|DMUL|DFMA|DSETP|DMNMX)\b", op))
                if re.search(r"\bRET\b", op):
                    break
        fp64[hex(start)] = n
    check(fp64 and max(fp64.values()) >= 40,
          f"no subroutine of gate_masks_kernel holds the exact gate form: {fp64}")
    return {"per_hour": max(fp64.values()), "subroutines": fp64}


def forecaster_case(N: int, T: int, S: int, h0: bool, device):
    """Seeded forecaster operands: log1p-like inputs (one NaN hour in row 0
    when N > 1), sigmoid'd timescales, readout weights and bias, a zero or
    seeded h0."""
    rng = np.random.default_rng(1000 * S + N + T)
    u = torch.tensor(rng.normal(0.6, 0.5, (N, T)), dtype=torch.float32, device=device)
    if N > 1:
        u[0, T // 2] = float("nan")
    a = torch.sigmoid(torch.tensor(rng.normal(1.0, 2.0, S), dtype=torch.float32))
    w = torch.tensor(rng.normal(0, 0.1, S), dtype=torch.float32, device=device)
    b = torch.tensor(rng.normal(0, 0.02), dtype=torch.float32, device=device)
    h = (torch.tensor(rng.normal(0.4, 0.3, (N, S)), dtype=torch.float32, device=device)
         if h0 else torch.zeros((N, S), dtype=torch.float32, device=device))
    return u, a.to(device), (1.0 - a).to(device), w, b, h


def forecaster_checks() -> int:
    """``forecaster_scan`` against its plain version on the card, every bit
    of y and h (NaN in the same places), on N x T x S of FC_CHECK with a zero
    and a seeded h0, each case also with the checkpoint store (y and h equal
    the store-free call's, the checkpoints the plain walk's states), and once
    without the readout. Returns the cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.forecaster import checkpoint_shape, forecaster_scan

    cases = 0
    for N in FC_CHECK[0]:
        for T in FC_CHECK[1]:
            for S in FC_CHECK[2]:
                for h0 in (False, True):
                    args = forecaster_case(N, T, S, h0, DEVICE)
                    y, h = forecaster_scan(*args)
                    want_ck = torch.empty(checkpoint_shape(N, T, S), device=DEVICE)
                    wy, wh = ref.forecaster_scan_ref(*args, ckpt=want_ck)
                    check(same_bits(y, wy) and same_bits(h, wh),
                          f"forecaster_scan {N} x {T}, S = {S}, h0 {h0}: != plain")
                    ck = torch.full_like(want_ck, float("inf"))
                    yc, hc = forecaster_scan(*args, ckpt=ck)
                    check(same_bits(yc, y) and same_bits(hc, h) and same_bits(ck, want_ck),
                          f"forecaster_scan {N} x {T}, S = {S}, h0 {h0}, with its checkpoint "
                          f"store: != the store-free call or the plain checkpoints")
                    cases += 1
    args = forecaster_case(FC_LINKS, FC_HISTORY + FC_HOURS, FC_STATE, True, DEVICE)
    none, h = forecaster_scan(*args, write_y=False)
    check(none is None and same_bits(h, ref.forecaster_scan_ref(*args, write_y=False)[1]),
          "forecaster_scan without its readout: h != plain")
    return cases + 1


def gate_operands(N: int, T: int, margins, device):
    """Seeded operands of the gated fsm_scan: a predicted demand in 50-hour
    regimes (every fifth row's predictions NaN from T // 3, and at T // 2 an
    hour of -1 in rows 1, 8, ... and one below -1 in rows 2, 9, ...), an 8
    bytes off a 16-byte boundary; cost coefficients whose predicted ratio
    p_cci / p_vpn runs about 0.7-1.4 across the regimes, so that it
    straddles the gates (slopes of 0 in rows 3, 14, ..., as a constant
    demand fits); per-row margins cycling through ``margins``. Returns
    (pred, coef, margin)."""
    rng = np.random.default_rng(7 * N + T)
    pred = (100.0 * np.repeat(rng.uniform(0.3, 3.0, (N, T // 50 + 1)), 50, axis=1)[:, :T]
            * rng.uniform(0.9, 1.1, (N, T)))
    pred[::5, T // 3:] = np.nan
    pred[1::7, T // 2] = -1.0
    pred[2::7, T // 2] = -1.5
    a_v, b_v, d = rng.uniform(-3.0, -1.0, N), rng.uniform(0.6, 1.0, N), rng.uniform(-0.15, 0.15, N)
    coef = np.stack([a_v, b_v, a_v + np.log(rng.uniform(0.85, 1.15, N)) - 4.6 * d, b_v + d], 1)
    coef[3::11, 1::2] = 0.0
    buf = torch.zeros(N * T + 1, dtype=torch.float64, device=device)
    view = buf[1:].view(N, T)
    view.copy_(torch.as_tensor(pred, device=device))
    m = torch.as_tensor(np.resize(np.asarray(margins, np.float64), N), device=device)
    return view, torch.as_tensor(coef, device=device), m


def card_planes(gate) -> tuple:
    """The predicted mode costs of a gate (pred, coef, margin) formed by
    torch's ops on the card (``predicted_mode_costs``), brought to the CPU
    with the margins: the plain gating's planes."""
    from repro_torch.fleet.policy import predicted_mode_costs

    pred, coef, m = gate
    return tuple(x.cpu() for x in predicted_mode_costs(pred, coef, torch.float64) + (m,))


def gated_edge_checks() -> int:
    """The gated ``fsm_scan`` at fsm_edge_checks' shapes (gate_operands:
    per-row margins cycling through FC_MARGINS, predictions of -1, below it
    and NaN, a misaligned pred), both renewals, then each margin alone at
    128 x 8760: every output bit equal to the plain gating on the CPU of the
    predicted costs torch's ops form on the card. Returns the cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fsm_scan import fsm_scan

    cases = 0
    shapes = [(N, T, FC_MARGINS) for N in FSM_EDGE_N for T in FSM_EDGE_T]
    shapes += [(128, 8760, (m,)) for m in FC_MARGINS]
    for N, T, margins in shapes:
        args = fsm_edge_args(N, T, 1, DEVICE)
        g = gate_operands(N, T, margins, DEVICE)
        check(g[0].data_ptr() % 16 == 8, "pred not misaligned")
        planes = card_planes(g)
        for renew in (False, True):
            got = fsm_scan(*args, renew_in_chunks=renew, gate=g)
            want = ref.fsm_scan_planes_ref(*(a.cpu() for a in args), renew_in_chunks=renew,
                                           planes=planes)
            for k in ("x", "state", "total_cost"):
                check(torch.equal(got[k].cpu(), want[k]), f"gated fsm_scan {N} x {T} margins "
                      f"{margins} renew={renew}: {k} != the plain gating on the card's planes")
            cases += 1
    return cases


def gate_stress_operands(N: int, T: int, seed: int, device):
    """Seeded gate operands whose predictions sit near the gates'
    thresholds: each row's cost ratio crosses its four thresholds at lp = 2
    to 22, and each hour takes one threshold's crossing, moved by a factor
    1 +- 10^u, u uniform in [-16, -3] (so the screen leaves many hours to
    the exact form and decides others by a hair); rows 3, 14, ... have a
    margin of 1e30 and random predictions. Returns (pred, coef, margin,
    theta1, theta2)."""
    rng = np.random.default_rng(seed)
    a_v, b_v = rng.uniform(-3.0, -1.0, N), rng.uniform(0.6, 1.0, N)
    d = rng.choice([-1.0, 1.0], N) * rng.uniform(0.05, 0.3, N)
    th1, th2 = rng.uniform(0.85, 0.95, N), rng.uniform(1.05, 1.2, N)
    m = rng.choice([0.0, 0.05, 0.15], N)
    m[3::11] = 1e30
    c0 = np.log(th1) - d * rng.uniform(8.0, 12.0, N)
    coef = np.stack([a_v, b_v, a_v + c0, b_v + d], 1)
    t = np.stack([th1 - m, th1 + m, th2 + m, th2 - m], 1)
    q = rng.integers(0, 4, (N, T))
    lt = np.log(np.maximum(np.take_along_axis(t, q, 1), 1e-300))
    lp = (lt - c0[:, None]) / d[:, None]
    with np.errstate(over="ignore"):
        pred = np.expm1(lp) * (1 + rng.choice([-1.0, 1.0], (N, T))
                               * 10.0 ** rng.uniform(-16, -3, (N, T)))
    pred[3::11] = rng.uniform(0, 500, (len(pred[3::11]), T))
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=device)
    return f64(pred), f64(coef), f64(m), f64(th1), f64(th2)


def gate_mask_checks() -> dict:
    """The gated fsm_scan's gate stage (``gate_masks``, with and without its
    screen) against the bits of the predicted costs torch's ops form on the
    card (``ref.gate_masks_ref``), every mask bit, on gate_operands' edge
    cases and gate_stress_operands' near-threshold hours. Returns the hours
    checked."""
    from repro_torch.fleet.policy import predicted_mode_costs
    from repro_torch.kernels import ref
    from repro_torch.kernels.fsm_scan import gate_masks

    hours = 0
    cases = [gate_stress_operands(N, T, N + T, DEVICE) for N, T in GATE_STRESS]
    for N, T in ((1, 1), (17, 63), (128, 2001)):
        args = fsm_edge_args(N, T, 1, DEVICE)
        pred, coef, m = gate_operands(N, T, FC_MARGINS, DEVICE)
        cases.append((pred.contiguous(), coef, m, args[2], args[3]))
    for pred, coef, m, th1, th2 in cases:
        planes = tuple(x.cpu() for x in predicted_mode_costs(pred, coef, torch.float64))
        want = ref.gate_masks_ref(*planes, m.cpu(), th1.cpu(), th2.cpu())
        for screen in (True, False):
            got = gate_masks(pred, coef, m, th1, th2, screen=screen).cpu()
            bad = int((got != want).sum())
            check(bad == 0, f"gate_masks {tuple(pred.shape)} screen={screen}: {bad} of "
                  f"{want.numel()} masks != the bits of the card's predicted costs")
        hours += pred.numel()
    return hours


def check_no_torch_transcendentals(fn) -> int:
    """Fails if a profiler trace of ``fn()`` holds a torch exp or log1p
    kernel (the predicted mode costs formed by torch's ops), or no launch of
    the gated fsm_scan. Returns the trace's device kernels."""
    import re

    names = [e.name for e in traced(fn, 1)[1]]
    check(any("fsm_scan_kernel" in n for n in names), "the traced plan holds no fsm_scan_kernel")
    bad = sorted({n[:120] for n in names if re.search(r"(?:exp|log1p)_kernel", n)})
    check(not bad, f"the forecast plan runs torch's exp/log1p kernels: {bad}")
    return len(names)


def forecast_policy(sc, params, device):
    """The forecast-gated policy of the scenario as forecast_fleet_policy
    builds it, minus the training: history and demand clipped at capacity,
    scale = max(mean(history), 1e-9), predictions over the history followed
    by the year, pred[:, t] = y[:, H - 1 + t], cost coefficients fitted on
    routed_cost_series of the year, per-family margins. Returns the stacked
    arrays, the policy and its predictions."""
    from repro_torch.fleet import family_margins, fit_cost_coef, forecast_gated_policy
    from repro_torch.fleet.engine import routed_cost_series
    from repro_torch.models.ssm import demand_forecaster_predict

    arrays = sc.fleet.stack(torch.float64, device)
    cap = np.array([l.capacity_gb_hr for l in sc.fleet.links])[:, None]
    hist, live = np.minimum(sc.history, cap), np.minimum(sc.demand, cap)
    scale = np.maximum(hist.mean(axis=1), 1e-9)
    H, T = hist.shape[1], live.shape[1]
    y = demand_forecaster_predict(params, np.concatenate([hist, live], axis=1), scale,
                                  device=device)
    pred = y[:, H - 1:H - 1 + T].contiguous()
    s = routed_cost_series(arrays, sc.demand, hours_per_month=sc.fleet.hours_per_month,
                           device=device)
    coef = fit_cost_coef(s.row_demand, s.vpn, s.cci)
    margin = family_margins([l.family for l in sc.fleet.links])
    return arrays, forecast_gated_policy(arrays.toggle, pred, margin=margin, cost_coef=coef)


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest relative difference of two tensors where both are finite
    (NaN where either is NaN is checked apart)."""
    a, b = a.cpu(), b.cpu()
    check(torch.equal(torch.isnan(a), torch.isnan(b)), "NaN in different places")
    ok = torch.isfinite(a) & torch.isfinite(b)
    d = (a - b).abs() / torch.maximum(a.abs(), b.abs()).clamp(min=1e-300)
    return float(d[ok].max()) if bool(ok.any()) else 0.0


def gate_ties(got, want, policy, gates, tol: float) -> int:
    """Rows whose decisions differ between the card's and the CPU's plans.
    Fails unless, at each such row's first differing hour, one of the four
    gate comparisons (on the CPU's predicted costs) lies within ``tol``
    relative of its threshold. Returns the count of such rows."""
    gx, gs = got["x"].cpu(), got["state"].cpu()
    bad = ((gx != want["x"]) | (gs != want["state"])).any(dim=1)
    p_vpn, p_cci = gates
    tp, m = policy.toggle, policy.margin.cpu()
    th = torch.stack([tp.theta1.cpu() - m, tp.theta1.cpu() + m, tp.theta2.cpu() + m,
                      tp.theta2.cpu() - m], dim=1)
    rows = torch.nonzero(bad).flatten().tolist()
    for n in rows:
        t = int(torch.nonzero((gx[n] != want["x"][n]) | (gs[n] != want["state"][n]))[0])
        k = th[n] * p_vpn[n, t]
        near = ((p_cci[n, t] - k).abs() <= tol * torch.maximum(p_cci[n, t].abs(), k.abs()))
        check(bool(near.any()), f"forecast plan: row {n} hour {t} decides otherwise on the "
              f"card than on the CPU, with no gate within {tol:.2e} of its threshold")
    return len(rows)


def forecaster_bwd_bound(N: int, T: int, S: int) -> dict:
    # u and dy read (float32), a, 1 − a and w read, the 3S + 1 sums written.
    # Per element and state: the forward state (a·h, (1−a)·u, their sum) and
    # the reverse step (λ: two products and a sum; dA, dB: a product and a
    # sum each; dW: a difference, a product and a sum), each a whole
    # lane-cycle; the bias's add once per element. The checkpoints the
    # kernel reads (the forward's states at its tiles) are its own choice and
    # not counted.
    bytes_moved = N * T * 8 + 3 * S * 4 + (3 * S + 1) * 4
    return lane_bound(bytes_moved, N * T * (13 * S + 1), torch.float32)


def bwd_case(N: int, T: int, S: int, kind: str, device):
    """forecaster_case's operands (a NaN hour in row 0 when N > 1; h0 seeded
    for the "seeded" dy) and a dy: "zero"; "seeded" (the loss gradient's
    size, zeros past hour T − 5 as the mask leaves them); "past" (a window
    past the horizon: the mask keeps hour 0 alone)."""
    u, a, oma, w, _, h0 = forecaster_case(N, T, S, kind == "seeded", device)
    rng = np.random.default_rng(31 * N + T + S)
    dy = torch.tensor(rng.normal(0, 1e-3, (N, T)), dtype=torch.float32, device=device)
    if kind == "zero":
        dy.zero_()
    elif kind == "seeded":
        dy[:, max(T - 5, 0):] = 0.0
    else:
        dy[:, 1:] = 0.0
    return u, dy, a, oma, w, (h0 if kind == "seeded" else None)


def forecaster_bwd_checks() -> int:
    """``forecaster_scan_bwd`` against its plain version on the card, every
    bit of the four gradients (NaN in the same places), on N x T x S of
    FC_BWD_CHECK with each of bwd_case's dy kinds, each case run twice: the
    call forming its checkpoints, and the checkpoints handed over by a
    ``forecaster_scan`` from the same h0. Returns the cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.forecaster import (checkpoint_shape, forecaster_scan,
                                                forecaster_scan_bwd)

    cases = 0
    zero = torch.zeros((), device=DEVICE)
    for N in FC_BWD_CHECK[0]:
        for T in FC_BWD_CHECK[1]:
            for S in FC_BWD_CHECK[2]:
                for kind in ("zero", "seeded", "past"):
                    args = bwd_case(N, T, S, kind, DEVICE)
                    want = ref.forecaster_scan_bwd_ref(*args)
                    got = forecaster_scan_bwd(*args)
                    check(all(same_bits(g, w) for g, w in zip(got, want)),
                          f"forecaster_scan_bwd {N} x {T}, S = {S}, dy {kind}: != plain")
                    u, dy, a, oma, w, h0 = args
                    ck = torch.empty(checkpoint_shape(N, T, S), device=DEVICE)
                    forecaster_scan(u, a, oma, w, zero, h0, write_y=False, ckpt=ck)
                    got = forecaster_scan_bwd(u, dy, a, oma, w, ckpt=ck)
                    check(all(same_bits(g, w) for g, w in zip(got, want)),
                          f"forecaster_scan_bwd {N} x {T}, S = {S}, dy {kind}, the forward's "
                          f"checkpoints: != plain")
                    cases += 1
    return cases


def print_bwd_registers() -> None:
    """-Xptxas -v's registers, stack frame and spills of the backward's
    kernels (the chains kernel's S = 8 instances in full, the largest
    register count over every S); fails on a spill or a stack frame."""
    import re

    chains = ptxas_instances("forecaster_bwd_chains_kernel")
    fold = ptxas_report("forecaster_bwd_fold_kernel")
    for name, rep in chains.items():
        check(rep.get("stack") == rep.get("spill_stores") == rep.get("spill_loads") == 0,
              f"{name} spills or keeps a stack frame: {rep}")
        m = re.search(r"ILi(\d+)ELb([01])E", name)
        if m and m[1] == str(FC_STATE):
            print(f"  forecaster_bwd_chains_kernel S = {m[1]}, "
                  f"{'16-byte' if m[2] == '1' else '4-byte'} copies, -Xptxas -v: "
                  f"{rep['registers']} registers, {rep['stack']} bytes stack frame, "
                  f"{rep['spill_stores']} bytes spill stores, {rep['spill_loads']} bytes "
                  f"spill loads")
    check(fold["stack"] == fold["spill_stores"] == fold["spill_loads"] == 0,
          f"forecaster_bwd_fold_kernel spills: {fold}")
    print(f"  forecaster_bwd_chains_kernel, all {len(chains)} instances: at most "
          f"{max(r['registers'] for r in chains.values())} registers, no spill, no stack "
          f"frame; forecaster_bwd_fold_kernel {fold['registers']} registers, no spill")


def print_fsm_registers() -> None:
    """-Xptxas -v's registers, stack frame and spills of fsm_scan's four
    instances (renewal x gated); fails on a spill or a stack frame."""
    for name, rep in ptxas_instances("fsm_scan_kernel").items():
        check(rep.get("stack") == rep.get("spill_stores") == rep.get("spill_loads") == 0,
              f"{name} spills or keeps a stack frame: {rep}")
        print(f"  {name[name.index('fsm_scan_kernel'):][:30]}: {rep['registers']} registers, "
              f"no spill, no stack frame")


def chain_floor_ms(T: int) -> tuple:
    """The backward's chain floor: T hours of the lam chain, a dependent
    multiply and add each (FP32_DEP_CYCLES cycles each), at the card's
    highest SM clock (nvidia-smi). Returns (ms, MHz)."""
    mhz = float(sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                   "--format=csv,noheader,nounits").splitlines()[0])
    return T * 2 * FP32_DEP_CYCLES / (mhz * 1e6) * 1e3, mhz


def train_card_vs_cpu(hist: np.ndarray, window: int, n: int = FC_TRAIN_CHECK[0],
                      steps: int = FC_TRAIN_CHECK[1], state_dim: int = FC_STATE) -> dict:
    """train_demand_forecaster on the card and on the CPU, n links and steps
    steps (FC_TRAIN_CHECK's by default) of state_dim states: every parameter
    bit equal, and every step's loss within rtol 1e-6 (the loss is a
    torch.sum, reported only). Returns the card's losses, both sides'
    parameters and the seconds each side took."""
    from repro_torch.models.ssm import train_demand_forecaster

    out = {}
    for side, dev in (("card", DEVICE), ("cpu", torch.device("cpu"))):
        losses = []
        t0 = time.perf_counter()
        params, scale = train_demand_forecaster(hist[:n], window, state_dim=state_dim,
                                                steps=steps, device=dev, losses=losses)
        torch.cuda.synchronize()
        out[side] = (params, scale, [float(x) for x in losses], time.perf_counter() - t0)
    (gp, gs, gl, g_s), (cp, cs, cl, c_s) = out["card"], out["cpu"]
    check(np.array_equal(gs, cs), "training scale: card != CPU")
    for k in cp:
        check(same_bits(gp[k].cpu(), cp[k]), f"trained {k}: card != CPU in some bit "
              f"({gp[k].cpu().tolist()} vs {cp[k].tolist()})")
    np.testing.assert_allclose(gl, cl, rtol=1e-6)
    return {"losses": gl, "card_s": g_s, "cpu_s": c_s, "card_params": gp, "cpu_params": cp}


def wide_forecast_card_vs_cpu() -> str:
    """The forecaster past 16 states: FC_WIDE's fleet (its own scenario, seed
    SEED, FC_HOURS of demand after its history) through
    forecast_fleet_policy(state_dim=32) and plan_fleet on the card, launches
    counted (one forward and one backward scan a training step, through the
    kernels' run-time instances); the training on the card and on the CPU
    equal in every parameter bit; the factory's predictions those of the
    trained parameters; the card's plan against the CPU port's from the same
    parameters (a differing row allowed only at a gate within the two
    devices' difference of its threshold). Returns a line to print."""
    from repro_torch.fleet import (build_fleet_scenario, family_margins, forecast_fleet_policy,
                                   forecast_horizon_hours, plan_fleet)
    from repro_torch.kernels import ops

    n, steps, S, H = FC_WIDE
    t0 = time.perf_counter()
    sc = build_fleet_scenario(n, horizon=FC_HOURS, history_hours=H, seed=SEED)
    arrays = sc.fleet.stack(torch.float64, DEVICE)
    margin = family_margins([l.family for l in sc.fleet.links])
    window = forecast_horizon_hours(arrays.toggle)
    cap = np.array([l.capacity_gb_hr for l in sc.fleet.links])[:, None]
    tr = train_card_vs_cpu(np.minimum(sc.history, cap), window, n, steps, S)
    before = dict(ops.LAUNCHES)
    pol = forecast_fleet_policy(arrays, sc.demand, sc.history, margin=margin, steps=steps,
                                state_dim=S, hours_per_month=sc.fleet.hours_per_month)
    plan = plan_fleet(arrays, sc.demand, policy=pol)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    want = {"forecaster_scan": steps + 1, "forecaster_scan_bwd": steps,
            "tiered_cost_batched": 2, "fsm_scan_gated": 1}
    check(launched == want, f"forecast_fleet_policy(state_dim={S}) launched {launched}")
    _, again = forecast_policy(sc, tr["card_params"], DEVICE)
    check(same_bits(again.pred_demand, pol.pred_demand),
          f"forecast_fleet_policy(state_dim={S}): predictions != predict with its training's "
          f"parameters")
    c_arrays, c_pol = forecast_policy(sc, tr["cpu_params"], "cpu")
    cpu = plan_fleet(c_arrays, sc.demand, policy=c_pol, device="cpu")
    gates = pol.features(plan["demand"], plan["vpn_hourly"], plan["cci_hourly"])
    c_gates = c_pol.features(cpu["demand"], cpu["vpn_hourly"], cpu["cci_hourly"])
    tol = 2 * max(rel_diff(gates[0], c_gates[0]), rel_diff(gates[1], c_gates[1]))
    ties = gate_ties(plan, cpu, c_pol, c_gates, tol)
    return (f"forecast_fleet_policy(state_dim={S}) {n} links x {H} h of history x {steps} "
            f"steps, then plan_fleet over {FC_HOURS} h: launches {launched}; training card == "
            f"CPU in every parameter bit (card {tr['card_s']:.2f} s, CPU {tr['cpu_s']:.2f} s); "
            f"predictions == predict with those parameters; card vs CPU plan: largest relative "
            f"difference of pred {rel_diff(pol.pred_demand, c_pol.pred_demand):.3e}, {ties} "
            f"rows decide otherwise (each at a gate within {tol:.3e} of its threshold) "
            f"({time.perf_counter() - t0:.1f} s)")


def forecast_phase(card: str) -> dict:
    """The forecast slice on the card: with every launch count at 0, the
    2048-link year's forecast policy trained through
    ``forecast_fleet_policy(..., steps=300)`` on the 4380-hour history and
    planned with ``plan_fleet``; launch counts exact; the backward kernel
    (with its own and with the forward's checkpoints) and both forward
    kernels (the scan with and without its checkpoint store) held bit for
    bit against their plain versions; the backward's registers and spills;
    a short training run card == CPU in every parameter bit; margin 1e30 ==
    reactive; the card's plan against the CPU port's; the seeded and the
    persistence readouts' plans beside it; then timings (the backward's
    chains and row fold, its chain floor, the forward with and without its
    checkpoint store, a training step's wall, busy and idle) and both
    forecast_gain values. Returns the three kernels' rows."""
    from repro_torch.fleet import (build_fleet_scenario, build_report, family_margins,
                                   forecast_fleet_policy, forecast_horizon_hours, plan_fleet)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.forecaster import forecaster_scan, forecaster_scan_bwd
    from repro_torch.kernels.fsm_scan import fsm_scan, gate_masks
    from repro_torch.models import ssm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sc = build_fleet_scenario(FC_LINKS, horizon=FC_HOURS, history_hours=FC_HISTORY, seed=SEED)
    N, T, H = FC_LINKS, FC_HOURS, FC_HISTORY
    print(f"forecast scenario {N} x {T} h after {H} h of history: "
          f"{time.perf_counter() - t0:.2f} s on the host")
    rng = np.random.default_rng(SEED)
    init = ssm.demand_forecaster_init(None, FC_STATE, device=DEVICE)
    seeded = dict(init, w=torch.tensor(0.1 * rng.standard_normal(FC_STATE), dtype=torch.float32,
                                       device=DEVICE),
                  bias=torch.tensor(0.01 * rng.standard_normal(), dtype=torch.float32,
                                    device=DEVICE))
    margin = family_margins([l.family for l in sc.fleet.links])
    arrays = sc.fleet.stack(torch.float64, DEVICE)
    window = forecast_horizon_hours(arrays.toggle)

    # -- the main path: train, forecast, fit and plan, launches counted -------
    ops.reset_launches()
    t0 = time.perf_counter()
    pol = forecast_fleet_policy(arrays, sc.demand, sc.history, margin=margin,
                                hours_per_month=sc.fleet.hours_per_month, steps=FC_TRAIN_STEPS)
    plan = plan_fleet(arrays, sc.demand, policy=pol)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    print(f"forecast path (forecast_fleet_policy, steps={FC_TRAIN_STEPS}, then plan_fleet): "
          f"launches {launches} ({path_s:.2f} s from numpy, training included)")
    check(launches == FC_WANT, f"the trained forecast path launched {launches}, not {FC_WANT}")

    # The training again, alone: its losses, its parameters, its wall time.
    cap = np.array([l.capacity_gb_hr for l in sc.fleet.links])[:, None]
    hist = np.minimum(sc.history, cap)
    losses = []
    t0 = time.perf_counter()
    trained, _ = ssm.train_demand_forecaster(hist, window, steps=FC_TRAIN_STEPS, losses=losses)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"training did not lower the loss: {losses[0]} -> {losses[-1]}")
    _, pol_t = forecast_policy(sc, trained, DEVICE)
    check(same_bits(pol_t.pred_demand, pol.pred_demand) and same_bits(pol_t.cost_coef,
                                                                       pol.cost_coef),
          "forecast_fleet_policy's predictions != predict with the same training's parameters")
    print(f"training {N} links x {H} h, window {window} h, {FC_TRAIN_STEPS} steps on the card: "
          f"{train_s:.2f} s wall ({train_s / FC_TRAIN_STEPS * 1e3:.2f} ms a step); loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}; the factory's predictions == predict with "
          f"those parameters, every bit")
    check(same_bits(plan["x"], plan_fleet(arrays, sc.demand, policy=pol)["x"]),
          "forecast plan not reproducible")
    reactive = plan_fleet(arrays, sc.demand)
    for k in ("toggle_cost", "static_vpn", "static_cci"):
        check(bool(torch.isfinite(plan[k]).all()), f"forecast plan: {k} not finite")
    check(plan["x"].shape == (N, T) and plan["x"].device.type == DEVICE.type,
          "forecast plan shape/device")
    flips = int((plan["x"] != reactive["x"]).sum())
    check(flips > 0, "the forecast gates changed no decision")
    print(f"trained forecast plan {N} x {T}: CCI share {plan['x'].double().mean().item():.4f} "
          f"(reactive {reactive['x'].double().mean().item():.4f}), {flips} link-hours decided "
          f"otherwise than reactive; toggle cost {plan['toggle_cost'].sum().item():.2f} vs "
          f"reactive {reactive['toggle_cost'].sum().item():.2f}")

    # The untrained readouts: one forecast, one fit, one plan each.
    plans = {}
    for name, params in (("seeded", seeded), ("init", init)):
        ops.reset_launches()
        a_, p_ = forecast_policy(sc, params, None)
        plans[name] = plan_fleet(a_, sc.demand, policy=p_)
        torch.cuda.synchronize()
        got = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(got == {"forecaster_scan": 1, "tiered_cost_batched": 2, "fsm_scan_gated": 1},
              f"forecast path ({name} readout) launched {got}")
    print("untrained readouts (seeded, persistence): one forecaster_scan, one gated fsm_scan "
          "and two pricings each")

    # (c) margin 1e30: the gates neither fire nor veto ---------------------
    wide = plan_fleet(arrays, sc.demand, policy=pol._replace(margin=torch.full_like(
        pol.margin, 1e30)))
    for k in reactive:
        check(same_bits(wide[k], reactive[k]), f"margin 1e30 != the reactive plan in {k}")
    print("margin 1e30: the gated plan == the reactive plan, every output bit")

    # (a) and (b): the kernels against their plain versions -------------------
    t0 = time.perf_counter()
    n_bwd = forecaster_bwd_checks()
    print(f"forecaster_scan_bwd: {n_bwd} cases (N in {FC_BWD_CHECK[0]} x T in "
          f"{FC_BWD_CHECK[1]} x S in {FC_BWD_CHECK[2]}, dy zero, seeded and past the horizon, "
          f"a NaN hour), each with its own and with the forward's checkpoints, == plain on "
          f"the card, every bit ({time.perf_counter() - t0:.1f} s)")
    print_bwd_registers()
    t0 = time.perf_counter()
    tr = train_card_vs_cpu(hist, window)
    print(f"training {FC_TRAIN_CHECK[0]} links x {H} h x {FC_TRAIN_CHECK[1]} steps: card == CPU "
          f"port in every parameter bit, losses within rtol 1e-6 (card {tr['card_s']:.2f} s, "
          f"CPU {tr['cpu_s']:.2f} s; {time.perf_counter() - t0:.1f} s)")
    print(wide_forecast_card_vs_cpu())
    t0 = time.perf_counter()
    n_fc = forecaster_checks()
    print(f"forecaster_scan: {n_fc} cases (N in {FC_CHECK[0]} x T in {FC_CHECK[1]} x S in "
          f"{FC_CHECK[2]}, zero and seeded h0, a NaN hour, with and without the checkpoint "
          f"store, and no readout) == plain on the card, every bit "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_gate = gated_edge_checks()
    print(f"gated fsm_scan: {n_gate} cases (edge shapes x margins {FC_MARGINS} by row, each "
          f"margin alone at 128 x 8760, predictions NaN, -1 and below, both renewals, a "
          f"misaligned pred) == the plain gating on the CPU of the card's predicted costs, "
          f"every bit ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_mask = gate_mask_checks()
    print(f"gate stage (gate_masks, with and without its screen): {n_mask} hours, most within "
          f"1e-3 in log of a threshold ({GATE_STRESS}) and gate_operands' edges, every mask "
          f"bit == the bits of the card's predicted costs ({time.perf_counter() - t0:.1f} s)")
    gates = pol.features(reactive["demand"], reactive["vpn_hourly"], reactive["cci_hourly"])
    gate_args = fsm_args(arrays, reactive["vpn_hourly"], reactive["cci_hourly"])
    gate = (pol.pred_demand, pol.cost_coef, pol.margin)
    got = fsm_scan(*gate_args, gate=gate)
    t0 = time.perf_counter()
    want = ref.fsm_scan_planes_ref(*(a.cpu() for a in gate_args),
                                   planes=tuple(x.cpu() for x in gates + (pol.margin,)))
    for k in ("x", "state", "total_cost"):
        check(torch.equal(got[k].cpu(), want[k]), f"gated fsm_scan at the main path's inputs: "
              f"{k} != the plain gating on the card's planes")
    check(same_bits(got["x"], plan["x"]), "the kernel's decisions != the plan's")
    gated_err = (got["total_cost"].cpu() - want["total_cost"]).abs().max().item()
    n_kernels = check_no_torch_transcendentals(lambda: plan_fleet(arrays, sc.demand, policy=pol))
    print(f"gated fsm_scan at the main path's inputs ({N} x {T}): x, state and total_cost == "
          f"the plain gating on the CPU of the card's predicted costs, every bit "
          f"({time.perf_counter() - t0:.1f} s); the plan's trace holds {n_kernels} device "
          f"kernels, no torch exp or log1p")

    # (d) the card's plan against the CPU port's, from the same trained
    # parameters (the training itself is card == CPU above) ---------------------
    t0 = time.perf_counter()
    cpu_params = {k: v.cpu() for k, v in trained.items()}
    c_arrays, c_pol = forecast_policy(sc, cpu_params, "cpu")
    cpu = plan_fleet(c_arrays, sc.demand, policy=c_pol, device="cpu")
    c_gates = c_pol.features(cpu["demand"], cpu["vpn_hourly"], cpu["cci_hourly"])
    d_pred = rel_diff(pol.pred_demand, c_pol.pred_demand)
    d_vpn, d_cci = rel_diff(gates[0], c_gates[0]), rel_diff(gates[1], c_gates[1])
    tol = 2 * max(d_vpn, d_cci)
    ties = gate_ties(plan, cpu, c_pol, c_gates, tol)
    for k in ("toggle_cost", "static_vpn", "static_cci"):
        if ties == 0:
            torch.testing.assert_close(plan[k].cpu(), cpu[k], rtol=1e-9, atol=0)
    print(f"trained forecast plan card vs CPU port ({time.perf_counter() - t0:.1f} s): largest "
          f"relative difference of pred {d_pred:.3e}, p_vpn {d_vpn:.3e}, p_cci {d_cci:.3e}; "
          f"{ties} rows decide otherwise (allowed only at a gate within {tol:.3e} of its "
          f"threshold); x/state " + ("equal, costs rtol 1e-9" if ties == 0 else "differ there"))

    # -- timings ---------------------------------------------------------------
    S = FC_STATE
    fc_args = forecaster_case(N, H + T, S, False, DEVICE)
    fc = lambda: forecaster_scan(*fc_args)
    fc_ms = device_ms_per_call(fc, 10, "forecaster_scan_kernel", 1)
    fc_state_ms = device_ms_per_call(lambda: forecaster_scan(*fc_args, write_y=False), 10,
                                     "forecaster_scan_kernel", 1)
    fc_plain_ms = sync_ms(lambda: ref.forecaster_scan_ref(*fc_args), 2)
    fb, fb_state = forecaster_bound(N, H + T, S), forecaster_bound(N, H + T, S, False)
    # one training step's two kernels at the training shape, and the step
    _, u, target, dy_weight = ssm._training_inputs(hist, window)
    u, target, dy_weight = (x.to(DEVICE) for x in (u, target, dy_weight))
    a, oma, w, bias = ssm._operands(trained, DEVICE)
    ck = ops.forecaster_checkpoints(u, S)
    y_ck = forecaster_scan(u, a, oma, w, bias, ckpt=ck)[0]
    check(same_bits(y_ck, forecaster_scan(u, a, oma, w, bias)[0]),
          "forecaster_scan with its checkpoint store: y != the store-free call's")
    dy = ((y_ck - target) * 2.0) * dy_weight
    fwd = lambda: forecaster_scan(u, a, oma, w, bias)
    fwd_ck = lambda: forecaster_scan(u, a, oma, w, bias, ckpt=ck)
    tfw = [device_ms_per_call(f, 10, "forecaster_scan_kernel", 1)
           for f in (fwd, fwd_ck, fwd_ck, fwd)]            # in turns
    tfw_ms, tfw_ck_ms = tfw[0], tfw[1]
    bwd = lambda: forecaster_scan_bwd(u, dy, a, oma, w, ckpt=ck)   # the training step's call
    bwd_alone = lambda: forecaster_scan_bwd(u, dy, a, oma, w)      # forms its checkpoints
    want = ref.forecaster_scan_bwd_ref(u, dy, a, oma, w)
    for f, how in ((bwd, "the forward's checkpoints"), (bwd_alone, "its own checkpoints")):
        check(all(same_bits(g, w_) for g, w_ in zip(f(), want)),
              f"forecaster_scan_bwd ({how}) != plain at the training step's inputs")
    bwd_ms = device_ms_per_call(bwd, 10, "forecaster_bwd", 2)
    split = kernel_device_ms(bwd, 10, ("forecaster_bwd_chains_kernel",
                                       "forecaster_bwd_fold_kernel"), per_call=1)
    bwd_ms2 = device_ms_per_call(bwd, 10, "forecaster_bwd", 2)
    alone = kernel_device_ms(bwd_alone, 10, ("forecaster_scan_kernel", "forecaster_bwd_"))
    bwd_plain_ms = sync_ms(lambda: ref.forecaster_scan_bwd_ref(u, dy, a, oma, w), 1)
    floor_ms_, max_mhz = chain_floor_ms(H)
    bb, tfb = forecaster_bwd_bound(N, H, S), forecaster_bound(N, H, S)
    cfg = AdamWConfig(lr=2e-2, weight_decay=0.0, clip_norm=1.0)
    state = {"p": trained, "o": adamw_init(trained, cfg)}

    def train_step():
        _, g = ssm._loss_and_grads(state["p"], u, target, dy_weight)
        state["p"], state["o"], _ = adamw_update(state["p"], g, state["o"], cfg)

    step_ms = sync_ms(train_step, 10)
    r_args = gate_args
    h_args = r_args[:7] + (arrays.toggle.h % 6 + 1, arrays.toggle.h % 4 + 1)
    fsm_calls = {"gated": lambda: fsm_scan(*gate_args, gate=gate),
                 "reactive": lambda: fsm_scan(*r_args), "hysteresis": lambda: fsm_scan(*h_args)}
    fsm_ms = {k: [] for k in fsm_calls}
    for k in ("gated", "reactive", "hysteresis", "hysteresis", "reactive", "gated"):   # in turns
        fsm_ms[k].append(device_ms_per_call(fsm_calls[k], 10, "fsm_scan_kernel", 1))
    g_ms, r_ms, h_ms = (fsm_ms[k][0] for k in fsm_calls)
    g_plain_ms = sync_ms(lambda: ref.fsm_scan_ref(*gate_args, gate=gate), 1, warmup=0)
    gm_args = gate + (arrays.toggle.theta1, arrays.toggle.theta2)
    gm_ms = {sc: [device_ms_per_call(lambda: gate_masks(*gm_args, screen=sc), 10,
                                     "gate_masks_kernel", 1)] for sc in (True, False)}
    gm_ms[True].append(device_ms_per_call(lambda: gate_masks(*gm_args), 10,
                                          "gate_masks_kernel", 1))
    gops = gate_fp64_ops()
    gb = gated_fsm_bound(N, T, gops["per_hour"])
    demand = torch.as_tensor(sc.demand, dtype=torch.float64, device=DEVICE)
    plan_ms = sync_ms(lambda: plan_fleet(arrays, demand, policy=pol), 10)
    react_ms = sync_ms(lambda: plan_fleet(arrays, demand), 10)

    def path():
        a_, p_ = forecast_policy(sc, trained, DEVICE)
        return plan_fleet(a_, sc.demand, policy=p_)

    path_ms = sync_ms(path, 2)
    print(f"timings on {card} (profiler device time, median ms; bound = max(bytes / 3.35 "
          f"TB/s, ops / peak))")
    print(f"  forecaster_scan_bwd {N} x {H}, S = {S} (a training step's, the forward's "
          f"checkpoints): {bwd_ms:.4f} / {bwd_ms2:.4f} ms (chains "
          f"{split['forecaster_bwd_chains_kernel']:.4f}, row fold "
          f"{split['forecaster_bwd_fold_kernel']:.4f}), bound {bb['bound_ms']:.4f} ms "
          f"({bb['bound_by']}), {bwd_ms / bb['bound_ms']:.2f}x; chain floor {floor_ms_:.4f} ms "
          f"({H} hours x a dependent multiply and add, {FP32_DEP_CYCLES} cycles each, at "
          f"{max_mhz:.0f} MHz); plain (card) {bwd_plain_ms:.1f} ms; launches on the path "
          f"{FC_TRAIN_STEPS}")
    print(f"  forecaster_scan_bwd forming its own checkpoints (no forward's): state-only scan "
          f"{alone['forecaster_scan_kernel']:.4f} + chains and fold "
          f"{alone['forecaster_bwd_']:.4f} ms")
    was = BEFORE_OVERLAP_MS
    print(f"  forecaster_scan {N} x {H}, S = {S} (a training step's forward): without the "
          f"checkpoint store {tfw_ms:.4f} / {tfw[3]:.4f} ms (before the redesign "
          f"{was[f'forecaster_scan {N}x{H}']}), with it {tfw_ck_ms:.4f} / {tfw[2]:.4f} ms "
          f"({was[f'forecaster_scan {N}x{H} ckpt']}) (in turns), bound "
          f"{tfb['bound_ms']:.4f} ms, {tfw_ck_ms / tfb['bound_ms']:.2f}x; chain floor "
          f"{floor_ms_:.4f} ms, {tfw_ck_ms / floor_ms_:.2f}x; a whole training step (forward, "
          f"backward, host sigmoid, AdamW) {step_ms:.3f} ms wall")
    print(f"  forecaster_scan {N} x {H + T}, S = {S}: kernel {fc_ms:.4f} ms (before the "
          f"redesign {was[f'forecaster_scan {N}x{H + T}']}), bound "
          f"{fb['bound_ms']:.4f} ms ({fb['bound_by']}), {fc_ms / fb['bound_ms']:.2f}x; chain "
          f"floor {chain_floor_ms(H + T)[0]:.4f} ms; "
          f"without the readout {fc_state_ms:.4f} ms (bound {fb_state['bound_ms']:.4f}); "
          f"plain (card) {fc_plain_ms:.1f} ms; launches on the path {FC_TRAIN_STEPS} at "
          f"{N} x {H} and 1 at {N} x {H + T}")
    ms_of = lambda k: " / ".join(f"{x:.4f}" for x in fsm_ms[k])
    print(f"  fsm_scan {N} x {T}, in turns (gated, reactive, hysteresis, then back): gated "
          f"{ms_of('gated')} ms (before the redesign {BEFORE_GATE_MS}; bound "
          f"{gb['bound_ms']:.4f} ms, {gb['bound_by']}, {g_ms / gb['bound_ms']:.2f}x; the gate "
          f"form {gops['per_hour']} float64 instructions an hour in the SASS (gate_exact_call; "
          f"first-level subroutines {gops['subroutines']})), reactive {ms_of('reactive')} ms, hysteresis "
          f"{ms_of('hysteresis')} ms (bound {fsm_bound(N, T)['bound_ms']:.4f}); gated plain "
          f"(card) {g_plain_ms:.1f} ms")
    print(f"  the gate stage alone (gate_masks, {N} x {T}, 4 gate warps a block of 16 rows): "
          f"with its screen {gm_ms[True][0]:.4f} / {gm_ms[True][1]:.4f} ms, every hour's exact "
          f"costs {gm_ms[False][0]:.4f} ms")
    print_fsm_registers()
    print(f"  plan_fleet {N} x {T} from arrays and demand on the card: forecast-gated "
          f"{plan_ms:.3f} ms, reactive {react_ms:.3f} ms; the forecast path from numpy without "
          f"the training (predict over {H + T} h, cost fit, plan) {path_ms:.1f} ms; with it "
          f"{path_s * 1e3:.1f} ms")
    busy_ms = print_breakdown(train_step, reps=5, unit="training step")
    if busy_ms is not None:
        print(f"  a training step: {step_ms:.3f} ms wall (median of 10 synchronized steps), "
              f"device busy {busy_ms:.3f} ms (the profiler's 5 steps): idle share of the wall "
              f"step {1 - busy_ms / step_ms:.3f}")
    print_breakdown(lambda: plan_fleet(arrays, demand, policy=pol), reps=3)

    # -- the report's forecast column on the fleet ------------------------------
    t0 = time.perf_counter()
    rep = build_report(sc, reactive, include_oracle=True)
    tog, opt = rep.totals["togglecci"], rep.totals["oracle"]
    gain = lambda p_: (tog - float(p_["toggle_cost"].sum())) / (tog - opt)
    print(f"forecast_gain (fraction of the reactive-vs-oracle gap closed, the topology "
          f"report's formula on the fleet's totals): trained {gain(plan):+.4f} (forecast-gated "
          f"${float(plan['toggle_cost'].sum()):,.2f}); seeded readout {gain(plans['seeded']):+.4f}"
          f", persistence {gain(plans['init']):+.4f}; ToggleCCI ${tog:,.2f}, oracle "
          f"${opt:,.2f} ({time.perf_counter() - t0:.1f} s)")
    print(f"forecast phase: {time.perf_counter() - t_phase:.1f} s")
    rows = {
        "forecaster_scan": {"launches": launches["forecaster_scan"],
                            "max_abs_err": 0.0, "ms": fc_ms, "plain_ms": fc_plain_ms, **fb,
                            "library_ms": None},
        "forecaster_scan_bwd": {"launches": launches["forecaster_scan_bwd"],
                                "max_abs_err": 0.0, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                                **bb, "library_ms": None},
        "fsm_scan_gated": {"launches": launches["fsm_scan_gated"],
                           "max_abs_err": gated_err, "ms": g_ms, "plain_ms": g_plain_ms, **gb,
                           "library_ms": None},
    }
    return rows, {"scenario": sc, "params": seeded, "arrays": arrays, "policy": pol,
                  "plan": plan}


# -- the forecast-gated policy streamed in replay mode ---------------------------
FS_SWAP = 4368                          # the topology stream's reroute: a chunk boundary
FS_PAST_T_PRED = 740                    # a policy cut to this many hours: the clamp case
GATED_TIMED_K = (24, 1, 2, 3, 4, 5)     # 2048 links: the chunk form, then the tick form


def moved_routing(topo, plan, n_moves: int):
    """``plan`` with up to ``n_moves`` pairs moved to another candidate port."""
    idx = np.asarray(plan.primary).copy()
    moved = 0
    for i, pr in enumerate(topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others and moved < n_moves:
            idx[i], moved = others[0], moved + 1
    return topo.plan(idx)


def forecast_stream_phase(card: str, fc_ctx: dict, topo_ctx: dict) -> dict:
    """The forecast-gated policy streamed in replay mode on the card (the
    gated instances of ``stream_chunk`` and ``stream_chunk_routed``): the
    forecast phase's 2048-link year in K = 24 chunks and 800 ticks with
    launches counted, against the card's ``plan_fleet`` of the same policy;
    margin 1e30 against the reactive stream; the topology stream phase's
    2048 pairs on 128 ports with a per-port policy and a reroute, against the
    card's ``replay_plan_topology``; both gated kernels against their plain
    versions; registers and spills; then timings beside the reactive
    instances. Returns the two gated kernels' rows."""
    from repro_torch.fleet import (FleetRuntime, fit_cost_coef, forecast_gated_policy,
                                   plan_fleet, plan_topology, replay_plan_topology)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stream_chunk import (TICK_MAX_K, _stream_chunk_launch,
                                                  stream_chunk_routed)
    from repro_torch.models.ssm import demand_forecaster_predict

    t_phase = time.perf_counter()
    sc, pol, plan = fc_ctx["scenario"], fc_ctx["policy"], fc_ctx["plan"]
    N, T = sc.demand.shape
    fields = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")

    # -- the main path: the forecast year streamed, launches counted -----------
    ops.reset_launches()
    rt = FleetRuntime(sc.fleet, policy=pol)
    check(rt.device.type == DEVICE.type and rt.pred_source == "replay",
          "FleetRuntime did not stream the forecast policy in replay mode on the card")
    chunk_clock = []
    chunked = stream(rt, sc.demand, STREAM_K, chunk_clock)
    torch.cuda.synchronize()
    year = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(year == {"stream_chunk_gated": T // STREAM_K},
          f"the streamed forecast year launched {year}, not {T // STREAM_K} gated stream_chunk")
    ops.reset_launches()
    rt_tick = FleetRuntime(sc.fleet, policy=pol)
    tick_us, ticks = [], []
    for t in range(STREAM_TICKS):
        a = time.perf_counter()
        ticks.append(rt_tick.step(sc.demand[:, t]))
        tick_us.append((time.perf_counter() - a) * 1e6)
    torch.cuda.synchronize()
    tick_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(tick_launches == {"stream_chunk_gated": STREAM_TICKS},
          f"{STREAM_TICKS} forecast ticks launched {tick_launches}")
    fleet_launches = T // STREAM_K + STREAM_TICKS
    print(f"forecast stream path launches: {year} for the year in K = {STREAM_K} chunks, "
          f"{tick_launches} for {STREAM_TICKS} ticks")
    # The decisions against the card's plan of the policy (the same predicted
    # costs); the cost series, which no policy changes, against the CPU plan
    # (the card's monthly_cumsum is a parallel scan, the stream's sequential).
    cpu = plan_fleet(sc.fleet, sc.demand, device="cpu")
    for k, want in (("x", plan["x"]), ("state", plan["state"]),
                    ("vpn_cost", cpu["vpn_hourly"]), ("cci_cost", cpu["cci_hourly"])):
        check(np.array_equal(chunked[k], want.cpu().numpy()),
              f"forecast stream {N} x {T}: {k} != " + ("the card's plan_fleet of the policy"
                                                       if k in ("x", "state") else
                                                       "the CPU plan_fleet's series"))
    for k in ("vpn_hourly", "cci_hourly"):
        torch.testing.assert_close(plan[k].cpu(), cpu[k], rtol=1e-9, atol=0)
    for k in fields:
        check(np.array_equal(np.stack([o[k] for o in ticks], 1), chunked[k][:, :STREAM_TICKS]),
              f"forecast per-tick step != chunked step_many in {k}")
    print(f"forecast stream {N} x {T} (K = {STREAM_K}): x/state == the card's plan_fleet of the "
          f"policy, vpn_cost/cci_cost == the CPU plan_fleet's series, bit for bit (the card "
          f"plan's series within rtol 1e-9 of them); {STREAM_TICKS} ticks == the chunks in all "
          f"{len(fields)} fields; CCI share {chunked['x'].mean():.4f}")

    # margin 1e30 against the reactive stream, and the reactive year's clock
    react_clock = []
    reactive = stream(FleetRuntime(sc.fleet), sc.demand, STREAM_K, react_clock)
    wide = stream(FleetRuntime(sc.fleet, policy=pol._replace(
        margin=torch.full_like(pol.margin, 1e30))), sc.demand, STREAM_K)
    for k in fields:
        check(np.array_equal(wide[k], reactive[k]), f"margin 1e30 stream != reactive in {k}")
    # The gated year again, after the reactive one: the first of several streams
    # timed in a row read slower on the host (PERF.md, run 26C).
    warm_clock = []
    stream(FleetRuntime(sc.fleet, policy=pol), sc.demand, STREAM_K, warm_clock)
    flips = int((chunked["x"] != reactive["x"]).sum())
    check(flips > 0, "the forecast gates changed no streamed decision")
    print(f"margin 1e30: the gated stream == the reactive stream, every field; the forecast "
          f"stream decides {flips} link-hours otherwise than reactive")

    # -- the gated stream_chunk against its plain version ----------------------
    t_cases = time.perf_counter()
    cut = pol._replace(pred_demand=pol.pred_demand[:, :FS_PAST_T_PRED].contiguous())
    nan_pred = pol.pred_demand.clone()
    nan_pred[::7, 700:] = float("nan")
    rows_m = pol._replace(margin=torch.as_tensor(
        np.resize([0.0, 0.05, 0.15, 1e30], N), device=DEVICE))
    fleet, demand = sc.fleet, sc.demand
    cases = {
        f"4 chained K = {STREAM_K} from hour 696": (pol, 696, [STREAM_K] * 4, None),
        "endogenous CCI demand, 2 x K = 24": (pol, 696, [STREAM_K] * 2, demand * 1.5),
        "K = 1 over hours 728..731": (pol, 728, [1] * 4, None),
        f"T_pred {FS_PAST_T_PRED}: K = 24, 5, 24 from hour 726": (cut, 726, [24, 5, 24], None),
        "NaN predictions in every 7th link from hour 700, 2 x K = 24": (
            pol._replace(pred_demand=nan_pred), 696, [24] * 2, None),
        "margins 0, 0.05, 0.15, 1e30 by link, K = 24, 1, 30": (rows_m, 696, [24, 1, 30], None),
    }
    for K in (2, 3, TICK_MAX_K, TICK_MAX_K + 1, 8, 9, 23, 25):
        cases[f"3 chained K = {K} from hour 726"] = (pol, 726, [K] * 3, None)
    gated_err = 0.0
    for label, (p_, t_, Ks, c_) in cases.items():
        gated_err = max(gated_err, chunk_case(fleet, demand, t_, Ks, c_, policy=p_))
        print(f"  gated stream_chunk == stream_chunk_ref with the gate, every output bit: "
              f"{label}")
    print(f"gated stream_chunk: {len(cases)} cases at {N} links equal the plain version on the "
          f"card ({time.perf_counter() - t_cases:.1f} s)")

    # -- topology: a per-port policy, a reroute mid-year -----------------------
    t0 = time.perf_counter()
    tsc, r0 = topo_ctx["scenario"], topo_ctx["routing"]
    P, M = tsc.n_pairs, tsc.n_ports
    tarr = tsc.topo.stack(r0, torch.float64, DEVICE)
    base = plan_topology(tarr, tsc.demand)
    port_d = base["port_demand"]
    scale = np.maximum(port_d.mean(dim=1).cpu().numpy(), 1e-9)
    y = demand_forecaster_predict(fc_ctx["params"], port_d.cpu().numpy(), scale)
    tpred = torch.cat([y[:, :1], y[:, :-1]], dim=1).contiguous()   # from hours before t
    coef = fit_cost_coef(port_d, base["vpn_hourly"], base["cci_hourly"])
    tpol = forecast_gated_policy(tarr.toggle, tpred, margin=0.05, cost_coef=coef)
    r1 = moved_routing(tsc.topo, r0, 64)
    check(r1.paths != r0.paths, "the reroute moves no pair")

    def topo_year(policy):
        """The topology year in K = 24 chunks with the reroute at FS_SWAP, and
        the host clock of each chunk."""
        rt_ = FleetRuntime(tsc.topo, routing=r0, policy=policy)
        clock, outs, t = [], [], 0
        while t < T:
            if t == FS_SWAP:
                rt_.reroute(r1)
            a = time.perf_counter()
            outs.append(rt_.step_many(tsc.demand[:, t:t + STREAM_K]))
            clock.append(time.perf_counter() - a)
            t += STREAM_K
        torch.cuda.synchronize()
        return {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}, clock

    ops.reset_launches()
    tstream, topo_clock = topo_year(tpol)
    topo_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(topo_launches == {"stream_chunk_routed_gated": T // STREAM_K},
          f"the rerouted forecast topology stream launched {topo_launches}")
    schedule = [(0, r0), (FS_SWAP, r1)]
    rep = replay_plan_topology(tarr, tsc.demand, schedule, policy=tpol)
    cpu_rep = replay_plan_topology(tsc.topo.stack(r0, torch.float64, "cpu"), tsc.demand,
                                   schedule, device="cpu")
    for k, want in (("x", rep["x"]), ("state", rep["state"]),
                    ("vpn_cost", cpu_rep["vpn_hourly"]), ("cci_cost", cpu_rep["cci_hourly"])):
        check(np.array_equal(tstream[k], want.cpu().numpy()),
              f"forecast topology stream: {k} != the " + (
                  "card's replay_plan_topology of the policy" if k in ("x", "state") else
                  "CPU replay_plan_topology's series"))
    treactive, topo_react_clock = topo_year(None)
    topo_warm_clock = topo_year(tpol)[1]
    for k in ("vpn_cost", "cci_cost", "r_vpn", "r_cci"):
        check(np.array_equal(tstream[k], treactive[k]),
              f"forecast topology stream: {k} != the reactive stream's")
    tflips = int((tstream["x"] != treactive["x"]).sum())
    print(f"forecast topology stream {P} pairs x {T} h on {M} ports, reroute at hour {FS_SWAP} "
          f"({sum(a != b for a, b in zip(r0.paths, r1.paths))} pairs moved): launches "
          f"{topo_launches}; x/state == the card's replay_plan_topology of the two-segment "
          f"schedule, vpn_cost/cci_cost == the CPU replay's series, bit for bit; {tflips} "
          f"port-hours decided otherwise than reactive ({time.perf_counter() - t0:.1f} s)")
    t_cases = time.perf_counter()
    bad = tsc.demand.copy()
    bad[0, [666, 699, 706]] = np.nan
    padded = r0.pad_to(r0.total_hops + NAN_PAD)
    tcut = tpol._replace(pred_demand=tpol.pred_demand[:, :FS_PAST_T_PRED].contiguous())
    tcases = {
        "4 chained K = 24 from hour 696": (tpol, r0, tsc.demand, 696, [24] * 4, None),
        "K = 1 over hours 728..731": (tpol, r0, tsc.demand, 728, [1] * 4, None),
        f"NaN demand in pair 0, {NAN_PAD} padding legs, 2 x K = 24": (
            tpol, padded, bad, 696, [24] * 2, None),
        f"T_pred {FS_PAST_T_PRED}, endogenous CCI demand: K = 24, 5, 33 from hour 726": (
            tcut, r0, tsc.demand, 726, [24, 5, 33], tsc.demand * 1.5),
    }
    routed_err = 0.0
    for label, (p_, r_, d_, t_, Ks, c_) in tcases.items():
        routed_err = max(routed_err, chunk_case(tsc.topo, d_, t_, Ks, c_, routing=r_, policy=p_))
        print(f"  gated stream_chunk_routed == stream_chunk_routed_ref with the gate, every "
              f"output bit: {label}")
    print(f"gated stream_chunk_routed: {len(tcases)} cases equal the plain version on the card "
          f"({time.perf_counter() - t_cases:.1f} s)")

    # -- registers and spills of the gated instances ---------------------------
    print_stream_registers(("ungated", "replay"))

    # -- timings ----------------------------------------------------------------
    print(f"forecast streaming timings on {card} (profiler device time, median ms; bound = "
          f"max(bytes / 3.35 TB/s, ops / peak))")
    for label, clock in (("forecast-gated (the main path, first)", chunk_clock),
                         ("reactive", react_clock), ("forecast-gated again", warm_clock),
                         ("forecast-gated topology (first)", topo_clock),
                         ("reactive topology", topo_react_clock),
                         ("forecast-gated topology again", topo_warm_clock)):
        ms = np.array(clock) * 1e3
        print(f"  {label} year in K = {STREAM_K} chunks: chunk p50 {np.percentile(ms, 50):.3f} "
              f"ms, p99 {np.percentile(ms, 99):.3f} ms, mean {ms.mean():.3f} ms")
    tick = np.array(tick_us)
    print(f"  forecast-gated per-tick step {N} links: p50 {np.percentile(tick, 50):.1f} us, p99 "
          f"{np.percentile(tick, 99):.1f} us")
    rt_b = FleetRuntime(sc.fleet, policy=pol)
    stream(rt_b, sc.demand[:, :SWEEP_T0], STREAM_K)
    Kt = rt_b.arrays.tier_bounds.shape[1]
    times = {}
    for K in GATED_TIMED_K:
        block, _, _ = rt_b._pack(sc.demand[:, SWEEP_T0:SWEEP_T0 + K], None)
        args = rt_b._chunk_args(torch.from_numpy(block).to(DEVICE), K, False)
        gate = rt_b._gate
        want = ref.stream_chunk_ref(*args, gate=gate)
        gated_call = lambda: _stream_chunk_launch("auto", *args, gate=gate)
        got = gated_call()
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
              f"gated stream_chunk {N} x K={K} != plain at the timed block")
        g_ms = device_ms_per_call(gated_call, 20, "stream_chunk", 1)
        r_ms = device_ms_per_call(lambda: _stream_chunk_launch("auto", *args), 20,
                                  "stream_chunk", 1)
        g2_ms = device_ms_per_call(gated_call, 20, "stream_chunk", 1)
        b = stream_chunk_bound(N, K, Kt, False, gated=True)
        times[K] = {"ms": g_ms, "ms2": g2_ms, "reactive_ms": r_ms,
                    "plain_ms": sync_ms(lambda: ref.stream_chunk_ref(*args, gate=gate), 3), **b}
        tk = times[K]
        form = "tick" if K <= TICK_MAX_K else "chunk"
        print(f"  stream_chunk gated {N} x K={K} ({form} form): {g_ms:.5f} / {g2_ms:.5f} ms, "
              f"reactive instance {r_ms:.5f} ms (in turns); bound {b['bound_ms'] * 1e3:.3f} us "
              f"({b['bound_by']}), {g_ms / b['bound_ms']:.2f}x bound; "
              f"plain {tk['plain_ms']:.3f} ms")
    print_breakdown(lambda: rt_b.step_many(sc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K]), reps=6,
                    unit="forecast-gated chunk")
    rt_r = FleetRuntime(sc.fleet)
    stream(rt_r, sc.demand[:, :SWEEP_T0], STREAM_K)
    print_breakdown(lambda: rt_r.step_many(sc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K]), reps=6,
                    unit="reactive chunk")
    trt_b = FleetRuntime(tsc.topo, routing=r0, policy=tpol)
    stream(trt_b, tsc.demand[:, :SWEEP_T0], STREAM_K)
    block, _, _ = trt_b._pack(tsc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K], None)
    targs = trt_b._chunk_args(torch.from_numpy(block).to(DEVICE), STREAM_K, False)
    tgate = trt_b._gate
    twant = ref.stream_chunk_routed_ref(*targs, gate=tgate)
    tcall = lambda: stream_chunk_routed(*targs, gate=tgate)
    tgot = tcall()
    check(same_bits(tgot[0], twant[0]) and same_bits(tgot[1], twant[1]),
          "gated stream_chunk_routed != plain at the timed block")
    span = lambda fn: device_ms_per_call(fn, 20, ROUTED_KERNEL, 1)
    t_ms = span(tcall)
    r_ms = span(lambda: stream_chunk_routed(*targs))
    t2_ms = span(tcall)
    E = trt_b.arrays.routing.n_legs
    tb = routed_chunk_bound(P, M, STREAM_K, Kt, E, False, gated=True)
    lat = routed_latency_floor(P, M, STREAM_K, Kt, hottest_port_legs(trt_b.arrays.routing))
    t_plain = sync_ms(lambda: ref.stream_chunk_routed_ref(*targs, gate=tgate), 3)
    print(f"  stream_chunk_routed gated {P} pairs x K={STREAM_K} on {M} ports, {E} legs "
          f"(the call's span): {t_ms:.5f} / {t2_ms:.5f} ms, reactive instance {r_ms:.5f} ms "
          f"(in turns); bound {tb['bound_ms'] * 1e3:.3f} us ({tb['bound_by']}), "
          f"{t_ms / tb['bound_ms']:.1f}x bound; latency floor {lat['floor_ms']:.5f} ms (empty "
          f"kernel {lat['empty_ms']:.5f} + chain {lat['chain_ms']:.5f}); plain {t_plain:.3f} ms")
    print_breakdown(lambda: trt_b.step_many(tsc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K]), reps=6,
                    unit="forecast-gated topology chunk")
    print(f"forecast stream phase: {time.perf_counter() - t_phase:.1f} s")
    t24 = times[STREAM_K]
    rows = {
        "stream_chunk_gated": {
            "launches": fleet_launches, "max_abs_err": gated_err, "ms": t24["ms"],
            "plain_ms": t24["plain_ms"], "bound_ms": t24["bound_ms"],
            "bound_by": t24["bound_by"], "library_ms": None},
        "stream_chunk_routed_gated": {
            "launches": topo_launches["stream_chunk_routed_gated"], "max_abs_err": routed_err,
            "ms": t_ms, "plain_ms": t_plain, "bound_ms": tb["bound_ms"],
            "bound_by": tb["bound_by"], "library_ms": None},
    }
    return rows


# -- the forecast-gated policy streamed in live mode -------------------------------
LIVE_TIMED_K = (24, 1, 2, 3, 4, 5)      # 2048 links: the chunk form, then the tick form
LIVE_MATH_N = 1 << 20                   # values a transcendental is checked on
LIVE_TRAIN_STEPS = 60                   # benchmarks/bench_runtime.py:193's steps
# the live checks' forecaster sizes beside the main path's: past 16 states the
# chunk form's second and later passes, past 32 the routed chunk's
LIVE_STATES = (1, 16, 17, 33, 100)


def live_math_checks() -> int:
    """The live instances' log1p, exp, expm1 (float64) and log1pf (float32),
    built as the kernels are, against torch's CUDA ops on LIVE_MATH_N values
    each in the ranges the live path feeds them, with 0, NaN, inf and -0.0:
    every bit. Returns the values checked."""
    from repro_torch.kernels.stream_chunk import LIVE_MATH, live_math

    rng = np.random.default_rng(SEED)
    n = LIVE_MATH_N
    ranges = {"log1p": lambda: 10.0 ** rng.uniform(-9, 7, n),
              "exp": lambda: rng.uniform(-40, 40, n),
              "expm1": lambda: rng.uniform(-12, 16, n).astype(np.float32).astype(np.float64),
              "log1pf": lambda: rng.uniform(0, 60, n).astype(np.float32)}
    torch_op = {"log1p": torch.log1p, "exp": torch.exp, "expm1": torch.expm1,
                "log1pf": torch.log1p}
    for fn in LIVE_MATH:
        x = ranges[fn]()
        x[:4] = [0.0, np.nan, np.inf, -0.0]
        xt = torch.from_numpy(x).to(DEVICE)
        check(same_bits(live_math(xt, fn), torch_op[fn](xt)),
              f"the live kernels' {fn} differs from torch's in some bit")
    return n * len(LIVE_MATH)


def routed_port_demand(topo, demand, schedule, device):
    """The clipped port demand a topology stream folds under a routing
    schedule: each segment's ``routed_cost_series`` row demand (which does
    not depend on the billing calendar), concatenated."""
    from repro_torch.fleet.engine import routed_cost_series

    starts = [s for s, _ in schedule] + [demand.shape[1]]
    return torch.cat([routed_cost_series(topo.stack(r, torch.float64, device), demand[:, a:b],
                                         hours_per_month=topo.hours_per_month,
                                         device=device).row_demand
                      for (a, b), (_, r) in zip(zip(starts, starts[1:]), schedule)], dim=1)


def forecast_live_phase(card: str, fc_ctx: dict, topo_ctx: dict) -> tuple:
    """The forecast-gated policy streamed in live mode on the card (the live
    instances of ``stream_chunk`` and ``stream_chunk_routed``): the live
    kernels' transcendentals against torch's; the forecast phase's 2048-link
    year with its policy and forecaster from ``streaming_forecast_policy``
    (trained on the card on the 4380-hour history, warmed through it), in
    K = 24 chunks and 800 ticks with launches counted, against the card's
    forecaster, and the card's plan_fleet and replay stream of the policy fed
    those forecasts; 2048
    pairs on 128 ports after 4380 hours of history with a per-port
    forecaster and a reroute, against the card's forecaster over the
    realised port demand and replay_plan_topology; both live kernels against
    their plain versions; registers and spills; timings beside the replay
    instances. Returns the two live kernels' rows, and the live policy,
    forecaster and year (its outputs) for the observability phase."""
    from repro_torch.fleet import (FleetRuntime, StreamingForecaster, build_topology_scenario,
                                   fit_cost_coef, forecast_gated_policy, optimize_routing,
                                   plan_fleet, replay_plan_topology, streaming_forecast_policy)
    from repro_torch.fleet.engine import routed_cost_series
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stream_chunk import (TICK_MAX_K_LIVE, _stream_chunk_launch,
                                                  stream_chunk_routed)
    from repro_torch.models.ssm import demand_forecaster_init, demand_forecaster_predict

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    n_math = live_math_checks()
    print(f"live transcendentals: log1p, exp, expm1 (float64) and log1pf (float32) of the "
          f"kernels' build == torch's CUDA ops on {n_math} values, every bit "
          f"({time.perf_counter() - t0:.1f} s)")
    sc, arrays, params = fc_ctx["scenario"], fc_ctx["arrays"], fc_ctx["params"]
    N, T = sc.demand.shape
    H = sc.history.shape[1]
    fields = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
    cap = np.array([l.capacity_gb_hr for l in sc.fleet.links])[:, None]
    hist, clipped = np.minimum(sc.history, cap), np.minimum(sc.demand, cap)

    # -- the main path: the live policy trained on the history
    # (benchmarks/bench_runtime.py:193's call), the year streamed live,
    # launches counted -------------------------------------------------------------
    ops.reset_launches()
    t0 = time.perf_counter()
    pol, fc = streaming_forecast_policy(arrays, sc.history, steps=LIVE_TRAIN_STEPS,
                                        hours_per_month=sc.fleet.hours_per_month)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    warm = {k: v for k, v in ops.LAUNCHES.items() if v}
    want_warm = {"tiered_cost_batched": 1, "forecaster_scan": LIVE_TRAIN_STEPS + 1,
                 "forecaster_scan_bwd": LIVE_TRAIN_STEPS}
    check(warm == want_warm, f"streaming_forecast_policy launched {warm}, not {want_warm} (the "
          f"history's pricing, the training's steps and the warm-up)")
    check(same_bits(torch.as_tensor(fc.scale), torch.as_tensor(np.maximum(hist.mean(axis=1),
                                                                        1e-9))),
          "the trained forecaster's scale is not the clipped history's mean")
    print(f"streaming_forecast_policy({N} links, {H} h of history, steps={LIVE_TRAIN_STEPS}): "
          f"{fit_s:.2f} s on the card, launches {warm}")
    ops.reset_launches()
    rt = FleetRuntime(sc.fleet, policy=pol, forecaster=fc)
    check(rt.device.type == DEVICE.type and rt.pred_source == "live",
          "FleetRuntime did not stream the forecast policy in live mode on the card")
    live_clock = []
    year = stream(rt, sc.demand, STREAM_K, live_clock)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(launches == {"stream_chunk_live": T // STREAM_K},
          f"the live forecast year launched {launches}, not {T // STREAM_K} live stream_chunk")
    ops.reset_launches()
    rt_tick = FleetRuntime(sc.fleet, policy=pol, forecaster=fc)
    tick_us, ticks = [], []
    for t in range(STREAM_TICKS):
        a = time.perf_counter()
        ticks.append(rt_tick.step(sc.demand[:, t]))
        tick_us.append((time.perf_counter() - a) * 1e6)
    torch.cuda.synchronize()
    tick_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(tick_launches == {"stream_chunk_live": STREAM_TICKS},
          f"{STREAM_TICKS} live ticks launched {tick_launches}")
    fleet_launches = T // STREAM_K + STREAM_TICKS
    y = demand_forecaster_predict(fc.params, np.concatenate([hist, clipped], 1), fc.scale)
    check(same_bits(torch.from_numpy(year["pred_next"]), y[:, H:].cpu()),
          "live forecasts != the card's demand_forecaster_predict columns H + t")
    # The replay-mode twin of the live policy: its predictions columns H - 1 + t.
    fpol = pol._replace(pred_demand=y[:, H - 1:H - 1 + T].contiguous())
    replay = stream(FleetRuntime(sc.fleet, policy=fpol), sc.demand, STREAM_K)
    plan = plan_fleet(arrays, sc.demand, policy=fpol)
    for k in fields:
        check(np.array_equal(year[k], replay[k]), f"live year != the replay stream in {k}")
    for k in ("x", "state"):
        check(np.array_equal(year[k], plan[k].cpu().numpy()),
              f"live year: {k} != the card's plan_fleet of the forecast policy")
    flips = int((year["x"] != plan_fleet(arrays, sc.demand)["x"].cpu().numpy()).sum())
    check(flips > 0, "the trained live gates changed no fleet decision")
    for k in fields + ("pred_next",):
        check(same_bits(torch.from_numpy(np.stack([o[k] for o in ticks], 1)),
                        torch.from_numpy(year[k][:, :STREAM_TICKS])),
              f"live per-tick step != chunked step_many in {k}")
    print(f"live forecast stream {N} x {T} (K = {STREAM_K}) after {H} h of history: launches "
          f"{launches} for the year, {tick_launches} for {STREAM_TICKS} ticks; forecasts == the "
          f"card's demand_forecaster_predict columns H + t with the trained parameters, every "
          f"bit; every field == the replay stream of the policy fed them, x/state == the "
          f"card's plan_fleet of it; ticks == chunks in every field and forecast; "
          f"{flips} link-hours decided otherwise than reactive")

    # -- topology: a per-port live forecaster, a reroute mid-year ------------
    t0 = time.perf_counter()
    P = topo_ctx["scenario"].n_pairs
    tsc = build_topology_scenario(P, **TOPO_KW, horizon=T, history_hours=H, seed=SEED)
    M = tsc.n_ports
    r0 = optimize_routing(tsc.topo, tsc.demand)
    r1 = moved_routing(tsc.topo, r0, 64)
    check(r1.paths != r0.paths, "the reroute moves no pair")
    tarr = tsc.topo.stack(r0, torch.float64, DEVICE)
    hseries = routed_cost_series(tarr, tsc.history, hours_per_month=tsc.topo.hours_per_month,
                                 device=DEVICE)
    coef = fit_cost_coef(hseries.row_demand, hseries.vpn, hseries.cci)
    tfc = StreamingForecaster.from_history(params, hseries.row_demand)
    tpol = forecast_gated_policy(tarr.toggle, np.zeros(M), margin=0.05, cost_coef=coef)
    print(f"live topology scenario {P} pairs x {T} h after {H} h of history on {M} ports "
          f"({time.perf_counter() - t0:.1f} s)")

    def topo_year(policy, forecaster, clock):
        rt_ = FleetRuntime(tsc.topo, routing=r0, policy=policy, forecaster=forecaster)
        outs, t = [], 0
        while t < T:
            if t == FS_SWAP:
                rt_.reroute(r1)
            a = time.perf_counter()
            outs.append(rt_.step_many(tsc.demand[:, t:t + STREAM_K]))
            clock.append(time.perf_counter() - a)
            t += STREAM_K
        torch.cuda.synchronize()
        return {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}

    ops.reset_launches()
    topo_clock = []
    tyear = topo_year(tpol, tfc, topo_clock)
    topo_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(topo_launches == {"stream_chunk_routed_live": T // STREAM_K},
          f"the rerouted live topology year launched {topo_launches}")
    schedule = [(0, r0), (FS_SWAP, r1)]
    port_d = routed_port_demand(tsc.topo, tsc.demand, schedule, DEVICE)
    ty = demand_forecaster_predict(params, torch.cat([hseries.row_demand, port_d], 1),
                                   tfc.scale)
    check(same_bits(torch.from_numpy(tyear["pred_next"]), ty[:, H:].cpu()),
          "live topology forecasts != the card's predictions over the realised port demand")
    rpol = tpol._replace(pred_demand=ty[:, H - 1:H - 1 + T].contiguous())
    rep = replay_plan_topology(tarr, tsc.demand, schedule, policy=rpol)
    cpu_rep = replay_plan_topology(tsc.topo.stack(r0, torch.float64, "cpu"), tsc.demand,
                                   schedule, device="cpu")
    for k, want in (("x", rep["x"]), ("state", rep["state"]),
                    ("vpn_cost", cpu_rep["vpn_hourly"]), ("cci_cost", cpu_rep["cci_hourly"])):
        check(np.array_equal(tyear[k], want.cpu().numpy()),
              f"live topology year: {k} != the " + (
                  "card's replay_plan_topology fed the live forecasts" if k in ("x", "state")
                  else "CPU replay_plan_topology's series"))
    tflips = int((tyear["x"] != cpu_rep["x"].numpy()).sum())
    check(tflips > 0, "the live gates changed no topology decision")
    print(f"live topology stream, reroute of {sum(a != b for a, b in zip(r0.paths, r1.paths))} "
          f"pairs at hour {FS_SWAP}: launches {topo_launches}; forecasts == the card's "
          f"demand_forecaster_predict over the realised port demand, x/state == the card's "
          f"replay_plan_topology fed them, vpn_cost/cci_cost == the CPU replay's series, bit "
          f"for bit; {tflips} port-hours decided otherwise than reactive "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- both live kernels against their plain versions ------------------------
    t_cases = time.perf_counter()
    rng = np.random.default_rng(SEED + 1)
    other = {}
    for S in LIVE_STATES:
        p_ = demand_forecaster_init(None, S, device=DEVICE)
        p_ = dict(p_, w=torch.tensor(0.3 * rng.standard_normal(S), dtype=torch.float32,
                                     device=DEVICE))
        other[S] = StreamingForecaster.from_history(p_, hist)
    nan_d = sc.demand.copy()
    nan_d[::7, 700] = np.nan
    rows_m = pol._replace(margin=torch.as_tensor(np.resize([0.0, 0.05, 0.15, 1e30], N),
                                                 device=DEVICE))
    fleet, demand = sc.fleet, sc.demand
    cases = {
        f"4 chained K = {STREAM_K} from hour 696": (pol, fc, demand, 696, [STREAM_K] * 4, None),
        "endogenous CCI demand, 2 x K = 24": (pol, fc, demand, 696, [24] * 2, demand * 1.5),
        "K = 1 over hours 728..731": (pol, fc, demand, 728, [1] * 4, None),
        "NaN demand in every 7th link at hour 700, 2 x K = 24": (pol, fc, nan_d, 696, [24] * 2,
                                                                 None),
        "margins 0, 0.05, 0.15, 1e30 by link, K = 24, 1, 30": (rows_m, fc, demand, 696,
                                                               [24, 1, 30], None),
        "S = 1: K = 24, 5": (pol, other[1], demand, 696, [24, 5], None),
        "S = 16: K = 24, 5, 9": (pol, other[16], demand, 696, [24, 5, 9], None),
    }
    for S in LIVE_STATES[2:]:   # 17, 33 and 100: past one pass of 16 states
        cases[f"S = {S}: K = 24, 3, 5, 9, 30"] = (pol, other[S], demand, 696, [24, 3, 5, 9, 30],
                                                  None)
    for K in (2, 3, TICK_MAX_K_LIVE, TICK_MAX_K_LIVE + 1, 8, 9, 17, 23, 25):
        cases[f"3 chained K = {K} from hour 726"] = (pol, fc, demand, 726, [K] * 3, None)
    live_err = 0.0
    for label, (p_, f_, d_, t_, Ks, c_) in cases.items():
        live_err = max(live_err, chunk_case(fleet, d_, t_, Ks, c_, policy=p_, forecaster=f_))
        print(f"  live stream_chunk == stream_chunk_ref with the live operands, every output "
              f"bit and the forecaster's state: {label}")
    print(f"live stream_chunk: {len(cases)} cases at {N} links equal the plain version on the "
          f"card ({time.perf_counter() - t_cases:.1f} s)")
    t_cases = time.perf_counter()
    bad = tsc.demand.copy()
    bad[0, [666, 699, 706]] = np.nan
    padded = r0.pad_to(r0.total_hops + NAN_PAD)
    tcases = {
        "4 chained K = 24 from hour 696": (r0, tsc.demand, 696, [24] * 4, None, tfc),
        "K = 1 over hours 728..731": (r0, tsc.demand, 728, [1] * 4, None, tfc),
        f"NaN demand in pair 0, {NAN_PAD} padding legs, 2 x K = 24": (padded, bad, 696,
                                                                     [24] * 2, None, tfc),
        "endogenous CCI demand: K = 24, 5, 33 from hour 726": (r0, tsc.demand, 726, [24, 5, 33],
                                                               tsc.demand * 1.5, tfc),
    }
    port_hist = hseries.row_demand
    for S in LIVE_STATES[2:]:   # 33 and 100 past one pass of 32 states
        p_ = dict(demand_forecaster_init(None, S, device=DEVICE),
                  w=torch.tensor(0.3 * rng.standard_normal(S), dtype=torch.float32,
                                 device=DEVICE))
        tcases[f"S = {S}: K = 24, 1, 33 from hour 696"] = (
            r0, tsc.demand, 696, [24, 1, 33], None,
            StreamingForecaster.from_history(p_, port_hist))
    routed_err = 0.0
    for label, (r_, d_, t_, Ks, c_, f_) in tcases.items():
        routed_err = max(routed_err, chunk_case(tsc.topo, d_, t_, Ks, c_, routing=r_,
                                                policy=tpol, forecaster=f_))
        print(f"  live stream_chunk_routed == stream_chunk_routed_ref with the live operands, "
              f"every output bit and the forecaster's state: {label}")
    print(f"live stream_chunk_routed: {len(tcases)} cases equal the plain version on the card "
          f"({time.perf_counter() - t_cases:.1f} s)")

    # -- registers and spills of the live instances ----------------------------
    print_stream_registers(("live",))

    # -- timings ----------------------------------------------------------------
    replay_clock, live_clock2, treplay_clock, tlive_clock2 = [], [], [], []
    stream(FleetRuntime(sc.fleet, policy=fpol), sc.demand, STREAM_K, replay_clock)
    stream(FleetRuntime(sc.fleet, policy=pol, forecaster=fc), sc.demand, STREAM_K, live_clock2)
    topo_year(rpol, None, treplay_clock)
    topo_year(tpol, tfc, tlive_clock2)
    print(f"live streaming timings on {card} (profiler device time, median ms; bound = "
          f"max(bytes / 3.35 TB/s, ops / peak))")
    for label, clock in (("live (the main path, first)", live_clock),
                         ("replay", replay_clock), ("live again", live_clock2),
                         ("live topology (first)", topo_clock),
                         ("replay topology", treplay_clock), ("live topology again", tlive_clock2)):
        ms = np.array(clock) * 1e3
        print(f"  {label} year in K = {STREAM_K} chunks: chunk p50 {np.percentile(ms, 50):.3f} "
              f"ms, p99 {np.percentile(ms, 99):.3f} ms, mean {ms.mean():.3f} ms")
    tick = np.array(tick_us)
    print(f"  live per-tick step {N} links: p50 {np.percentile(tick, 50):.1f} us, p99 "
          f"{np.percentile(tick, 99):.1f} us")
    rt_l = FleetRuntime(sc.fleet, policy=pol, forecaster=fc)
    rt_r = FleetRuntime(sc.fleet, policy=fpol)
    stream(rt_l, sc.demand[:, :SWEEP_T0], STREAM_K)
    stream(rt_r, sc.demand[:, :SWEEP_T0], STREAM_K)
    Kt = rt_l.arrays.tier_bounds.shape[1]
    S = tfc.h0.shape[1]
    times = {}
    for K in LIVE_TIMED_K:
        block, _, _ = rt_l._pack(sc.demand[:, SWEEP_T0:SWEEP_T0 + K], None)
        args = rt_l._chunk_args(torch.from_numpy(block).to(DEVICE), K, False)
        rblock, _, _ = rt_r._pack(sc.demand[:, SWEEP_T0:SWEEP_T0 + K], None)
        check(np.array_equal(block, rblock), "the live and replay runtimes' blocks differ")
        st = rt_l._state
        live = (st.ssm_h, st.pred_live, *rt_l._live)
        want = ref.stream_chunk_ref(*args, live=live)
        live_call = lambda: _stream_chunk_launch("auto", *args, live=live)
        got = live_call()
        check(all(same_bits(g, w) for g, w in zip(got, want)),
              f"live stream_chunk {N} x K={K} != plain at the timed block")
        l_ms = device_ms_per_call(live_call, 20, "stream_chunk", 1)
        g_ms = device_ms_per_call(lambda: _stream_chunk_launch("auto", *args, gate=rt_r._gate),
                                  20, "stream_chunk", 1)
        l2_ms = device_ms_per_call(live_call, 20, "stream_chunk", 1)
        b = live_bound(*stream_chunk_work(N, K, Kt, False), N, K, S)
        times[K] = {"ms": l_ms, "ms2": l2_ms, "replay_ms": g_ms,
                    "plain_ms": sync_ms(lambda: ref.stream_chunk_ref(*args, live=live), 3), **b}
        tk = times[K]
        form = "tick" if K <= TICK_MAX_K_LIVE else "chunk"
        other = ""
        if K <= TICK_MAX_K_LIVE:   # the chunk form where the tick form launches
            o_form = "chunk"
            o_call = lambda: _stream_chunk_launch(o_form, *args, live=live)
            check(all(same_bits(g, w) for g, w in zip(o_call(), want)),
                  f"live stream_chunk {o_form} form {N} x K={K} != plain")
            other = (f"; {o_form} form "
                     f"{device_ms_per_call(o_call, 20, 'stream_chunk', 1):.5f} ms")
        before = BEFORE_OVERLAP_MS.get(f"stream_chunk live {N}x{K}")
        print(f"  stream_chunk live {N} x K={K} ({form} form, S = {S}): {l_ms:.5f} / "
              f"{l2_ms:.5f} ms (before the redesign {before}), replay instance {g_ms:.5f} ms "
              f"(in turns), live - replay {(l_ms - g_ms) * 1e3:.3f} us{other}; bound "
              f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), {l_ms / b['bound_ms']:.2f}x "
              f"bound; plain {tk['plain_ms']:.3f} ms")
    print_breakdown(lambda: rt_l.step_many(sc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K]), reps=6,
                    unit="live chunk")
    print_breakdown(lambda: rt_r.step_many(sc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K]), reps=6,
                    unit="replay chunk")
    trt_l = FleetRuntime(tsc.topo, routing=r0, policy=tpol, forecaster=tfc)
    trt_r = FleetRuntime(tsc.topo, routing=r0, policy=rpol)
    stream(trt_l, tsc.demand[:, :SWEEP_T0], STREAM_K)
    stream(trt_r, tsc.demand[:, :SWEEP_T0], STREAM_K)
    # Every gate mode of the routed chunk at K = 24 and K = 1, in turns (live,
    # replay, reactive, reactive, replay, live), each beside its byte bound and
    # its latency floor.
    E = trt_l.arrays.routing.n_legs
    E_max = hottest_port_legs(trt_l.arrays.routing)
    span = lambda fn: device_ms_per_call(fn, 20, ROUTED_KERNEL, 1)
    turns = {}
    for K in (STREAM_K, 1):
        block, _, _ = trt_l._pack(tsc.demand[:, SWEEP_T0:SWEEP_T0 + K], None)
        targs = trt_l._chunk_args(torch.from_numpy(block).to(DEVICE), K, False)
        rblock, _, _ = trt_r._pack(tsc.demand[:, SWEEP_T0:SWEEP_T0 + K], None)
        rargs = trt_r._chunk_args(torch.from_numpy(rblock).to(DEVICE), K, False)
        st = trt_l._state
        tlive = (st.ssm_h, st.pred_live, *trt_l._live)
        twant = ref.stream_chunk_routed_ref(*targs, live=tlive)
        calls = {"live": lambda: stream_chunk_routed(*targs, live=tlive),
                 "replay": lambda: stream_chunk_routed(*rargs, gate=trt_r._gate),
                 "reactive": lambda: stream_chunk_routed(*rargs)}
        check(all(same_bits(g, w) for g, w in zip(calls["live"](), twant)),
              f"live stream_chunk_routed K = {K} != plain at the timed block")
        got = {mode: [] for mode in calls}
        for mode in ("live", "replay", "reactive", "reactive", "replay", "live"):
            got[mode].append(span(calls[mode]))
        bounds = {"live": live_bound(*routed_chunk_work(P, M, K, Kt, E, False), M, K, S),
                  "replay": routed_chunk_bound(P, M, K, Kt, E, False, gated=True),
                  "reactive": routed_chunk_bound(P, M, K, Kt, E, False)}
        for mode in calls:
            lat = routed_latency_floor(P, M, K, Kt, E_max, live=mode == "live", S=S)
            b = bounds[mode]
            turns[(mode, K)] = {"ms": got[mode][0], "ms2": got[mode][1], **b, **lat}
            print(f"  stream_chunk_routed {mode} {P} pairs x K={K} on {M} ports, {E} legs "
                  f"(hottest port {E_max}), the call's span in turns: {got[mode][0]:.5f} / "
                  f"{got[mode][1]:.5f} ms; bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), "
                  f"{got[mode][0] / b['bound_ms']:.1f}x; latency floor {lat['floor_ms']:.5f} ms "
                  f"(empty kernel at {lat['grid']} x {lat['threads']} {lat['empty_ms']:.5f} + "
                  f"chain {lat['chain_ms']:.5f}), {got[mode][0] / lat['floor_ms']:.2f}x it")
        if K == STREAM_K:
            tb, t_ms = bounds["live"], got["live"][0]
            t_plain = sync_ms(lambda: ref.stream_chunk_routed_ref(*targs, live=tlive), 3)
    print(f"  live - replay in the same run, K = {STREAM_K}: "
          f"{(turns[('live', STREAM_K)]['ms'] - turns[('replay', STREAM_K)]['ms']) * 1e3:.3f} us; "
          f"live plain {t_plain:.3f} ms")
    print_breakdown(lambda: trt_l.step_many(tsc.demand[:, SWEEP_T0:SWEEP_T0 + STREAM_K]), reps=6,
                    unit="live topology chunk")
    print(f"forecast live phase: {time.perf_counter() - t_phase:.1f} s")
    t24 = times[STREAM_K]
    live_ctx = {"scenario": sc, "policy": pol, "forecaster": fc,
                "year": {k: year[k] for k in ("x", "state", "cost", "pred_next")}}
    return {
        "stream_chunk_live": {
            "launches": fleet_launches, "max_abs_err": live_err, "ms": t24["ms"],
            "plain_ms": t24["plain_ms"], "bound_ms": t24["bound_ms"],
            "bound_by": t24["bound_by"], "library_ms": None},
        "stream_chunk_routed_live": {
            "launches": topo_launches["stream_chunk_routed_live"], "max_abs_err": routed_err,
            "ms": t_ms, "plain_ms": t_plain, "bound_ms": tb["bound_ms"],
            "bound_by": tb["bound_by"], "library_ms": None},
    }, live_ctx


OBS_CADENCE = 3 * STREAM_K   # benchmarks/bench_runtime.py:171's drain cadence, 3 x chunk_k
OBS_SMALL = (256, 720)       # links (pairs) x hours of the card-vs-CPU drains
OBS_FAULT_HOUR = 40          # the hour whose recorded decisions the injected fault flips
OBS_TICK_K = 16              # chunks held against the observed ticks (divides cadence 64)


def timed_method(obj, name: str, clock: dict, key: str) -> None:
    """Replace ``obj.name`` by a wrapper adding its host seconds to ``clock[key]``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kw):
        a = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            clock[key] += time.perf_counter() - a

    setattr(obj, name, wrapper)


def obs_dump(rt) -> str:
    """A runtime's drained windows, monitor summaries and trace events as
    JSON text (every float's shortest round-trip repr): equal text, equal bits."""
    return json.dumps([[d.to_json() for d in rt.obs.drained], rt.obs.monitor_summaries(),
                       rt.obs.trace.events])


def lease_edges(state: np.ndarray) -> tuple:
    """Requests, activations and releases in a (rows, T) state matrix that
    starts from OFF."""
    st = np.concatenate([np.zeros((state.shape[0], 1), state.dtype), state], axis=1)
    prev, cur = st[:, :-1], st[:, 1:]
    return (int(((prev == 0) & (cur != 0)).sum()), int(((prev != 2) & (cur == 2)).sum()),
            int(((prev == 2) & (cur == 0)).sum()))


def obs_phase(card: str, fleet_scen, fleet_plan, topo_ctx: dict, live_ctx: dict) -> None:
    """Observability on the streaming runtime (``FleetRuntime(obs=...)``):
    the 2048-link year with the ring, trace, monitors and profiler on, in
    turns with the stream without them, launches counted; the same year with
    the divergence replay and the regret oracle checked on the card; the
    rerouted 2048-pair topology year; the live forecast year; 800 ticks; the
    card's drains against the CPU's; one injected fault. Adds no kernel."""
    from repro_torch.fleet import (FleetRuntime, build_fleet_scenario, build_report,
                                   build_topology_scenario, optimize_routing)
    from repro_torch.kernels import ops
    from repro_torch.obs import ContractViolation, ObsConfig

    t_phase = time.perf_counter()
    sc = fleet_scen
    N, T = sc.demand.shape
    K = STREAM_K
    fields = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
    active = lambda: {k: v for k, v in ops.LAUNCHES.items() if v}

    # -- the main path: the year with observability on, in turns with it off ----
    ops.reset_launches()
    rt_off = FleetRuntime(sc.fleet)
    rt_on = FleetRuntime(sc.fleet, obs=ObsConfig(cadence=OBS_CADENCE))
    check(rt_on.device.type == DEVICE.type and rt_on.obs is not None,
          "FleetRuntime(obs=) did not stream on the card with an observer")
    host = {"operands": 0.0, "observe": 0.0, "fanout": 0.0, "drain": 0.0}
    timed_method(rt_on, "_ring_operands", host, "operands")
    timed_method(rt_on, "_observe", host, "observe")
    timed_method(rt_on.obs, "record_chunk", host, "fanout")
    timed_method(rt_on.obs, "record_drain", host, "drain")
    clocks = {rt_off: [], rt_on: []}
    off_out = {k: [] for k in ("x", "state")}
    for i, t in enumerate(range(0, T, K)):
        outs = {}
        for rt in ((rt_off, rt_on) if i % 2 == 0 else (rt_on, rt_off)):   # in turns
            a = time.perf_counter()
            outs[rt] = rt.step_many(sc.demand[:, t:t + K])
            clocks[rt].append(time.perf_counter() - a)
        for k in fields:
            check(np.array_equal(outs[rt_on][k], outs[rt_off][k]),
                  f"obs on != obs off in {k} at hours {t}..{t + K - 1}")
        for k in off_out:
            off_out[k].append(outs[rt_off][k])
    torch.cuda.synchronize()
    launches = active()
    check(launches == {"stream_chunk": 2 * (T // K)},
          f"the year with and without observability launched {launches}, not "
          f"{2 * (T // K)} stream_chunk")
    off_out = {k: np.concatenate(v, 1) for k, v in off_out.items()}
    for k in ("dcum", "dcum_month", "vpn_pref", "cci_pref"):
        check(np.array_equal(getattr(rt_on._state, k), getattr(rt_off._state, k)),
              f"obs on != obs off in the carried {k}")
    check(torch.equal(rt_on._state.fsm, rt_off._state.fsm), "obs on != obs off in the FSM carry")
    rep = rt_on.obs_report()
    want_drains = -(-T // OBS_CADENCE)
    check(rep.drains == want_drains and rep.hours == T and rep.violations == [],
          f"obs report: {rep.drains} drains (want {want_drains}), {rep.hours} h, "
          f"violations {rep.violations}")
    check((rep.requests, rep.activations, rep.releases) == lease_edges(off_out["state"]),
          "the drained lease counts != the counts in the year's state matrix")
    on_ms, off_ms = np.array(clocks[rt_on]) * 1e3, np.array(clocks[rt_off]) * 1e3
    n = len(on_ms)
    ring_us = (host["operands"] + host["observe"] - host["fanout"] - host["drain"]) / n * 1e6
    print(f"observed fleet stream {N} x {T} (K = {K}, cadence {OBS_CADENCE}) on the card, in "
          f"turns with the stream without observability: launches {launches}; every output, "
          f"the host carries and the FSM carry bit-equal to obs off; {rep.drains} drains; lease "
          f"counts == the state matrix's")
    print(f"  chunk p50 {np.percentile(on_ms, 50):.3f} ms obs on vs {np.percentile(off_ms, 50):.3f} "
          f"ms off (ratio {np.percentile(on_ms, 50) / np.percentile(off_ms, 50):.3f}); p99 "
          f"{np.percentile(on_ms, 99):.3f} vs {np.percentile(off_ms, 99):.3f} ms (ratio "
          f"{np.percentile(on_ms, 99) / np.percentile(off_ms, 99):.3f}); mean {on_ms.mean():.3f} "
          f"vs {off_ms.mean():.3f} ms; on {card}")
    print(f"  host us a chunk: ring {ring_us:.1f} (its operands {host['operands'] / n * 1e6:.1f}: "
          f"clip, month volume, while the kernel runs), observer's per-hour fan-out "
          f"{host['fanout'] / n * 1e6:.1f}, drain {host['drain'] / n * 1e6:.1f} "
          f"({host['drain'] / max(rep.drains - 1, 1) * 1e6:.1f} a drain)")
    for line in rep.render_text().splitlines():
        print(f"  | {line}")

    # -- the same year checked: the divergence replay and the regret oracle -------
    ops.reset_launches()
    rt_chk = FleetRuntime(sc.fleet, obs=ObsConfig(cadence=OBS_CADENCE, divergence=True,
                                                  max_oracle_ratio=float("inf")))
    chk = stream(rt_chk, sc.demand, K)
    torch.cuda.synchronize()
    check(active() == {"stream_chunk": T // K}, f"the checked year launched {active()}")
    for k in ("x", "state"):
        check(np.array_equal(chk[k], off_out[k]), f"the checked year != obs off in {k}")
    ops.reset_launches()
    t0 = time.perf_counter()
    rt_chk.obs_check(final=True)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    chk_launches = active()
    check(chk_launches.get("fsm_scan") == 1 and chk_launches.get("tiered_cost_batched", 0) >= 1
          and chk_launches.get("oracle_dp") in (1, 2) and "stream_chunk" not in chk_launches,
          f"obs_check launched {chk_launches}: want the replay's plan_fleet and one oracle_dp call")
    div = rt_chk.obs.divergence.summary()
    check(div["checks"] == 1 and div["recorded_hours"] == T, f"divergence monitor: {div}")
    ratio = rt_chk.obs.regret.oracle_ratio
    t0 = time.perf_counter()
    report = build_report(sc, fleet_plan, include_oracle=True)
    tot = report.totals
    opt_ratio = tot["togglecci"] / tot["oracle"]
    check(abs(ratio / opt_ratio - 1.0) < 1e-9, f"the regret oracle's ratio {ratio} != the "
          f"report's OPT ratio {opt_ratio}")
    print(f"checked year: obs_check(final=True) passed in {check_s:.2f} s, launches "
          f"{chk_launches} (the divergence replay: plan_fleet of the {T} recorded hours on the "
          f"card, decisions equal; the regret oracle: one oracle_dp call); realized / oracle "
          f"{ratio:.9f} beside build_report's toggle / OPT {opt_ratio:.9f} "
          f"({time.perf_counter() - t0:.2f} s)")

    # -- topology: the 2048-pair year with a reroute of 64 pairs -------------------
    tsc, r0 = topo_ctx["scenario"], topo_ctx["routing"]
    P, M = tsc.n_pairs, tsc.n_ports
    r1 = moved_routing(tsc.topo, r0, 64)
    ops.reset_launches()
    trt = FleetRuntime(tsc.topo, routing=r0,
                       obs=ObsConfig(cadence=OBS_CADENCE, divergence=True))
    tclock = []
    for t in range(0, T, K):
        if t == FS_SWAP:
            trt.reroute(r1)
        a = time.perf_counter()
        trt.step_many(tsc.demand[:, t:t + K])
        tclock.append(time.perf_counter() - a)
    torch.cuda.synchronize()
    check(active() == {"stream_chunk_routed": T // K}, f"the topology year launched {active()}")
    ops.reset_launches()
    trt.obs_check(final=True)
    torch.cuda.synchronize()
    tchk = active()
    check(tchk.get("fsm_scan") == 1 and tchk.get("leg_segment_sum", 0) >= 1,
          f"the topology obs_check launched {tchk}: want replay_plan_topology's kernels")
    tdiv = trt.obs.divergence.summary()
    check(tdiv["checks"] == 1 and tdiv["routing_segments"] == 2, f"divergence: {tdiv}")
    moves = [e for e in trt.obs.trace.events if e["type"] == "reroute"]
    check(len(moves) == 1 and moves[0]["hour"] == FS_SWAP and moves[0]["moved_pairs"] > 0,
          f"the trace's reroute instants: {moves}")
    trep = trt.obs_report()
    tms = np.array(tclock) * 1e3
    print(f"observed topology stream {P} pairs x {T} h on {M} ports, reroute at hour {FS_SWAP} "
          f"({moves[0]['moved_pairs']} pairs moved, traced): {T // K} stream_chunk_routed; "
          f"obs_check passed across the swap (replay_plan_topology of the 2-segment schedule "
          f"on the card, launches {tchk}); {trep.drains} drains, {trep.trace_events} trace "
          f"events; chunk p50 {np.percentile(tms, 50):.3f} ms, p99 {np.percentile(tms, 99):.3f}")

    # -- the live forecast year ------------------------------------------------------
    lsc, year = live_ctx["scenario"], live_ctx["year"]
    ops.reset_launches()
    lrt = FleetRuntime(lsc.fleet, policy=live_ctx["policy"], forecaster=live_ctx["forecaster"],
                       obs=ObsConfig(cadence=OBS_CADENCE, divergence=True))
    lclock = []
    lout = stream(lrt, lsc.demand, K, lclock)
    torch.cuda.synchronize()
    check(active() == {"stream_chunk_live": T // K}, f"the live year launched {active()}")
    for k, want in year.items():
        check(np.array_equal(lout[k], want), f"the observed live year != obs off in {k}")
    lrt.obs_check(final=True)
    ldiv, lcal = lrt.obs.divergence.summary(), lrt.obs.calibration.summary()
    check(not ldiv["enabled"] and ldiv["reason"] == ("live forecaster carries SSM state the "
                                                    "offline engines lack"),
          f"live mode: divergence {ldiv}")
    check(lcal["enabled"] and np.isfinite(lcal["bias"]) and lcal["bias"] > 0,
          f"live mode: calibration {lcal}")
    lms = np.array(lclock) * 1e3
    print(f"observed live forecast year {N} x {T}: {T // K} stream_chunk_live; every output "
          f"and forecast == the year without observability; divergence off ({ldiv['reason']}); "
          f"calibration bias {lcal['bias']:.4f}, MAE {lcal['mae_gb_per_h']:.3f} GB/h a row; "
          f"chunk p50 {np.percentile(lms, 50):.3f} ms, p99 {np.percentile(lms, 99):.3f}")

    # -- per tick, the default cadence -----------------------------------------------
    ops.reset_launches()
    prt = FleetRuntime(sc.fleet, obs=True)
    tick_us = []
    ticks = []
    for t in range(STREAM_TICKS):
        a = time.perf_counter()
        ticks.append(prt.step(sc.demand[:, t]))
        tick_us.append((time.perf_counter() - a) * 1e6)
    torch.cuda.synchronize()
    check(active() == {"stream_chunk": STREAM_TICKS}, f"{STREAM_TICKS} observed ticks launched "
          f"{active()}")
    for k in ("x", "state"):
        check(np.array_equal(np.stack([o[k] for o in ticks], 1), off_out[k][:, :STREAM_TICKS]),
              f"observed ticks != the chunked year in {k}")
    prep = prt.obs_report()
    check(prep.drains == -(-STREAM_TICKS // prt.obs.cadence)
          and (prep.requests, prep.activations, prep.releases)
          == lease_edges(off_out["state"][:, :STREAM_TICKS]),
          f"per-tick report: {prep.drains} drains, lease counts "
          f"{(prep.requests, prep.activations, prep.releases)}")
    # The same hours in chunks of 16 (dividing the cadence): the same drains,
    # bit for bit, at full width on this host's numpy.
    crt = FleetRuntime(sc.fleet, obs=True)
    stream(crt, sc.demand[:, :STREAM_TICKS], OBS_TICK_K)
    crt.obs_report()
    check(obs_dump(crt) == obs_dump(prt), f"{N} x {STREAM_TICKS}: chunks of {OBS_TICK_K} drain "
          f"otherwise than ticks")
    tk = np.array(tick_us)
    print(f"observed ticks {N} x {STREAM_TICKS} (cadence {prt.obs.cadence}): {STREAM_TICKS} "
          f"stream_chunk; decisions == the chunked year; {prep.drains} drains, lease counts == "
          f"the state matrix's; every drain, monitor summary and trace event == the same hours "
          f"in chunks of {OBS_TICK_K}; tick p50 {np.percentile(tk, 50):.1f} us, p99 "
          f"{np.percentile(tk, 99):.1f} us")

    # -- the card's drains against the CPU's, chunked against per tick ---------------
    t0 = time.perf_counter()
    n_small, T_small = OBS_SMALL
    fsmall = build_fleet_scenario(n_small, horizon=T_small, seed=SEED)
    tsmall = build_topology_scenario(n_small, **TOPO_KW, horizon=T_small, seed=SEED)
    rs = optimize_routing(tsmall.topo, tsmall.demand)
    cfg = ObsConfig(cadence=OBS_CADENCE, divergence=True, max_oracle_ratio=float("inf"))
    card_rts = {}
    for name, spec, kw, d in (("fleet", fsmall.fleet, {}, fsmall.demand),
                              ("topology", tsmall.topo, {"routing": rs}, tsmall.demand)):
        dumps = {}
        for run, dev in (("card", DEVICE), ("cpu", torch.device("cpu")), ("card ticks", DEVICE)):
            rt = FleetRuntime(spec, obs=cfg, device=dev, **kw)
            if run == "card ticks":
                for t in range(T_small):
                    rt.step(d[:, t])
            else:
                stream(rt, d, K)
            rt.obs_check(final=True)
            dumps[run] = obs_dump(rt)
            card_rts.setdefault(name, rt)
        check(dumps["card"] == dumps["cpu"], f"{name} {n_small} x {T_small}: the card's drains, "
              f"monitor summaries or trace != the CPU's")
        check(dumps["card"] == dumps["card ticks"], f"{name} {n_small} x {T_small}: chunked "
              f"drains != per-tick drains on the card")
    print(f"card == CPU at {n_small} x {T_small} (K = {K}, cadence {OBS_CADENCE}), fleet and "
          f"topology: every drained window, monitor summary and trace event, bit for bit; and == "
          f"the card's per-tick streams ({time.perf_counter() - t0:.1f} s)")

    # -- one injected fault ---------------------------------------------------------------
    rt = card_rts["fleet"]
    mon = rt.obs.divergence
    mon.x[OBS_FAULT_HOUR] = 1 - mon.x[OBS_FAULT_HOUR]
    try:
        rt.obs_check(final=True)
    except ContractViolation as v:
        check(v.monitor == "divergence" and v.hour == OBS_FAULT_HOUR,
              f"the injected fault raised {v}")
        print(f"injected fault (hour {OBS_FAULT_HOUR}'s recorded decisions flipped): "
              f"ContractViolation raised: {v}")
    else:
        check(False, "a flipped recorded decision passed obs_check")
    print(f"observability phase: {time.perf_counter() - t_phase:.1f} s")


GW_SHAPE = (256, 32)        # benchmarks/bench_gateway.py:45: tenants x links a tenant
GW_CADENCE, GW_WARM, GW_TICKS = 64, 80, 400     # bench_gateway.py:63-100: cadence 64, warm-up
                                                # cadence + 16 ticks, 400 timed ticks
GW_CHUNK = (24, 72, 6, 12)  # bench_gateway.py:150-177: K, cadence, warm-up and timed chunks
GW_HETERO = (256, 6)        # tests/test_gateway.py:237-273: 2-link tenants, ticks (then a chunk)
GW_TOPO = (32, 720, 4)      # pairs, hours, tenants of each policy in the mixed gateway
GW_TOPO_KW = dict(n_facilities=4, ports_per_facility=2)
GW_TOPO_TICKS, GW_REROUTE, GW_LEAVE = 144, 96, 240   # ticks, then chunks; the swap; the leave
GW_TOPO_BIG_TICKS = 4       # ticks of the two 128-slot topology buckets (then a chunk)
GW_SMALL = (3, 16, 168)     # card vs CPU: tenants of each kind, links, hours
GW_SPLIT_TICKS, GW_SPLIT_CHUNKS = 60, 3   # the host split's window: ticks (collect on and
                                          # off in turns), chunks (one cadence)
GW_TIMED_K = (1, 24)
# The staggered buckets: tenant i joins at gateway hour i // 4 and bills
# months of GW_STAGGER_HPM[i % 4] hours, the gateway ticks 20 hours past the
# last join; replay tenants predict GW_STAGGER_PRED[i % 4] hours. The forms
# and K each pooled instance is held to its plain version at.
GW_STAGGER_JOINS, GW_STAGGER_AFTER = 4, 20
GW_STAGGER_HPM = (24, 40, 168, 730)
GW_STAGGER_PRED = (70, 100, 128, 90)
GW_STAGGER_FORMS = {False: (("tick", 1), ("chunk", 1), ("tick", 5), ("chunk", 24), ("chunk", 25)),
                    True: (("auto", 1), ("auto", 24), ("auto", 40))}
LATE = "topo-late"          # joins the mixed gateway into the slot the leave frees
LATE_HPM = 40               # its calendar: month starts inside the chunks of 24
POOLED = ("stream_chunk_pooled", "stream_chunk_pooled_gated", "stream_chunk_routed_pooled",
          "stream_chunk_routed_pooled_gated")
STEP_FIELDS = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")


def gw_call(gw, fn, counts: dict):
    """``fn()`` (a gateway's tick or chunk), failing unless it launched the
    pooled instances once per non-empty bucket and no other kernel, each
    topology bucket's launch in the form the selection rule takes for its
    block-diagonal routing (``routed_form`` of the hottest port and the
    port count its index recorded on the host: the small-port form from 133
    ports of few legs on, else the port-block form; a bucket's at most 32
    rows of 4 tiers without CCI demand fit the small-port form's shared
    memory at every K); the launches (and the small-port form's count) are
    added to ``counts``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.stream_chunk import routed_form

    buckets = gw._live_buckets()
    live = len(buckets)
    want_small = sum(b.key.topology and routed_form(b.routing.index.max_legs,
                                                    b.routing.index.n_ports) == "small_port"
                     for b in buckets)
    before = dict(ops.LAUNCHES)
    out = fn()
    delta = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    small = delta.pop(SMALL_PORT, 0)
    check(set(delta) <= set(POOLED) and sum(delta.values()) == live,
          f"a gateway call over {live} non-empty buckets launched {delta}")
    routed = sum(v for k, v in delta.items() if "routed" in k)
    check(small == want_small, f"a gateway call's {routed} topology-bucket launches took the "
          f"small-port form {small} times, the rule {want_small}")
    if small:
        delta[SMALL_PORT] = small
    for k, v in delta.items():
        counts[k] = counts.get(k, 0) + v
    return out


def host_split(gw, step, n: int, collect_turns: bool = False) -> dict:
    """Host milliseconds a call of ``step(collect)`` over ``n`` calls, split
    by wrapping the gateway's ``_pack``, ``_ring_operands``, ``_observe``
    (the ring update) and ``_drain_slot`` (a tenant's drain and SLO check)
    and its buckets' ``launch`` (the enqueue): the rest is the copy back,
    the commit and the outputs. With ``collect_turns`` every other call skips
    the per-tenant output dicts (``collect=False``), and their cost is the
    difference of the two means."""
    clock = {k: 0.0 for k in ("pack", "launch", "ring operands", "ring update", "drains")}
    for name, key in (("_pack", "pack"), ("_ring_operands", "ring operands"),
                      ("_observe", "ring update"), ("_drain_slot", "drains")):
        timed_method(gw, name, clock, key)
    for b in gw._live_buckets():
        timed_method(b, "launch", clock, "launch")
    walls = {True: [], False: []}
    for i in range(n):
        collect = not (collect_turns and i % 2)
        a = time.perf_counter()
        step(collect)
        walls[collect].append(time.perf_counter() - a)
    for name in ("_pack", "_ring_operands", "_observe", "_drain_slot"):
        delattr(gw, name)
    for b in gw._live_buckets():
        delattr(b, "launch")
    wall = sum(map(sum, walls.values())) / n
    out = {k: v / n * 1e3 for k, v in clock.items()}
    out["rest"] = wall * 1e3 - sum(out.values())
    out["wall"] = wall * 1e3
    if collect_turns:
        out["outputs"] = (np.mean(walls[True]) - np.mean(walls[False])) * 1e3
    return out


def print_split(what: str, split: dict) -> None:
    parts = ", ".join(f"{k} {v:.3f}" for k, v in split.items() if k != "wall")
    print(f"  host split of {what}, ms a call: wall {split['wall']:.3f}: {parts}")


def same_outputs(got: dict, want: dict, what: str) -> None:
    for f in STEP_FIELDS:
        check(np.array_equal(np.asarray(got[f]), np.asarray(want[f]), equal_nan=True),
              f"{what}: {f} differs from the standalone runtime")


def replay_policy(spec, routing, demand, rng, device):
    """A forecast-gated policy in replay mode for one tenant, built as
    ``tests/test_gateway.py:67-78`` builds it: a standalone stream's VPN cost
    scaled by a random factor as the prediction, cost coefficients fitted
    on the stream's costs."""
    from repro_torch.fleet import FleetRuntime, fit_cost_coef, forecast_gated_policy

    rt = FleetRuntime(spec, routing=routing, device=device)
    base = stream(rt, demand, STREAM_K)
    pred = np.maximum(rng.uniform(0.3, 1.2) * base["vpn_cost"], 0.0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    coef = fit_cost_coef(t(pred), t(base["vpn_cost"]), t(base["cci_cost"]))
    return forecast_gated_policy(rt.arrays.toggle, pred, margin=0.05, cost_coef=coef)


def mixed_tenants(device, n_each: int, pairs: int, hours: int, fleet_links: int, seed: int):
    """Topology tenants of ``pairs`` pairs (4 facilities x 2 ports) under the
    reactive, hysteresis and replay-gated policies, ``n_each`` of each, and
    ``n_each`` replay-gated fleet tenants of ``fleet_links`` links, then
    :data:`LATE`, one more hysteresis topology tenant on months of
    :data:`LATE_HPM` hours: name -> (TenantSpec, scenario, topology or not)."""
    import dataclasses

    from repro_torch.fleet import (RuntimeConfig, build_fleet_scenario, build_topology_scenario,
                                   hysteresis_policy, optimize_routing)
    from repro_torch.gateway import TenantSpec

    def topology_tenant(kind, seed_i, hpm=None):
        sc = build_topology_scenario(pairs, horizon=hours, seed=seed_i, **GW_TOPO_KW)
        topo = sc.topo if hpm is None else dataclasses.replace(sc.topo, hours_per_month=hpm)
        routing = optimize_routing(topo, sc.demand)
        policy = None
        if kind == "hysteresis":
            tog = topo.stack(routing, torch.float64, device).toggle
            policy = hysteresis_policy(tog, up_hold=int(rng.integers(1, 6)),
                                       down_hold=int(rng.integers(1, 6)))
        elif kind == "replay":
            policy = replay_policy(topo, routing, sc.demand, rng, device)
        cfg = RuntimeConfig(routing=routing, policy=policy)
        return TenantSpec(spec=topo, demand=sc.demand, config=cfg), sc, True

    rng = np.random.default_rng(seed)
    out = {}
    for k, kind in enumerate(("reactive", "hysteresis", "replay")):
        for i in range(n_each):
            out[f"topo-{kind}{i}"] = topology_tenant(kind, seed + 10 * k + i)
    for i in range(n_each):
        sc = build_fleet_scenario(fleet_links, horizon=hours, seed=seed + 100 + i)
        cfg = RuntimeConfig(policy=replay_policy(sc.fleet, None, sc.demand, rng, device))
        out[f"fleet-replay{i}"] = (TenantSpec(spec=sc.fleet, demand=sc.demand, config=cfg),
                                   sc, False)
    out[LATE] = topology_tenant("hysteresis", seed + 10 + n_each, LATE_HPM)
    return out


def moved_plan(sc, routing):
    """The routing with every pair that has another candidate moved to it."""
    idx = routing.primary.copy()
    for i, pr in enumerate(sc.topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others:
            idx[i] = others[0]
    return sc.topo.plan(idx)


def drive_mixed(gw, tenants: dict, ticks: int, reroute_at: int, leave_at: int, K: int,
                counts=None):
    """Join the mixed tenants but :data:`LATE`, tick ``ticks`` hours
    (rerouting the first reactive topology tenant at ``reroute_at``), then
    chunks of K to the horizon (the first hysteresis one leaving at
    ``leave_at``, a chunk boundary, and :data:`LATE` joining into its slot,
    on a clock of its own); with ``counts``, each call's launches checked
    and counted (:func:`gw_call`). Returns each tenant's outputs by its own
    hour (from its join) or chunk, and the new routing."""
    joined = {}
    for name, (spec, _, _) in tenants.items():
        if name != LATE:
            gw.join(name, spec)
            joined[name] = 0
    rname, lname = "topo-reactive0", "topo-hysteresis0"
    sc_r = tenants[rname][1]
    new_plan = moved_plan(sc_r, tenants[rname][0].config.routing)
    hours = tenants[rname][1].demand.shape[1]
    outs = {name: [] for name in tenants}
    t = 0
    while t < hours:
        if t == reroute_at:
            gw.reroute(rname, new_plan)
        if t == leave_at:
            where = lambda h: (h.key, h.bucket, h.slot)
            freed = where(gw.handle(lname))
            gw.leave(lname)
            check(where(gw.join(LATE, tenants[LATE][0])) == freed,
                  f"{LATE} did not take the slot {lname} freed")
            joined[LATE] = t
        k = 1 if t < ticks else K
        step = gw.tick if k == 1 else (lambda: gw.tick_many(K))
        got = step() if counts is None else gw_call(gw, step, counts)
        for name, o in got.items():
            outs[name].append((t - joined[name], k, o))
        t += k
    check(outs[LATE], f"{LATE} never stepped")
    return outs, new_plan


def standalone_mixed(tenants: dict, outs: dict, new_plan, reroute_at: int, device) -> int:
    """Each mixed tenant's standalone runtime on ``device`` stepped as the
    gateway stepped it (the reroute too), every output bit for bit."""
    from repro_torch.fleet import FleetRuntime

    n = 0
    for name, (spec, sc, _) in tenants.items():
        c = spec.config
        rt = FleetRuntime(spec.spec, routing=c.routing, policy=c.policy, device=device)
        for t, k, got in outs[name]:
            if name == "topo-reactive0" and t == reroute_at:
                rt.reroute(new_plan)
            want = rt.step(sc.demand[:, t]) if k == 1 else rt.step_many(sc.demand[:, t:t + k])
            same_outputs(got, want, f"{name} at hour {t} (K = {k})")
            n += 1
    return n


def small_gateway(device):
    """The card-vs-CPU gateway: GW_SMALL's mixed tenants, cadence 24, ticks
    to hour 48 (the reroute at 30), then chunks of 24 (the leave at 96).
    Returns the outputs, the billing totals and the drained windows."""
    from repro_torch.gateway import FleetGateway, GatewayConfig

    n, links, hours = GW_SMALL
    tenants = mixed_tenants(device, n, 8, hours, links, SEED + 500)
    gw = FleetGateway(GatewayConfig(slots_per_bucket=4, cadence=24), device=device)
    outs, _ = drive_mixed(gw, tenants, 48, 30, 96, 24)
    check(not gw.check(), f"the small gateway on {device} recorded violations")
    billing = {name: gw.billing(name) for name in tenants}
    drained = {name: json.dumps([d.to_json() for d in gw.metrics(name)]) for name in tenants}
    return outs, billing, drained


def pooled_call(gw, b, K: int) -> tuple:
    """``(args, kwargs)`` of bucket ``b``'s next pooled chunk of K hours."""
    block, _ = gw._pack(b, K)
    return b.chunk_args(block, K)


def scalar_clock(args, kw) -> tuple:
    """``(args, kwargs)`` of a pooled call with its clock as ints (every row
    must share it): the scalar instance's call on the same operands."""
    clocks = kw["clocks"]
    t0s = {int(v) for c in clocks[::2] for v in c.tolist()}
    hpms = {int(v) for v in clocks[1].tolist()}
    check(len(t0s) == len(hpms) == 1, f"the rows' clocks differ: {t0s}, {hpms}")
    return [*args, t0s.pop(), hpms.pop()], dict(kw, clocks=None)


def pooled_timing_bucket(spec, demand, policy_fn, n: int, device):
    """A gateway with one bucket of ``n`` tenants of one spec, joined at once
    (so every row shares one clock), observability off; its bucket."""
    from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec

    gw = FleetGateway(GatewayConfig(slots_per_bucket=n, queue_limit=n, obs=False),
                      device=device)
    for i in range(n):
        gw.join(f"t{i}", TenantSpec(spec=spec, demand=demand * (1.0 + 0.01 * (i % 97)),
                                    config=policy_fn(i)))
    for _ in range(3):
        gw.tick(collect=False)
    (b,) = gw._live_buckets()
    return gw, b


def staggered_bucket(spec, demand, policy_fn, n: int, device):
    """A gateway with one bucket of ``n`` tenants of one spec on clocks of
    their own, observability off: tenant i joins at gateway hour i //
    GW_STAGGER_JOINS and bills months of GW_STAGGER_HPM[i % 4] hours, and the
    gateway ticks GW_STAGGER_AFTER hours past the last join, so the slots'
    first hours run from 20 to 83 (some slots start a month at the next
    chunk's first hour, others inside it); its bucket."""
    import dataclasses

    from repro_torch.fleet import FleetSpec
    from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec

    gw = FleetGateway(GatewayConfig(slots_per_bucket=n, queue_limit=n, obs=False),
                      device=device)
    # a fleet's calendar is its links' (the config's over stacked arrays), a
    # topology's its own
    arrays = spec.stack(torch.float64, device) if isinstance(spec, FleetSpec) else None
    for i in range(n):
        while gw.hours < i // GW_STAGGER_JOINS:
            gw.tick(collect=False)
        hpm, cfg = GW_STAGGER_HPM[i % 4], policy_fn(i)
        if arrays is not None:
            own, cfg = arrays, dataclasses.replace(cfg, hours_per_month=hpm)
        else:
            own = dataclasses.replace(spec, hours_per_month=hpm)
        gw.join(f"s{i}", TenantSpec(spec=own, demand=demand * (1.0 + 0.01 * (i % 97)),
                                    config=cfg))
    for _ in range(GW_STAGGER_AFTER):
        gw.tick(collect=False)
    (b,) = gw._live_buckets()
    return gw, b


def routed_forms_in_turns(bt, args, kw, got, got_fsm, K: int, Kt: int) -> tuple:
    """A topology bucket's pooled call in both forms of the routed chunk on the
    same operands: the form the wrapper takes for it (the small-port form;
    checked) already gave ``got``; the port-block form, forced, must give its
    bits.
    Both timed in turns (port-block, small-port, small-port, port-block) by
    profiler device time, each beside its latency floor at the hottest port
    its index recorded on the host. Returns the row's form fields and a line
    of the times and their ratio."""
    from repro_torch.kernels.stream_chunk import routed_launch_form, stream_chunk_routed

    idx = bt.routing.index
    S, M, P = bt.n_slots, bt.key.rows_cap, bt.key.pairs_cap
    chosen = routed_launch_form(idx, S * P, K, Kt, False)
    check(chosen == "small_port", f"the {idx.n_ports}-port bucket (hottest port "
          f"{idx.max_legs} legs) takes the {chosen} form")
    pb = stream_chunk_routed(*args, **kw, form="port_block")
    check(same_bits(pb[0], got) and same_bits(pb[1], got_fsm),
          f"K = {K}: the port-block form != the small-port form on the bucket's operands")
    kerns = {"port_block": ROUTED_KERNEL, "small_port": SMALL_KERNEL}
    ms = {form: [] for form in kerns}
    for form in ("port_block", "small_port", "small_port", "port_block"):
        fn = lambda: stream_chunk_routed(*args, **kw, form=form)
        ms[form].append(kernel_device_ms(fn, 30, [kerns[form]], per_call=1)[kerns[form]])
    floor = {form: routed_latency_floor(S * P, S * M, K, Kt, idx.max_legs, form=form)
             for form in kerns}
    sp, pbm = min(ms["small_port"]), min(ms["port_block"])
    fs, fp = floor["small_port"], floor["port_block"]
    line = (f"      forms in turns, K = {K:2d}: small-port {ms['small_port'][0]:.5f} / "
            f"{ms['small_port'][1]:.5f} ms (floor {fs['floor_ms']:.5f}: {fs['grid']} x "
            f"{fs['threads']}), port-block {ms['port_block'][0]:.5f} / "
            f"{ms['port_block'][1]:.5f} ms (floor {fp['floor_ms']:.5f}: {fp['grid']} x "
            f"{fp['threads']}); port-block / small-port {pbm / sp:.2f}x; the two forms' "
            f"bits equal")
    return line, {"form": "small_port", "floor_ms": fs["floor_ms"], "port_block_ms": pbm,
                  "port_block_floor_ms": fp["floor_ms"], "small_port_turns_ms": ms["small_port"],
                  "port_block_turns_ms": ms["port_block"]}


def gateway_phase(card: str) -> dict:
    """The multi-tenant gateway (``repro_torch.gateway.FleetGateway``) on the
    card: 256 fleet tenants of 32 links ticking in one bucket, a fresh pool
    of them in chunks of 24, 256 heterogeneous 2-link tenants, a mixed
    gateway of topology and fleet tenants under the three policies with a
    reroute, a leave and a late joiner, 256 topology tenants in two buckets
    of 128 slots (the routed chunk's small-port form), the card against the CPU; every
    pooled launch counted (one per non-empty bucket per tick or chunk, each
    routed one in the form the selection rule takes), the probe, fresh,
    heterogeneous, mixed and topology-bucket tenants held to standalone card
    runtimes bit for bit; then the pooled instances against their plain
    versions on staggered clocks, and timed beside the scalar instance on
    the same rows."""
    import gc

    from repro_torch.fleet import (FleetRuntime, RuntimeConfig, build_fleet_scenario,
                                   forecast_gated_policy, optimize_routing,
                                   build_topology_scenario, resolve_runtime_operands)
    from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec, bucket_key_for
    from repro_torch.gateway.pool import stack_slots
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.stream_chunk import _stream_chunk_launch, stream_chunk_routed

    t_phase = time.perf_counter()
    n_ten, n_links = GW_SHAPE
    K, ck_cadence, warm_chunks, timed_chunks = GW_CHUNK
    rows = n_ten * n_links

    # -- the tenants (the replay policies' base streams launch kernels) --------
    horizon = GW_WARM + GW_TICKS + GW_SPLIT_TICKS + 8
    base = build_fleet_scenario(n_links, horizon=horizon, seed=SEED)
    tenant = lambda i, h=horizon: TenantSpec(
        spec=base.fleet, demand=base.demand * (1.0 + 0.01 * (i % 97)), horizon=h)
    n_het, het_ticks = GW_HETERO
    het, want_key, seed = {}, None, 0
    while len(het) < n_het:
        seed += 1
        sc = build_fleet_scenario(2, horizon=24, seed=7000 + seed)
        key = bucket_key_for(resolve_runtime_operands(sc.fleet, RuntimeConfig(), "cpu"))
        want_key = key if want_key is None else want_key
        if key == want_key:
            het[f"h{len(het)}"] = (sc, [])
    n_pairs, topo_hours, n_each = GW_TOPO
    mixed = mixed_tenants(DEVICE, n_each, n_pairs, topo_hours, 16, SEED + 300)
    res0 = resolve_runtime_operands(base.fleet, RuntimeConfig(), DEVICE)
    big_arrays = stack_slots([res0.arrays] * n_ten)   # the pool's rows as one fleet
    big_demand = np.concatenate([base.demand * (1.0 + 0.01 * (i % 97)) for i in range(n_ten)])
    topo = build_topology_scenario(n_pairs, horizon=topo_hours, seed=SEED, **GW_TOPO_KW)
    plan = optimize_routing(topo.topo, topo.demand)
    rng = np.random.default_rng(SEED)
    fleet_tog = res0.arrays.toggle
    topo_tog = topo.topo.stack(plan, torch.float64, DEVICE).toggle

    def replay_cfg(tog, routing=None, cols=512, gen=None):
        g = rng if gen is None else gen
        M = tog.h.shape[0]
        pred = g.uniform(0.0, 300.0, (M, cols))
        coef = np.stack([g.uniform(0.5, 1.5, M), g.uniform(0.3, 0.6, M),
                         g.uniform(0.5, 1.5, M), g.uniform(0.3, 0.6, M)], axis=1)
        return RuntimeConfig(routing=routing, policy=forecast_gated_policy(
            tog, pred, margin=0.05, cost_coef=coef))

    # the topology buckets' tenants: even ones reactive, odd ones replay-gated
    topo_gen = np.random.default_rng(SEED + 500)
    topo_cfgs = [RuntimeConfig(routing=plan) if i % 2 == 0 else
                 replay_cfg(topo_tog, plan, gen=topo_gen) for i in range(n_ten)]
    topo_tenant = lambda i: TenantSpec(spec=topo.topo,
                                       demand=topo.demand * (1.0 + 0.01 * (i % 97)),
                                       config=topo_cfgs[i])

    # -- the main path: every launch count at 0, the gateways driven ------------
    ops.reset_launches()
    counts, big_calls = {}, 0
    gw = FleetGateway(GatewayConfig(slots_per_bucket=n_ten, queue_limit=n_ten,
                                    max_rows=max(4096, n_links), obs=True, cadence=GW_CADENCE))
    check(gw.device.type == DEVICE.type, "the gateway did not run on the card")
    a = time.perf_counter()
    for i in range(n_ten):
        gw.join(f"t{i:04d}", tenant(i))
    join_s = time.perf_counter() - a
    check(gw.n_active == n_ten and gw.n_buckets == 1, f"{gw.n_active} active in "
          f"{gw.n_buckets} buckets")
    probes = {f"t{i:04d}": [] for i in (0, n_ten - 1)}
    for _ in range(GW_WARM):
        outs = gw_call(gw, gw.tick, counts)
        for name, got in probes.items():
            got.append(outs[name])
    # One standalone runtime over as many links (the pool's operands and
    # demand stacked as one fleet, observability off), stepped in turns with
    # the pool's ticks and chunks.
    big = FleetRuntime(big_arrays, hours_per_month=base.fleet.hours_per_month)
    for t in range(GW_WARM):
        big.step(big_demand[:, t])
    big_calls += GW_WARM
    tick_s, big_s = np.empty(GW_TICKS), np.empty(GW_TICKS)
    is_drain = (GW_WARM + np.arange(GW_TICKS) + 1) % GW_CADENCE == 0
    before = ops.LAUNCHES["stream_chunk_pooled"]
    gc.disable()
    try:
        for k in range(GW_TICKS):
            a = time.perf_counter()
            outs = gw.tick()
            tick_s[k] = time.perf_counter() - a
            a = time.perf_counter()
            big.step(big_demand[:, GW_WARM + k])
            big_s[k] = time.perf_counter() - a
            for name, got in probes.items():
                got.append(outs[name])
    finally:
        gc.enable()
    big_calls += GW_TICKS
    check(ops.LAUNCHES["stream_chunk_pooled"] == before + GW_TICKS,
          f"{GW_TICKS} ticks of one bucket launched "
          f"{ops.LAUNCHES['stream_chunk_pooled'] - before} pooled chunks")
    counts["stream_chunk_pooled"] += GW_TICKS
    frozen = gw.compiles
    check(frozen == 1, f"one bucket ticking hourly prepared {frozen} launch shapes, not 1")
    gw.leave("t0001")
    gw.join("fresh", tenant(n_ten))
    check(gw.handle("fresh").status == "active", "the fresh tenant did not take the freed slot")
    fresh = [gw_call(gw, gw.tick, counts)["fresh"]]     # its hours (None: not collected)
    check(gw.compiles == frozen, f"churn prepared new launch shapes: {frozen} -> {gw.compiles}")
    before = ops.LAUNCHES["stream_chunk_pooled"]

    def split_tick(collect):
        outs = gw.tick(collect=collect)
        fresh.append(outs["fresh"] if collect else None)

    tick_split = host_split(gw, split_tick, GW_SPLIT_TICKS, True)
    check(ops.LAUNCHES["stream_chunk_pooled"] == before + GW_SPLIT_TICKS, "the split's ticks")
    counts["stream_chunk_pooled"] += GW_SPLIT_TICKS
    violations = gw.check(final=True)
    check(not violations, f"the fleet pool recorded violations: {violations[:3]}")

    # a fresh pool of the same tenants in chunks of K, in turns with the
    # standalone runtime's chunks
    ck_horizon = (warm_chunks + timed_chunks + GW_SPLIT_CHUNKS) * K + 8
    gw2 = FleetGateway(GatewayConfig(slots_per_bucket=n_ten, queue_limit=n_ten,
                                     max_rows=max(4096, n_links), obs=True, cadence=ck_cadence))
    for i in range(n_ten):
        gw2.join(f"t{i:04d}", tenant(i, ck_horizon))
    for _ in range(warm_chunks):
        gw_call(gw2, lambda: gw2.tick_many(K), counts)
    big2 = FleetRuntime(big_arrays, hours_per_month=base.fleet.hours_per_month)
    for t in range(0, warm_chunks * K, K):
        big2.step_many(big_demand[:, t:t + K])
    big_calls += warm_chunks
    chunk_s, big_chunk_s = np.empty(timed_chunks), np.empty(timed_chunks)
    before = ops.LAUNCHES["stream_chunk_pooled"]
    gc.disable()
    try:
        for k in range(timed_chunks):
            a = time.perf_counter()
            gw2.tick_many(K)
            chunk_s[k] = time.perf_counter() - a
            t = (warm_chunks + k) * K
            a = time.perf_counter()
            big2.step_many(big_demand[:, t:t + K])
            big_chunk_s[k] = time.perf_counter() - a
    finally:
        gc.enable()
    big_calls += timed_chunks
    check(ops.LAUNCHES["stream_chunk_pooled"] == before + timed_chunks,
          f"{timed_chunks} chunks of one bucket launched "
          f"{ops.LAUNCHES['stream_chunk_pooled'] - before} pooled chunks")
    counts["stream_chunk_pooled"] += timed_chunks
    chunk_split = host_split(gw2, lambda c: gw2.tick_many(K, collect=c), GW_SPLIT_CHUNKS)
    counts["stream_chunk_pooled"] += GW_SPLIT_CHUNKS
    check(gw2.compiles == 1 and not gw2.check(), "the chunked pool")

    # 256 heterogeneous 2-link tenants in one bucket: 6 ticks, then one chunk
    gw3 = FleetGateway(GatewayConfig(slots_per_bucket=n_het, queue_limit=n_het,
                                     cadence=het_ticks))
    for name, (sc, _) in het.items():
        gw3.join(name, TenantSpec(spec=sc.fleet, demand=sc.demand, horizon=2 * het_ticks))
    check(gw3.n_buckets == 1, f"the heterogeneous tenants took {gw3.n_buckets} buckets")
    for _ in range(het_ticks):
        outs = gw_call(gw3, gw3.tick, counts)
        for name, (_, got) in het.items():
            got.append(outs[name])
    outs = gw_call(gw3, lambda: gw3.tick_many(het_ticks), counts)
    for name, (_, got) in het.items():
        got.append(outs[name])
    check(gw3.compiles == 2 and not gw3.check(), "the heterogeneous pool")

    # the mixed gateway: topology buckets under three policies, fleet replay tenants
    gw4 = FleetGateway(GatewayConfig(slots_per_bucket=4, cadence=ck_cadence))
    mixed_out, new_plan = drive_mixed(gw4, mixed, GW_TOPO_TICKS, GW_REROUTE, GW_LEAVE, K, counts)
    check(not gw4.check(), "the mixed gateway recorded violations")
    # n_ten topology tenants in two buckets of n_ten / 2 slots, reactive and
    # replay-gated (each n_ten / 2 x 8 ports of at most 12 legs), which take
    # the routed chunk's small-port form where the mixed gateway's 4-slot
    # buckets (32 ports) take the port-block form: ticks and a chunk, the
    # first and last tenants of each held to standalone card runtimes
    gw5 = FleetGateway(GatewayConfig(slots_per_bucket=n_ten // 2, queue_limit=n_ten,
                                     obs=False))
    for i in range(n_ten):
        gw5.join(f"t{i:04d}", topo_tenant(i))
    check(gw5.n_active == n_ten and gw5.n_buckets == 2, f"the topology tenants: "
          f"{gw5.n_active} active in {gw5.n_buckets} buckets")
    topo_probes = {f"t{i:04d}": [] for i in (0, 1, n_ten - 2, n_ten - 1)}
    for call in [gw5.tick] * GW_TOPO_BIG_TICKS + [lambda: gw5.tick_many(K)]:
        outs = gw_call(gw5, call, counts)
        for name, got in topo_probes.items():
            got.append(outs[name])
    check(not gw5.check(), "the topology bucket recorded violations")
    torch.cuda.synchronize()
    main_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(main_launches == {**counts, "stream_chunk": big_calls},
          f"the gateways launched {main_launches}, counted {counts} and {big_calls} "
          f"standalone chunks")
    for name in POOLED:
        check(main_launches.get(name, 0) >= 1, f"{name} was not launched on the gateway path")
    n_routed = sum(main_launches.get(name, 0) for name in POOLED if "routed" in name)
    n_small = main_launches.get(SMALL_PORT, 0)
    check(n_small == 2 * (GW_TOPO_BIG_TICKS + 1) and n_routed > n_small,
          f"of {n_routed} topology-bucket launches {n_small} took the small-port form, not "
          f"the {2 * (GW_TOPO_BIG_TICKS + 1)} of the two {n_ten // 2}-slot buckets")
    t_main = time.perf_counter() - t_phase

    # -- held against standalone card runtimes ----------------------------------
    for name, got in probes.items():
        i = int(name[1:])
        rt = FleetRuntime(base.fleet)
        dem = base.demand * (1.0 + 0.01 * (i % 97))
        for t, g in enumerate(got):
            same_outputs(g, rt.step(np.ascontiguousarray(dem[:, t])), f"probe {name} at hour {t}")
    rt = FleetRuntime(base.fleet)
    dem = base.demand * (1.0 + 0.01 * (n_ten % 97))
    for t, g in enumerate(fresh):
        want = rt.step(np.ascontiguousarray(dem[:, t]))
        if g is not None:
            same_outputs(g, want, f"the fresh tenant at its hour {t}")
    n_fresh = sum(g is not None for g in fresh)
    for name, got in topo_probes.items():
        i = int(name[1:])
        rt = FleetRuntime(topo.topo, routing=plan, policy=topo_cfgs[i].policy)
        dem = topo.demand * (1.0 + 0.01 * (i % 97))
        for t, g in enumerate(got[:-1]):
            same_outputs(g, rt.step(np.ascontiguousarray(dem[:, t])),
                         f"topology {name} at hour {t}")
        t = GW_TOPO_BIG_TICKS
        same_outputs(got[-1], rt.step_many(dem[:, t:t + K]), f"topology {name}'s chunk")
    for name, (sc, got) in het.items():
        rt = FleetRuntime(sc.fleet)
        for t in range(het_ticks):
            same_outputs(got[t], rt.step(sc.demand[:, t]), f"{name} at hour {t}")
        same_outputs(got[het_ticks], rt.step_many(sc.demand[:, het_ticks:2 * het_ticks]),
                     f"{name}'s chunk")
    n_mixed = standalone_mixed(mixed, mixed_out, new_plan, GW_REROUTE, DEVICE)
    # -- the card against the CPU ----------------------------------------------
    card_run, cpu_run = small_gateway(DEVICE), small_gateway(torch.device("cpu"))
    for name in card_run[0]:
        check(len(card_run[0][name]) == len(cpu_run[0][name]), f"card != CPU gateway: {name}")
        for (t, k, g), (_, _, c) in zip(card_run[0][name], cpu_run[0][name]):
            for f in STEP_FIELDS:
                check(np.array_equal(g[f], c[f], equal_nan=True),
                      f"card != CPU gateway: {name} {f} at hour {t}")
    check(card_run[1] == cpu_run[1], "card != CPU gateway billing")
    check(card_run[2] == cpu_run[2], "card != CPU gateway drained windows")
    check(all(cpu_run[2].values()), "the small gateway drained nothing")

    steady, drain = tick_s[~is_drain], tick_s[is_drain]
    per_tick = float(tick_s.mean())
    tls = n_ten * n_links / per_tick
    ck_tls = n_ten * n_links * K / float(chunk_s.mean())
    print(f"gateway: {n_ten} tenants x {n_links} links in one bucket (cadence {GW_CADENCE}, "
          f"obs on) on {card}: tenant_link_steps_per_s {tls:.4g}, tick mean "
          f"{per_tick * 1e3:.3f} ms (steady p50 {np.percentile(steady, 50) * 1e3:.3f} / p95 "
          f"{np.percentile(steady, 95) * 1e3:.3f} / p99 {np.percentile(steady, 99) * 1e3:.3f} "
          f"ms; drain ticks {drain.mean() * 1e3:.3f} ms, {drain.size} of them), join "
          f"{join_s:.3f} s ({n_ten / join_s:.1f} joins/s); chunked (K = {K}, cadence "
          f"{ck_cadence}) {ck_tls:.4g} tenant-link-steps/s ({chunk_s.mean() * 1e3:.3f} ms a "
          f"chunk); prepared launch shapes {gw.compiles}, churn prepared none")
    print_split(f"a tick ({GW_SPLIT_TICKS} ticks after the timed ones; outputs: collect on "
                f"minus off, in turns)", tick_split)
    print_split(f"a chunk of {K} ({GW_SPLIT_CHUNKS} chunks, one drain)", chunk_split)
    print(f"  one standalone FleetRuntime over {rows} links (obs off), in turns: K = 1 "
          f"{big_s.mean() * 1e3:.3f} ms a step (p50 {np.percentile(big_s, 50) * 1e3:.3f}), "
          f"{rows / big_s.mean():.4g} link-steps/s; K = {K} {big_chunk_s.mean() * 1e3:.3f} ms a "
          f"chunk, {rows * K / big_chunk_s.mean():.4g} link-steps/s")
    print(f"  launches on the gateway path: {main_launches} (one per non-empty bucket per tick "
          f"or chunk); probes t0000 and t{n_ten - 1:04d} == standalone card runtimes on every "
          f"field of {len(probes['t0000'])} hours, the fresh tenant (joined at hour "
          f"{GW_WARM + GW_TICKS}, its own clock) on {n_fresh} of its first {len(fresh)} hours; "
          f"the two {n_ten // 2}-slot topology buckets' (reactive, replay) {n_small} launches "
          f"in the small-port form (their first and last tenants == standalone card "
          f"runtimes over {GW_TOPO_BIG_TICKS} ticks and a chunk), the mixed gateway's "
          f"{n_routed - n_small} (4-slot buckets, 32 ports) in the port-block form; "
          f"{n_het} heterogeneous 2-link tenants == their "
          f"standalone card runtimes over {het_ticks} ticks and a chunk; the mixed gateway "
          f"({len(mixed)} tenants: topology x reactive/hysteresis/replay, fleet replay; a "
          f"reroute at {GW_REROUTE}, a leave at {GW_LEAVE} and {LATE} ({LATE_HPM}-hour months) "
          f"into its slot) == standalone card runtimes in "
          f"{n_mixed} ticks and chunks; the card's small gateway == the CPU's in every output, "
          f"billing total and drained window ({t_main:.1f} s for the main path)")

    # -- the pooled instances against their plain versions, timed --------------
    buckets = {
        "stream_chunk_pooled": (base.fleet, base.demand, lambda i: RuntimeConfig()),
        "stream_chunk_pooled_gated": (base.fleet, base.demand,
                                      lambda i: replay_cfg(fleet_tog)),
        "stream_chunk_routed_pooled": (topo.topo, topo.demand,
                                       lambda i: RuntimeConfig(routing=plan)),
        "stream_chunk_routed_pooled_gated": (topo.topo, topo.demand,
                                             lambda i: replay_cfg(topo_tog, plan)),
    }
    stagger_cfg = {
        "stream_chunk_pooled": lambda i: RuntimeConfig(),
        "stream_chunk_pooled_gated": lambda i: replay_cfg(fleet_tog,
                                                          cols=GW_STAGGER_PRED[i % 4]),
        "stream_chunk_routed_pooled": lambda i: RuntimeConfig(routing=plan),
        "stream_chunk_routed_pooled_gated": lambda i: replay_cfg(topo_tog, plan,
                                                                 GW_STAGGER_PRED[i % 4]),
    }
    for name, (spec, dem, _) in buckets.items():
        gws, bs = staggered_bucket(spec, dem, stagger_cfg[name], n_ten, DEVICE)
        routed = bs.key.topology
        plain = ref.stream_chunk_routed_ref if routed else ref.stream_chunk_ref
        ahead = (-bs.t) % bs.hpm                     # hours to each slot's next month start
        own_pred = np.zeros(bs.n_slots, np.int64)    # each slot's T_pred before the padding
        for i in range(bs.n_slots):
            own_pred[gws.handle(f"s{i}").slot] = GW_STAGGER_PRED[i % 4]
        past = int((bs.t + max(k for _, k in GW_STAGGER_FORMS[routed]) > own_pred).sum())
        check(bs.gate is None or past > 0, f"{name}: no slot reads past its T_pred")
        for form, Kt_ in GW_STAGGER_FORMS[routed]:
            check((ahead == 0).any() if Kt_ == 1 else ((ahead > 0) & (ahead < Kt_)).any(),
                  f"{name}: no slot starts a month in a chunk of {Kt_}")
            args, kw = pooled_call(gws, bs, Kt_)
            before = ops.LAUNCHES[name]
            got, got_fsm = (stream_chunk_routed(*args, **kw) if routed else
                            _stream_chunk_launch(form, *args, **kw))
            check(ops.LAUNCHES[name] == before + 1, f"{name} did not launch its pooled instance")
            want, want_fsm = plain(*args, **kw)
            check(same_bits(got, want) and same_bits(got_fsm, want_fsm),
                  f"{name} on staggered clocks, {form} form at K = {Kt_}, != its plain version")
        print(f"  {name} at {bs.n_slots} slots on staggered clocks (first hours "
              f"{int(bs.t.min())}..{int(bs.t.max())}, {len(set(bs.t.tolist()))} distinct; months of "
              f"{sorted(set(bs.hpm.tolist()))} h; {int((ahead == 0).sum())} slots start a month at "
              f"the chunk's first hour"
              + ("" if bs.gate is None else f"; T_pred {GW_STAGGER_PRED} padded to "
                 f"{bs.gate[3]} columns, {past} slots read past their own in the longest chunk")
              + f") == its plain version in every bit: "
              f"{', '.join(f'{f} K = {k}' for f, k in GW_STAGGER_FORMS[routed])}")
        del gws, bs
    rows_out = {}
    print(f"  pooled instances at {n_ten} slots (profiler device time, one common clock so "
          f"the scalar instance runs the same operands; bound = max(bytes / 3.35 TB/s, float64 "
          f"lane operations / peak); routed: the small-port form the index chose, the "
          f"port-block form forced on the same operands, in turns, each beside its latency "
          f"floor; {card}):")
    for name, (spec, dem, cfg_fn) in buckets.items():
        gwt, bt = pooled_timing_bucket(spec, dem, cfg_fn, n_ten, DEVICE)
        routed = bt.key.topology
        gated = bt.gate is not None
        kern = ROUTED_ANY if routed else "stream_chunk_"
        launch = (lambda a, kw: stream_chunk_routed(*a, **kw)) if routed else \
            (lambda a, kw: _stream_chunk_launch("auto", *a, **kw))
        plain = ref.stream_chunk_routed_ref if routed else ref.stream_chunk_ref
        for Kt_ in GW_TIMED_K:
            args, kw = pooled_call(gwt, bt, Kt_)
            got, got_fsm = launch(args, kw)
            want, want_fsm = plain(*args, **kw)
            check(same_bits(got, want) and same_bits(got_fsm, want_fsm),
                  f"{name} at K = {Kt_} != its plain version")
            sargs, skw = scalar_clock(args, kw)
            sgot, sfsm = launch(sargs, skw)
            check(same_bits(sgot, got) and same_bits(sfsm, got_fsm),
                  f"{name} at K = {Kt_}: one common clock != the scalar instance")
            ms = kernel_device_ms(lambda: launch(args, kw), 30, [kern], per_call=1)[kern]
            sms = kernel_device_ms(lambda: launch(sargs, skw), 30, [kern], per_call=1)[kern]
            plain_ms = sync_ms(lambda: plain(*args, **kw), 3)
            S, M, P = bt.n_slots, bt.key.rows_cap, bt.key.pairs_cap
            Kt = bt.key.n_tiers
            extra, forms_line = {}, None
            if routed:
                work = routed_chunk_work(S * P, S * M, Kt_, Kt, S * bt.key.legs_cap, False, gated)
                bnd = bound(work[0] + 4 * (2 * S * P + S * M), work[1], torch.float64)
                forms_line, extra = routed_forms_in_turns(bt, args, kw, got, got_fsm, Kt_, Kt)
            else:
                work = stream_chunk_work(S * M, Kt_, Kt, False, gated)
                bnd = lane_bound(work[0] + 4 * 2 * S * M, work[1], torch.float64)
            print(f"    {name:33s} K = {Kt_:2d}: {ms:.5f} ms (scalar instance {sms:.5f} ms, "
                  f"ratio {ms / sms:.3f}), plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.6f} "
                  f"ms ({bnd['bound_by']}), {ms / bnd['bound_ms']:.1f}x bound"
                  + (f", latency floor {extra['floor_ms']:.5f} ms" if extra else "")
                  + "; == plain and == the scalar instance in every bit")
            if forms_line:
                print(forms_line)
            if Kt_ == STREAM_K:
                rows_out[name] = {"launches": main_launches.get(name, 0), "max_abs_err": 0.0,
                                  "ms": ms, "plain_ms": plain_ms, **bnd,
                                  "scalar_ms": sms, "shape": f"{S} x {M} rows x {Kt_}",
                                  **extra}
    print_stream_registers(("pooled",))
    print_routed_registers()
    print(f"gateway phase: {time.perf_counter() - t_phase:.1f} s")
    return rows_out


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
    moe_rows = moe_phase(card.splitlines()[0])
    act_rows = actuation_phase(card.splitlines()[0])
    topo_row, topo_ctx = topology_phase(card.splitlines()[0], scen[SIZES[-1][0]])
    routed_row = topology_stream_phase(card.splitlines()[0], topo_ctx)
    oracle_row = report_phase(card.splitlines()[0], scen[N_big], plans[N_big, False], topo_ctx)
    fc_rows, fc_ctx = forecast_phase(card.splitlines()[0])
    fs_rows = forecast_stream_phase(card.splitlines()[0], fc_ctx, topo_ctx)
    live_rows, live_ctx = forecast_live_phase(card.splitlines()[0], fc_ctx, topo_ctx)
    obs_phase(card.splitlines()[0], scen[N_big], plans[N_big, False], topo_ctx, live_ctx)
    gw_rows = gateway_phase(card.splitlines()[0])

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
        *({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/moe.cu",
           "replaces": "src/repro/models/ffn.py:72", **moe_rows[name]} for name in MOE_KERNELS),
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
        {"name": "forecaster_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/forecaster_scan.cu",
         "replaces": "src/repro/models/ssm.py:524", **fc_rows["forecaster_scan"]},
        {"name": "forecaster_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/forecaster_scan_bwd.cu",
         "replaces": "src/repro/models/ssm.py:578", **fc_rows["forecaster_scan_bwd"]},
        {"name": "fsm_scan_gated", "route": "cuda",
         "source": "src/repro_torch/csrc/fsm_scan.cu",
         "replaces": "src/repro/fleet/policy.py:334", **fc_rows["fsm_scan_gated"]},
        {"name": "stream_chunk_gated", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_chunk.cu",
         "replaces": "src/repro/fleet/runtime.py:339", **fs_rows["stream_chunk_gated"]},
        {"name": "stream_chunk_routed_gated", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_chunk_routed.cu",
         "replaces": "src/repro/fleet/runtime.py:465", **fs_rows["stream_chunk_routed_gated"]},
        {"name": "stream_chunk_live", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_chunk.cu",
         "replaces": "src/repro/fleet/runtime.py:556", **live_rows["stream_chunk_live"]},
        {"name": "stream_chunk_routed_live", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_chunk_routed.cu",
         "replaces": "src/repro/fleet/runtime.py:556", **live_rows["stream_chunk_routed_live"]},
    ]
    for name, row in gw_rows.items():   # the pooled instances: the gateway's tick and chunk
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/csrc/" + (
                            "stream_chunk_routed.cu" if "routed" in name else "stream_chunk.cu"),
                        "replaces": "src/repro/gateway/gateway.py:402",
                        "replaces_chunk": "src/repro/gateway/gateway.py:522", **row,
                        "library_ms": None})
    print(f"profiler: {len(PAD_SEEN)} traces; pad kernels recorded of {TRACE_PADS}, by trace: "
          f"{PAD_SEEN}; timed by CUDA events where no trace held every launch: "
          f"{EVENT_TIMED or 'none'}")
    for row in kernels:   # whether the kernel launches on one of the paths driven above
        row.setdefault("main_path", True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
