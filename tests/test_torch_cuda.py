"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on the GPU
host as it is::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` need an NVIDIA GPU and skip on a host without one
(the kernels are CUDA C++ and have no CPU mode). Tolerances: the float64
tiered kernels, the FSM kernels and the streaming runtime keep the plain
versions' order of operations and are held bit for bit (the FSM scan
against the plain version on the CPU, whose cumsum is sequential); the
float32 tiered kernels at ``rtol=atol=1e-6``. The actuation slice's
int8 quantize/dequantize and static ``tiered_cost`` kernels are bit-equal
to their plain versions on the card (``torch.equal``; on rows holding NaN,
NaN in the same places and equal values elsewhere), and so is a
compressed ``sync_grads`` on a one-rank NCCL mesh. The LM's kernels against
their float32 plain versions: flash attention at ``2e-5`` in float32 and
``2e-2`` in bfloat16, RMSNorm at ``1e-5`` and ``2e-2`` (the tolerances
``tests/test_kernels.py`` holds the Pallas kernels to); the flash tests also
assert which entry launched (the Hopper one for bf16 with head dims that are
multiples of 8 and aligned inputs, the general one otherwise). The topology
slice's leg-ordered segment sum keeps its plain version's order (each
port's legs in leg order) and is held bit for bit, NaN and padding legs
included; ``plan_topology`` on the card against the CPU: decisions equal,
costs ``rtol=1e-9``. The streaming runtime's routed chunk keeps its plain
version's order (pair calendar and fold, then each port's legs in leg
order) and is held bit for bit, and so is a topology stream on the card
against the CPU stream, across a reroute. The forecast slice's kernels, the
float32 ``forecaster_scan`` and the gated instance of ``fsm_scan``, round
every operation on its own in their plain versions' order and are held bit
for bit (NaN in the same places); a forecast plan on the card against the
CPU: decisions equal, costs ``rtol=1e-9``. The forecast stream's gated
instances of ``stream_chunk`` (both launch forms) and ``stream_chunk_routed``
gate in their plain versions' order and are held bit for bit, and a
forecast stream on the card equals the card's offline plan of the same
policy bit for bit (the card's and the CPU's predicted costs may differ in
the last place, so a stream is held against the plan of its own device).
The routed chunk's two launch forms (the port-block form and the
small-port form, a warp a port) are held against the plain version and
against each other bit for bit on synthetic routings at the small-port
form's edges (``tests/_routed_cases.py``). Observability
(``FleetRuntime(obs=...)``) adds no kernel: on the card the
observed stream equals the stream without it bit for bit, its drained
windows, monitor summaries and trace equal the CPU port's bit for bit (the
ring is host work on the same planes), and the regret monitor's oracle, one
``oracle_dp`` call, equals ``offline_optimal`` row by row bit for bit.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from repro_torch.core.pricing import (
    AWS_EGRESS_INTERNET,
    GCP_EGRESS_PREMIUM,
    GCP_EGRESS_STANDARD,
    flat_rate,
)
from repro_torch.core.togglecci import ToggleParams
from repro_torch.fleet import FleetRuntime, build_fleet_scenario, plan_fleet
from repro_torch.fleet import routing as trout
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet.engine import plan_topology, replay_plan_topology
from repro_torch.fleet.topology import optimize_routing
from repro_torch.fleet import policy as tpol
from repro_torch.fleet.spec import pad_tier_tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fsm_scan import fsm_chunk, fsm_scan, gate_masks
from repro_torch.kernels.leg_segment_sum import leg_segment_sum
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.stream_chunk import (SMALL_PORT_MAX_LEGS, SMALL_PORT_MIN_PORTS,
                                              SMALL_PORT_WIDE_PORTS, TICK_MAX_K,
                                              TICK_MAX_K_LIVE, _stream_chunk_launch,
                                              routed_launch_form, small_port_fits,
                                              stream_chunk, stream_chunk_routed)
from repro_torch.kernels.tiered_cost import tiered_cost_batched
from repro_torch.kernels.tiered_cost_scan import tiered_cost_calendar, tiered_cost_scan

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The GPU; skips on a host without one (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _t(a, device=CPU):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _tiers(seed, n, T, dtype):
    tiers = [GCP_EGRESS_PREMIUM, AWS_EGRESS_INTERNET, GCP_EGRESS_STANDARD, flat_rate(0.1)]
    bounds, rates = pad_tier_tables([tiers[i % len(tiers)] for i in range(n)])
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 400.0, size=(n, T))
    cum = np.cumsum(d, axis=1) - d
    return tuple(np.asarray(a, dtype) for a in (cum, d, bounds, rates))


def _fsm_inputs(seed, n, T):
    rng = np.random.default_rng(seed)
    vpn = rng.uniform(5.0, 50.0, size=(n, T))
    regime = np.repeat(rng.uniform(0.6, 1.4, size=(n, T // 40 + 1)), 40, axis=1)[:, :T]
    cci = vpn * regime * rng.uniform(0.95, 1.05, size=(n, T))
    tog = {
        "theta1": rng.uniform(0.85, 0.95, n),
        "theta2": rng.uniform(1.05, 1.2, n),
        "h": rng.choice([1, 5, 24, 72], n).astype(np.int32),
        "D": np.resize(np.array([0, 3, 10, 0], np.int32), n),
        "T_cci": np.resize(np.array([1, 5, 24, 1, 12], np.int32), n),
    }
    return vpn, cci, tog


def _policy(kind, tog, renew, device):
    tp = ToggleParams(**{k: _t(v, device) for k, v in tog.items()})
    if kind == "reactive":
        return tpol.reactive_policy(tp, renew_in_chunks=renew)
    h = _t(np.resize(np.array([1, 2, 3, 6], np.int32), len(tog["h"])), device)
    return tpol.HysteresisPolicy(tp, h, h.flip(0).contiguous(), renew)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on CUDA tensors or raise; they never compute on
    the CPU themselves (the dispatcher sends CPU tensors to ref.py)."""
    cum, d, b, r = (_t(a) for a in _tiers(0, 2, 8, np.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tiered_cost_batched(cum, d, b, r)
    vpn, cci, tog = _fsm_inputs(0, 2, 8)
    one = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fsm_scan(_t(vpn), _t(cci), *(_t(tog[k]) for k in ToggleParams._fields), one, one)
    with pytest.raises(ValueError, match="CUDA"):
        tiered_cost_scan(cum[:, 0].contiguous(), d, b, r, torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tiered_cost_calendar(torch.zeros((2, 2), dtype=torch.float64),
                             d.T.contiguous(), b, r, 0, 730)
    rows = [_t(tog[k]) for k in ToggleParams._fields]
    with pytest.raises(ValueError, match="CUDA"):
        fsm_chunk(_t(vpn.T), _t(cci.T), _t(vpn.T), _t(cci.T), *rows, one, one,
                  torch.zeros((4, 2), dtype=torch.int32),
                  torch.zeros((2, 2), dtype=torch.float64), 0)


def test_stream_chunk_wrapper_refuses_cpu_tensors_and_bad_operands():
    """The fused chunk's wrapper launches on CUDA tensors or raises: CPU
    operands, a block of the wrong length and a carry of the wrong type are
    refused before anything is built."""
    sc = build_fleet_scenario(4, horizon=48, seed=0)
    rt = FleetRuntime(sc.fleet, device="cpu")
    block, K, endo = rt._pack(sc.demand[:, :24], None)
    args = list(rt._chunk_args(torch.from_numpy(block), K, endo))
    with pytest.raises(ValueError, match="CUDA"):
        stream_chunk(*args)
    with pytest.raises(ValueError, match="block"):
        stream_chunk(args[0][:-1], *args[1:])
    bad = list(args)
    bad[-4] = bad[-4].to(torch.int64)    # the FSM carry
    with pytest.raises(ValueError, match="operand"):
        stream_chunk(*bad)


@pytest.mark.cuda
def test_tiered_kernel_matches_plain(cuda_device):
    for dtype in (np.float64, np.float32):
        args = _tiers(8, 64, 3000, dtype)
        before = ops.LAUNCHES["tiered_cost_batched"]
        got = ops.tiered_cost_batched(*(_t(a, cuda_device) for a in args)).cpu()
        want = ref.tiered_cost_batched_ref(*(_t(a) for a in args))
        assert ops.LAUNCHES["tiered_cost_batched"] == before + 1
        assert got.dtype == want.dtype
        if dtype == np.float64:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_tiered_kernel_checks_its_inputs(cuda_device):
    cum, d, b, r = (_t(a, cuda_device) for a in _tiers(1, 4, 16, np.float64))
    with pytest.raises(ValueError, match="shapes"):
        tiered_cost_batched(cum, d[:, :8].contiguous(), b, r)
    with pytest.raises(ValueError, match="one dtype"):
        tiered_cost_batched(cum, d.float(), b, r)
    with pytest.raises(ValueError, match="contiguous"):
        tiered_cost_batched(cum.t().contiguous().t(), d, b, r)
    with pytest.raises(TypeError):
        tiered_cost_batched(cum.half(), d.half(), b.half(), r.half())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
def test_fsm_kernel_bit_equal_to_cpu_plain(cuda_device, kind):
    """Same inputs: the kernel's in-order prefixes equal the CPU's sequential
    cumsum, so every output agrees bit for bit."""
    vpn, cci, tog = _fsm_inputs(9, 40, 2000)
    for renew in (False, True):
        before = ops.LAUNCHES["fsm_scan"]
        got = tpol.policy_scan(_policy(kind, tog, renew, cuda_device),
                               _t(vpn, cuda_device), _t(cci, cuda_device))
        assert ops.LAUNCHES["fsm_scan"] == before + 1
        want = tpol.policy_scan(_policy(kind, tog, renew, CPU), _t(vpn), _t(cci))
        assert 0 < int(want["x"].sum()) < want["x"].numel()   # the rows do toggle
        for k in ("x", "state", "total_cost"):
            assert torch.equal(got[k].cpu(), want[k]), k


FSM_EDGE_SHAPES = [(1, 1), (17, 63), (128, 2001), (17, 8760), (1, 8760), (128, 63)]


def _fsm_edge_args(n, T, device, hold):
    """Seeded rows whose windows run from 1 hour to past T (h >= T never
    lags), hold counts 1 (reactive) or 1-6 (hysteresis), and vpn/cci planes
    that start 8 bytes past a 16-byte boundary (odd T misaligns every other
    row as well)."""
    vpn, cci, tog = _fsm_inputs(31 + n + T, n, T)
    tog["h"] = (1 + (np.arange(n) * (T + 2)) // max(n - 1, 1)).astype(np.int32)
    if hold == 1:
        holds = (np.ones(n, np.int32),) * 2
    else:
        holds = (np.resize(np.array([1, 2, 3, 6], np.int32), n),
                 np.resize(np.array([6, 1, 4], np.int32), n))

    def plane(a):
        buf = torch.zeros(n * T + 1, dtype=torch.float64, device=device)
        view = buf[1:].view(n, T)
        view.copy_(_t(a, device))
        return view

    rows = [_t(tog[k], device) for k in ToggleParams._fields] + [_t(a, device) for a in holds]
    return [plane(vpn), plane(cci)] + rows


@pytest.mark.cuda
@pytest.mark.parametrize("hold", [1, 6], ids=["reactive", "hysteresis"])
@pytest.mark.parametrize("shape", FSM_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fsm_kernel_edge_shapes_bit_equal_to_cpu_plain(cuda_device, shape, hold):
    """Ragged N and T (one row, 17, a T of 1 and of 63, odd T), windows from
    1 hour to past T, misaligned rows: x, state and total_cost equal the CPU
    plain version bit for bit, for both renewal rules."""
    n, T = shape
    args = _fsm_edge_args(n, T, cuda_device, hold)
    assert args[0].data_ptr() % 16 == 8
    for renew in (False, True):
        before = ops.LAUNCHES["fsm_scan"]
        got = ops.fsm_scan(*args, renew_in_chunks=renew)
        assert ops.LAUNCHES["fsm_scan"] == before + 1
        want = ref.fsm_scan_ref(*(a.cpu() for a in args), renew_in_chunks=renew)
        for k in ("x", "state", "total_cost"):
            assert torch.equal(got[k].cpu(), want[k]), (k, renew)


@pytest.mark.cuda
def test_plan_fleet_gpu_matches_cpu(cuda_device):
    sc = build_fleet_scenario(16, horizon=2000, seed=0)
    ops.reset_launches()
    got = plan_fleet(sc.fleet, sc.demand, device=cuda_device)
    assert ops.LAUNCHES == {"tiered_cost_batched": 1, "fsm_scan": 1, "fsm_scan_gated": 0,
                            "forecaster_scan": 0, "forecaster_scan_bwd": 0,
                            "tiered_cost_scan": 0, "fsm_chunk": 0, "stream_chunk": 0,
                            "stream_chunk_gated": 0, "stream_chunk_live": 0,
                            "stream_chunk_routed": 0, "stream_chunk_routed_gated": 0,
                            "stream_chunk_routed_live": 0, "stream_chunk_pooled": 0,
                            "stream_chunk_pooled_gated": 0, "stream_chunk_routed_pooled": 0,
                            "stream_chunk_routed_pooled_gated": 0,
                            "stream_chunk_routed_small_port": 0, "flash_attention": 0,
                            "flash_attention_sm90": 0, "rmsnorm": 0, "int8_quantize": 0,
                            "int8_dequantize": 0, "tiered_cost": 0, "leg_segment_sum": 0,
                            "oracle_dp": 0, "moe_route": 0, "moe_dispatch": 0,
                            "moe_combine": 0}
    assert got["x"].is_cuda
    want = plan_fleet(sc.fleet, sc.demand, device="cpu")
    for k in ("x", "state"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("toggle_cost", "vpn_hourly", "cci_hourly"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-9, atol=1e-9)


def _scan_reset(kind: str, K: int) -> np.ndarray:
    """The month-to-date scan's reset patterns: month starts (730 h), none,
    hour 0 only, hour 0 and its neighbours plus the last hour, segments
    shorter than the kernel's 64-hour staged tile, and every hour."""
    k = np.arange(K)
    return {
        "monthly": k % 730 == 0,
        "none": np.zeros(K, bool),
        "at_0": k == 0,
        "edges": np.isin(k, [0, 1, 2, 63, 64, 65, K - 2, K - 1]),
        "short": k % 29 == 3,
        "every_hour": np.ones(K, bool),
    }[kind].astype(np.int32)


SCAN_CASES = [("monthly", 64, 2000), ("none", 64, 2000), ("at_0", 33, 700),
              ("edges", 31, 300), ("short", 33, 500), ("every_hour", 17, 130),
              ("monthly", 1, 1500), ("none", 2, 1), ("at_0", 3, 1), ("monthly", 2048, 24),
              ("edges", 31, 1300), ("short", 33, 1100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: f"{c[0]}-{c[1]}x{c[2]}")
def test_tiered_scan_kernel_matches_plain(cuda_device, case, dtype):
    """Month-to-date form against its plain version: float64 every bit,
    float32 at rtol = atol = 1e-6; reset patterns, N of 1, 2, 3, 17, 31, 33,
    64 and 2048, K of 1 to 2000, with the segment plan (K > 512) and with
    the resets applied in the carry (one segment slot)."""
    kind, N, K = case
    cum, d, b, r = _tiers(3, N, K, np.float64)
    cum0 = np.linspace(0.0, 5e4, N)
    args = [np.asarray(a, dtype) for a in (cum0, d, b, r)] + [_scan_reset(kind, K)]
    before = ops.LAUNCHES["tiered_cost_scan"]
    got = ops.tiered_cost_scan(*(_t(a, cuda_device) for a in args))
    assert ops.LAUNCHES["tiered_cost_scan"] == before + 1
    want = ref.tiered_cost_scan_ref(*(_t(a) for a in args))
    for g, w in zip(got, want):
        if dtype == np.float64:
            assert torch.equal(g.cpu(), w)
        else:
            torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_tiered_scan_kernel_nan_demand(cuda_device, dtype):
    """NaN and +inf demand: the carry holds them to the month's end (those
    hours price +0.0), the next reset clears them; NaN in the same places."""
    cum, d, b, r = _tiers(6, 33, 400, np.float64)
    d[0, 5], d[3, 71], d[2, 380], d[4, 150] = np.nan, np.nan, np.nan, np.inf
    args = ([np.asarray(a, dtype) for a in (np.zeros(33), d, b, r)]
            + [_scan_reset("short", 400)])
    got = ops.tiered_cost_scan(*(_t(a, cuda_device) for a in args))
    want = ref.tiered_cost_scan_ref(*(_t(a) for a in args))
    for g, w in zip(got, want):
        g = g.cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        if dtype == np.float64:
            assert _same_bits(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6, equal_nan=True)
    assert bool(torch.isnan(got[1][2]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["monthly", "edges", "every_hour", "none"])
def test_tiered_scan_segment_plan_on_the_card(cuda_device, kind):
    """The C call's pre-pass writes segment_plan(reset) into its scratch
    (a chunk of more than one segment slot)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.tiered_cost_scan import segment_plan, segment_slots

    N, K = 40, 40000 if kind == "monthly" else 3000      # past one segment slot
    reset = _t(_scan_reset(kind, K), cuda_device)
    cum, d, b, r = (_t(a, cuda_device) for a in _tiers(7, N, K, np.float64))
    plan = torch.full((K + 2,), -1, dtype=torch.int32, device=cuda_device)
    costs = torch.empty((N, K), dtype=torch.float64, device=cuda_device)
    cum_out = torch.empty(N, dtype=torch.float64, device=cuda_device)
    status = _lib.load().tiered_cost_scan_f64(
        cum[:, 0].contiguous().data_ptr(), d.data_ptr(), b.data_ptr(), r.data_ptr(),
        reset.data_ptr(), N, K, b.shape[1], segment_slots(N, K), plan.data_ptr(),
        costs.data_ptr(), cum_out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert status == 0
    want = segment_plan(reset.cpu())
    assert torch.equal(plan[:want.numel()].cpu(), want)


@pytest.mark.cuda
def test_chunk_kernels_match_plain(cuda_device):
    """Calendar pricing and fsm_chunk over chained K = 24 chunks that cross
    a month boundary: every output bit equal to the plain versions."""
    cum, d, b, r = _tiers(4, 96, 240, np.float64)
    vpn, cci, tog = _fsm_inputs(4, 96, 240)
    hol = np.resize(np.array([1, 2, 3, 6], np.int32), 96)
    rows = [tog[k] for k in ToggleParams._fields] + [hol, hol[::-1].copy()]
    pres = np.random.default_rng(4).uniform(0, 100, (8, 2, 24, 96))  # ring reads
    results = {}
    for dev in (cuda_device, CPU):
        carry = (torch.zeros((2, 96), dtype=torch.float64, device=dev),
                 torch.zeros((4, 96), dtype=torch.int32, device=dev),
                 torch.zeros((2, 96), dtype=torch.float64, device=dev))
        outs = []
        for c, t0 in enumerate(range(40, 232, 24)):   # month starts at 60, 120, 180
            sl = slice(t0, t0 + 24)
            costs, cal = ops.tiered_cost_calendar(
                carry[0], _t(d[:, sl].T, dev), _t(b, dev), _t(r, dev), t0, 60)
            out = ops.fsm_chunk(_t(vpn[:, sl].T, dev), _t(cci[:, sl].T, dev),
                                _t(pres[c, 0], dev), _t(pres[c, 1], dev),
                                *(_t(a, dev) for a in rows), carry[1], carry[2], t0,
                                renew_in_chunks=True)
            carry = (cal, out["carry"], out["pref"])
            outs.append({"costs": costs, "cal": cal, **out})
        results[dev.type] = outs
    assert len(results["cuda"]) == 8
    for g, w in zip(results["cuda"], results["cpu"]):
        for k in w:
            assert torch.equal(g[k].cpu(), w[k]), k


@pytest.mark.cuda
def test_runtime_gpu_matches_cpu(cuda_device):
    """The streaming runtime on the card (chunked, then a per-tick tail)
    against the CPU runtime streaming hour by hour, at 16 x 2000."""
    sc = build_fleet_scenario(16, horizon=2000, seed=0)
    for kind in ("reactive", "hysteresis"):
        fleet = dataclasses.replace(sc.fleet, policy=kind)
        ops.reset_launches()
        rt = FleetRuntime(fleet, device=cuda_device)
        outs = [rt.step_many(sc.demand[:, t:t + 24]) for t in range(0, 1992, 24)]
        outs += [{k: v[:, None] for k, v in rt.step(sc.demand[:, t]).items()}
                 for t in range(1992, 2000)]
        got = {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}
        assert ops.LAUNCHES["stream_chunk"] == 83 + 8
        assert ops.LAUNCHES["tiered_cost_scan"] == ops.LAUNCHES["fsm_chunk"] == 0
        want = FleetRuntime(fleet, device="cpu").run(sc.demand)
        for k in want:
            assert np.array_equal(got[k], want[k]), k


def _head_rows(arrays, n):
    """The first n links of stacked FleetArrays (nested ToggleParams too)."""
    cut = lambda f: (type(f)(*(x[:n].contiguous() for x in f)) if isinstance(f, tuple)
                     else f[:n].contiguous())
    return type(arrays)(*(cut(f) for f in arrays))


def _same_bits(got, want):
    """Equal shapes and types, NaN in the same places, every bit equal
    elsewhere, signed zeros included (torch.equal is False wherever both hold
    NaN)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    as_int = {torch.float64: torch.int64, torch.float32: torch.int32}.get(got.dtype)
    if as_int is None:
        return torch.equal(got, want)
    ng, nw = torch.isnan(got), torch.isnan(want)
    return (torch.equal(ng, nw) and torch.equal(got.view(as_int).masked_fill(ng, 0),
                                                want.view(as_int).masked_fill(nw, 0)))


STREAM_CHUNK_CASES = ["chained", "endogenous", "k1", "past_tile_and_ring", "ragged_rows",
                      "nonfinite_demand", "k2", "k3", "k_tick_max", "k_tick_max_plus_1", "k8",
                      "k9", "k23", "k25", "fleet128"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_CHUNK_CASES)
def test_stream_chunk_kernel_matches_plain(cuda_device, case):
    """The runtime's fused chunk kernel against stream_chunk_ref on the same
    packed blocks and carries, from a stream's own state, every output bit:
    four chained K = 24 chunks from hour 696 (across the month start at
    730), the same with endogenous CCI demand, K = 1, one K past the
    kernel's tile and the window ring, 37 rows (not a multiple of the
    16-row block), demand hours holding NaN and +inf; and K around both
    launch forms' edges (the tick form's last K and one past it, one and
    two past a chunk-form sub-tile, one short of and one past a 24-hour
    tile) from hour 726, and the 128-link fleet at K = 24."""
    sc = build_fleet_scenario(128 if case == "fleet128" else 64, horizon=1200, seed=0)
    fleet, demand, cci = sc.fleet, sc.demand, None
    t_first, Ks = 696, [24] * 4
    edge_K = {"k2": 2, "k3": 3, "k_tick_max": TICK_MAX_K, "k_tick_max_plus_1": TICK_MAX_K + 1,
              "k8": 8, "k9": 9, "k23": 23, "k25": 25}
    if case in edge_K:
        t_first, Ks = 726, [edge_K[case]] * 3
    elif case == "endogenous":
        cci = demand * 1.5
    elif case == "k1":
        t_first, Ks = 728, [1] * 4
    elif case == "ragged_rows":
        fleet, demand, Ks = _head_rows(fleet.stack(torch.float64, cuda_device), 37), \
            demand[:37], [24] * 2
    elif case == "nonfinite_demand":
        demand = demand.copy()
        demand[5, 699], demand[5, 706], demand[9, 726] = np.nan, np.inf, np.nan
        Ks = [24] * 2
    rt = FleetRuntime(fleet, device=cuda_device)
    if case == "past_tile_and_ring":
        t_first, Ks = 500, [max(rt.hbuf, 32) + 45]
    cblk = lambda a, b: None if cci is None else cci[:, a:b]
    t = 0
    while t < t_first:
        k = min(24, t_first - t)
        rt.step_many(demand[:, t:t + k], cci_demand_block=cblk(t, t + k))
        t += k
    for K in Ks:
        block, _, endo = rt._pack(demand[:, t:t + K], cblk(t, t + K))
        dev_block = torch.from_numpy(block).to(cuda_device)
        want, want_fsm = ref.stream_chunk_ref(*rt._chunk_args(dev_block, K, endo),
                                              renew_in_chunks=rt.policy.renew_in_chunks)
        before = ops.LAUNCHES["stream_chunk"]
        got = rt._launch(dev_block, K, endo)
        assert ops.LAUNCHES["stream_chunk"] == before + 1
        assert _same_bits(got, want), (case, t)
        assert _same_bits(rt._state.fsm, want_fsm), (case, t)
        rt._commit(got.cpu().numpy(), K)
        t += K
    if case == "nonfinite_demand":
        assert bool(torch.isnan(rt._state.dev_cal[0, 5])) and bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["tick", "chunk"])
@pytest.mark.parametrize("K", range(1, TICK_MAX_K + 1))
def test_stream_chunk_forms_match_plain(cuda_device, K, form):
    """Both launch forms, forced, at every K the tick form has an instance
    for, across the month start at hour 730 with NaN and +inf demand in
    three links, windows of 1 to 12 hours in a quarter of the links (bases
    inside the chunk) and no provisioning delay in eight: every output bit
    equal to stream_chunk_ref."""
    sc = build_fleet_scenario(64, horizon=1200, seed=0)
    demand = sc.demand.copy()
    demand[5, 727], demand[6, 729], demand[9, 731] = np.nan, np.inf, np.nan
    arrays = sc.fleet.stack(torch.float64, cuda_device)
    tog = arrays.toggle
    h, D = tog.h.clone(), tog.D.clone()
    h[::4] = torch.arange(1, 17, dtype=torch.int32, device=cuda_device) % 12 + 1
    D[1::8] = 0
    arrays = arrays._replace(toggle=tog._replace(h=h, D=D))
    rt = FleetRuntime(arrays, device=cuda_device)
    for t in range(0, 720, 24):
        rt.step_many(demand[:, t:t + 24])
    t = 720
    while t < 736:
        block, _, endo = rt._pack(demand[:, t:t + K], None)
        args = rt._chunk_args(torch.from_numpy(block).to(cuda_device), K, endo)
        renew = rt.policy.renew_in_chunks
        want, want_fsm = ref.stream_chunk_ref(*args, renew_in_chunks=renew)
        got, got_fsm = _stream_chunk_launch(form, *args, renew_in_chunks=renew)
        assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm), (K, form, t)
        rt._launch(args[0], K, endo)
        rt._commit(want.cpu().numpy(), K)
        t += K


def test_lm_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(torch.zeros((4, 16)), torch.ones(16))
    with pytest.raises(TypeError):
        rmsnorm(torch.zeros((4, 16), dtype=torch.float64), torch.ones(16, dtype=torch.float64))


# (B, Hq, Hkv, Sq, Skv, D, Dv), causal, window, q_offset: the TPU kernel's
# contract, with ragged lengths the Pallas kernel would need padding for.
ATTENTION_CASES = [
    ((2, 4, 2, 256, 384, 64, 64), False, 0, 0),
    ((1, 4, 2, 300, 300, 64, 64), True, 100, 0),
    ((2, 4, 2, 64, 320, 64, 64), True, 0, 256),
    ((1, 4, 4, 256, 256, 128, 128), True, 0, 0),
    ((1, 2, 1, 200, 260, 192, 128), True, 0, 60),
    ((1, 4, 2, 1000, 1000, 64, 64), True, 0, 0),
    ((1, 2, 1, 128, 128, 64, 64), True, 16, 100),   # rows 143.. see no key
    ((1, 8, 2, 512, 512, 120, 120), True, 256, 0),  # H2O-Danube3's head dim, a window
]


def _attention_inputs(case, device, dtype):
    (B, Hq, Hkv, Sq, Skv, D, Dv), _, _, _ = case
    rng = np.random.default_rng(21)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=device).to(dtype)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, Dv))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ATTENTION_CASES, ids=lambda c: "x".join(map(str, c[0])))
def test_flash_attention_kernel_matches_plain(cuda_device, case, dtype):
    """bf16 through the Hopper entry (every case's head dims are multiples
    of 8), float32 through the general one."""
    _, causal, window, q_offset = case
    q, k, v = _attention_inputs(case, cuda_device, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = dict(ops.LAUNCHES)
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    sm90 = ops.LAUNCHES["flash_attention_sm90"] - before["flash_attention_sm90"]
    assert sm90 == (1 if dtype == torch.bfloat16 else 0) and got.dtype == dtype
    want = ref.attention(q.float(), k.float(), v.float(), **kw)
    assert torch.isfinite(got).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    # Strided inputs (the LM passes transposes) give the same result.
    got_t = ops.attention(*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)),
                          **kw)
    assert torch.equal(got_t, got)


@pytest.mark.cuda
def test_flash_attention_unaligned_bf16_takes_the_general_entry(cuda_device):
    """A bf16 q whose base pointer lies one element past a 16-byte boundary:
    the general entry launches, not the Hopper one, and still matches."""
    case = ((2, 4, 2, 200, 200, 64, 64), True, 0, 0)
    q, k, v = _attention_inputs(case, cuda_device, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    q1 = buf[1:].view(q.shape)
    q1.copy_(q)
    assert q1.data_ptr() % 16 == 2
    before = dict(ops.LAUNCHES)
    got = ops.attention(q1, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert ops.LAUNCHES["flash_attention_sm90"] == before["flash_attention_sm90"]
    want = ref.attention(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 2048), (4, 2048), (3, 5, 384), (7, 2047)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    """Every shape, and the same rows as a view at an odd element offset
    (the kernel's scalar branch)."""
    rng = np.random.default_rng(22)
    x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=cuda_device)
    w = torch.as_tensor(rng.standard_normal(shape[-1:]).astype(np.float32), device=cuda_device)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    x_odd = buf[1:].view(shape)
    x_odd.copy_(x.to(dtype))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for xs in (x.to(dtype), x_odd):
        before = ops.LAUNCHES["rmsnorm"]
        got = ops.rmsnorm(xs, w.to(dtype))
        assert ops.LAUNCHES["rmsnorm"] == before + 1 and got.dtype == dtype
        want = ref.rmsnorm(xs.float(), w.to(dtype).float())
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_lm_on_the_card_matches_the_cpu(cuda_device):
    """A reduced dense LM (GQA group 2, and a sliding window) in float32:
    greedy tokens equal, logits within 1e-4, every norm and prefill
    attention through the kernels."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import lm
    from repro_torch.train.serve import greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, kw in (("tinyllama-1.1b", dict(d_model=128, n_heads=8)), ("h2o-danube-3-4b", {})):
        cfg = reduce_config(get_config(arch), **kw)
        model = lm.LM(cfg, seed=3, device=cuda_device)
        cpu = lm.LM(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (2, 48)))
        ops.reset_launches()
        got = greedy_generate(cfg, model, tokens, 8)
        assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
        assert ops.LAUNCHES["rmsnorm"] == 8 * (2 * cfg.n_layers + 1)
        assert torch.equal(got.cpu(), greedy_generate(cfg, cpu, tokens, 8))
        with torch.inference_mode():
            g, _ = lm.forward(cfg, model, tokens.to(cuda_device))
            c, _ = lm.forward(cfg, cpu, tokens)
        torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The actuation slice: int8 (de)quantization, static tiered cost, the sync
# ---------------------------------------------------------------------------

INT8_CASES = [(4096, 2048), (2048, 5632), (17, 2048), (1, 2048), (300, 33), (5, 13000)]


def _int8_rows(shape, dtype, device, seed=0):
    """Seeded rows with a row of zeros and one whose |max| is 1e-29."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=g) * 3.0
    x[0] = 0.0
    if shape[0] > 2:
        x[2] *= 1e-29 / x[2].abs().max()
    return x.to(dtype).to(device)


def test_actuation_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.int8_quant import int8_dequantize, int8_quantize
    from repro_torch.kernels.tiered_cost import tiered_cost

    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        int8_quantize(x)
    with pytest.raises(ValueError, match="CUDA"):
        int8_dequantize(torch.zeros((4, 8), dtype=torch.int8), torch.ones((4, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        tiered_cost(x, x, (1.0, float("inf")), (0.1, 0.05))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", INT8_CASES, ids=lambda s: "x".join(map(str, s)))
def test_int8_kernels_bit_equal_to_plain(cuda_device, shape, dtype):
    """Any N and d (ragged, one row, a row wider than the shared-memory
    cache), a zero row and a tiny row: q, scale and both dequantized types
    equal the plain version on the same CUDA tensors."""
    x = _int8_rows(shape, dtype, cuda_device)
    before = dict(ops.LAUNCHES)
    q, s = ops.int8_quantize(x)
    wq, ws = ref.int8_quantize(x)
    assert torch.equal(s, ws), f"{int((s != ws).sum())} scales differ"
    assert torch.equal(q, wq), f"{int((q != wq).sum())} of {q.numel()} q differ"
    assert bool((q[0] == 0).all())
    for odt in (torch.float32, torch.bfloat16):
        assert torch.equal(ops.int8_dequantize(q, s, odt), ref.int8_dequantize(q, s, odt))
    assert ops.LAUNCHES["int8_quantize"] == before["int8_quantize"] + 1
    assert ops.LAUNCHES["int8_dequantize"] == before["int8_dequantize"] + 2
    # and equal to the CPU plain version on the same values
    cq, cs = ref.int8_quantize(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)


@pytest.mark.cuda
def test_int8_collectives_guard_kernel_bit_equal_to_plain(cuda_device):
    """The JAX collectives' scale guard, ``max(amax / 127, 1e-30)``: q and
    scale equal the plain version on the card and on the CPU on rows whose
    |max| is 0, 1e-29, 1.2e-28, exactly 127 * 1e-30 and 3, and the clip
    changes nothing (|round(x / scale)| <= 127 before it)."""
    g = torch.Generator(device="cpu").manual_seed(6)
    x = torch.randn((5, 300), generator=g)
    for r, t in enumerate((0.0, 1e-29, 1.2e-28, float(np.float32(127) * np.float32(1e-30)), 3.0)):
        j = int(x[r].abs().argmax())
        x[r] *= t / x[r].abs().max()
        x[r, j] = t
    x = x.to(cuda_device)
    before = ops.LAUNCHES["int8_quantize"]
    q, s = ops.int8_quantize(x, guard="collectives")
    assert ops.LAUNCHES["int8_quantize"] == before + 1
    wq, ws = ref.int8_quantize(x, guard="collectives")
    assert torch.equal(q, wq) and torch.equal(s, ws)
    cq, cs = ref.int8_quantize(x.cpu(), guard="collectives")
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
    assert float(s[3, 0]) == float(np.float32(1e-30)) and float(s[0, 0]) == float(np.float32(1e-30))
    unclipped = torch.round(x / s)
    assert bool((unclipped.abs() <= 127).all()) and torch.equal(unclipped.to(torch.int8), q)


def _same(got, want):
    """Equal shapes, types and NaN positions, and equal values elsewhere."""
    return (got.shape == want.shape and got.dtype == want.dtype
            and torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)))


def _nonfinite_rows(d, dtype, device):
    """Rows holding a NaN, +inf, -inf, NaN and inf together, zeros, and a
    finite row."""
    g = torch.Generator(device="cpu").manual_seed(17)
    x = torch.randn((6, d), generator=g) * 3.0
    x[0, 5] = float("nan")
    x[1, 0] = float("inf")
    x[2, d - 1] = float("-inf")
    x[3, 2], x[3, 7] = float("inf"), float("nan")
    x[4] = 0.0
    return x.to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("guard", ["pallas", "collectives"])
@pytest.mark.parametrize("d", [256, 2048, 2047, 32000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_quantize_nonfinite_rows_match_plain(cuda_device, dtype, d, guard):
    """NaN, +inf and -inf rows as JAX quantizes them: scale NaN (a NaN in the
    row) or inf, q = 0 on the whole row; kernel == card plain == CPU plain.
    Dequantized, those rows are NaN (0 · NaN, 0 · inf)."""
    x = _nonfinite_rows(d, dtype, cuda_device)
    q, s = ops.int8_quantize(x, guard=guard)
    wq, ws = ref.int8_quantize(x, guard=guard)
    cq, cs = ref.int8_quantize(x.cpu(), guard=guard)
    assert torch.equal(q, wq) and _same(s, ws)
    assert torch.equal(q.cpu(), cq) and _same(s.cpu(), cs)
    assert bool(torch.isnan(s[[0, 3]]).all()) and bool((s[[1, 2]] == float("inf")).all())
    assert bool((q[:5] == 0).all()) and bool((q[5] != 0).any())
    for odt in (torch.float32, torch.bfloat16):
        got = ops.int8_dequantize(q, s, odt)
        assert _same(got, ref.int8_dequantize(q, s, odt))
        assert bool(torch.isnan(got[:4]).all()) and bool(torch.isfinite(got[4:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("guard", ["pallas", "collectives"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2048, 256), (300, 2048), (64, 5632), (9, 32000),
                                   (5, 40000), (33, 2047)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_quantize_width_classes_and_views(cuda_device, shape, dtype, guard):
    """Each width class of the quantize kernel (a warp per row up to 2048
    float32 values, a block per row past it, the scalar branch past 512 x 16
    vectors or at d = 2047), on a contiguous tensor and on a view that starts
    one element past a 16-byte boundary: kernel == card plain == CPU plain."""
    n, d = shape
    g = torch.Generator(device="cpu").manual_seed(n + d)
    x = (torch.randn((n, d), generator=g) * 3.0).to(dtype).to(cuda_device)
    buf = torch.zeros(n * d + 1, dtype=dtype, device=cuda_device)
    view = buf[1:].view(n, d)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    for a in (x, view):
        before = ops.LAUNCHES["int8_quantize"]
        q, s = ops.int8_quantize(a, guard=guard)
        assert ops.LAUNCHES["int8_quantize"] == before + 1
        wq, ws = ref.int8_quantize(a, guard=guard)
        assert torch.equal(s, ws), f"{int((s != ws).sum())} scales differ"
        assert torch.equal(q, wq), f"{int((q != wq).sum())} of {q.numel()} q differ"
        cq, cs = ref.int8_quantize(a.cpu(), guard=guard)
        assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)


@pytest.mark.cuda
def test_int8_kernels_check_their_inputs(cuda_device):
    from repro_torch.kernels.int8_quant import int8_dequantize, int8_quantize

    x = torch.randn((8, 16), device=cuda_device)
    with pytest.raises(TypeError):
        int8_quantize(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        int8_quantize(x.t())
    with pytest.raises(ValueError, match="shapes"):
        int8_dequantize(torch.zeros((8, 16), dtype=torch.int8, device=cuda_device),
                        torch.ones((4, 1), device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8760, 2048), (300, 7), (1, 1)])
def test_tiered_cost_kernel_bit_equal_to_plain(cuda_device, shape):
    from repro_torch.core.planner import dci_scenario

    g = torch.Generator(device="cpu").manual_seed(3)
    d = (torch.rand(shape, generator=g) * 500.0).to(cuda_device)
    cum = torch.cumsum(d, dim=0) - d
    for tier in (dci_scenario().vpn_tier, AWS_EGRESS_INTERNET):   # inf last bounds
        before = ops.LAUNCHES["tiered_cost"]
        got = ops.tiered_cost(cum, d, tier.bounds_gb, tier.rates)
        assert ops.LAUNCHES["tiered_cost"] == before + 1
        want = ref.tiered_cost(cum, d, tier.bounds_gb, tier.rates)
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), ref.tiered_cost(cum.cpu(), d.cpu(), tier.bounds_gb,
                                                      tier.rates))


@pytest.fixture
def nccl_pod_mesh(cuda_device, tmp_path):
    """A one-rank NCCL world and a (1, 1, 1) pod mesh on the card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_compressed_sync_on_nccl_matches_the_plain_path(nccl_pod_mesh, cuda_device):
    from repro_torch.dist.collectives import sync_grads

    g = torch.Generator(device="cpu").manual_seed(5)
    grads = {"w": torch.randn((512, 256), generator=g).to(cuda_device),
             "b": [torch.randn((300,), generator=g).to(cuda_device)],
             "t": (torch.randn((3, 4, 40), generator=g).to(cuda_device),)}
    for mode in ("direct", "hierarchical"):
        out, err = sync_grads(grads, nccl_pod_mesh, mode=mode)
        assert err is None
        assert torch.equal(out["w"], grads["w"]) and torch.equal(out["b"][0], grads["b"][0])
    err = None
    for _ in range(2):
        ops.reset_launches()
        out, new_err = sync_grads(grads, nccl_pod_mesh, mode="compressed", err_state=err)
        assert ops.LAUNCHES["int8_quantize"] == 3 and ops.LAUNCHES["int8_dequantize"] == 6
        leaves = lambda t: [t["b"][0], t["t"][0], t["w"]]
        olds = leaves(err) if err is not None else [None] * 3
        for a, e, o, ne in zip(leaves(grads), olds, leaves(out), leaves(new_err)):
            u = a + e if e is not None else a
            q, s = ref.int8_quantize(u.reshape(-1, u.shape[-1]), guard="collectives")
            deq = ref.int8_dequantize(q, s).view(u.shape)
            assert torch.equal(o, deq) and torch.equal(ne, u - deq)
        err = new_err


# ---------------------------------------------------------------------------
# NaN in the tier fold; the flat-plane dequantize and static tiered cost
# ---------------------------------------------------------------------------

def _nan_tiers(dtype, device):
    """Seeded (64, 300) planes with a NaN month-to-date volume, a NaN demand,
    both in one hour and a NaN demand in a row's first hour."""
    cum, d, b, r = (_t(a, device) for a in _tiers(9, 64, 300, dtype))
    cum[0, 3] = float("nan")
    d[1, 5] = float("nan")
    cum[2, 7], d[2, 7] = float("nan"), float("nan")
    d[3, 0] = float("nan")
    return cum, d, b, r


TIER_NAN_KINDS = ["batched-f64", "batched-f32", "scan-f64", "scan-f32", "calendar", "static"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TIER_NAN_KINDS)
def test_tiered_kernels_on_nan_hours_match_plain(cuda_device, kind):
    """Hours whose demand or month-to-date volume is NaN: the fold kernels
    (``tiered_cost_batched``, both forms of ``tiered_cost_scan``) price them
    +0.0 and the static ``tiered_cost`` gives NaN, as their plain versions on
    the same CUDA tensors; every other bit equal as on finite input (float32
    batched and month-to-date at ``rtol=atol=1e-6``, as their finite tests)."""
    dtype = np.float32 if kind.endswith("f32") or kind == "static" else np.float64
    cum, d, b, r = _nan_tiers(dtype, cuda_device)
    name = "tiered_cost" if kind == "static" else (
        "tiered_cost_batched" if kind.startswith("batched") else "tiered_cost_scan")
    before = ops.LAUNCHES[name]
    if kind.startswith("batched"):
        got, want = ops.tiered_cost_batched(cum, d, b, r), ref.tiered_cost_batched_ref(cum, d, b, r)
        nan_at = torch.isnan(cum) | torch.isnan(d)
    elif kind.startswith("scan"):
        reset = (torch.arange(300, device=cuda_device) % 100 == 50).to(torch.int32)
        cum0 = cum[:, 0].contiguous()
        cum0[5] = float("nan")                            # a NaN carry in
        got, cum_got = ops.tiered_cost_scan(cum0, d, b, r, reset)
        want, cum_want = ref.tiered_cost_scan_ref(cum0, d, b, r, reset)
        assert _same_bits(cum_got, cum_want)
        nan_at = torch.zeros_like(got, dtype=torch.bool)  # NaN carried to the reset at 50
        nan_at[1, 5:50] = nan_at[2, 7:50] = nan_at[3, :50] = nan_at[5, :50] = True
    elif kind == "calendar":
        carry = torch.stack([cum[:, 0], torch.zeros_like(cum[:, 0])]).contiguous()
        carry[0, 4] = float("nan")
        dT = d.T.contiguous()
        got, c_got = ops.tiered_cost_calendar(carry, dT, b, r, 700, 730)
        want, c_want = ref.tiered_cost_calendar_ref(carry, dT, b, r, 700, 730)
        assert _same_bits(c_got, c_want)
        got, want = got.T, want.T
        nan_at = torch.zeros_like(got, dtype=torch.bool)  # a NaN prefix stays NaN
        nan_at[1, 5:] = nan_at[2, 7:] = nan_at[3] = nan_at[4] = True
    else:
        tier = AWS_EGRESS_INTERNET
        cum, d = cum.T.contiguous(), d.T.contiguous()
        got, want = ops.tiered_cost(cum, d, tier.bounds_gb, tier.rates), ref.tiered_cost(
            cum, d, tier.bounds_gb, tier.rates)
        nan_at = torch.isnan(cum) | torch.isnan(d)
    assert ops.LAUNCHES[name] == before + 1
    assert bool(nan_at.any())
    if kind == "static":
        assert torch.equal(torch.isnan(got), nan_at) and _same_bits(got, want)
        return
    assert not bool(torch.isnan(got).any()) and not bool(torch.isnan(want).any())
    assert bool((got[nan_at] == 0).all()) and not bool(torch.signbit(got[nan_at]).any())
    if dtype == np.float64:
        assert _same_bits(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


DEQUANT_D = [1, 15, 16, 256, 2048, 5632, 32000]


@pytest.mark.cuda
@pytest.mark.parametrize("odt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", DEQUANT_D)
def test_int8_dequantize_flat_plane_bit_equal_to_plain(cuda_device, d, odt):
    """The flat-plane dequantize on one row and a ragged row count, on q
    contiguous (the vector path where 16 divides d) and on a view of q one
    byte past a 16-byte boundary (the scalar branch), with a NaN and an inf
    scale: bit-equal to ``ref.int8_dequantize`` and, in float32, to
    ``torch.mul(q, scale)``; one launch a call."""
    g = torch.Generator(device="cpu").manual_seed(d)
    for n in (1, 37):
        q = torch.randint(-127, 128, (n, d), generator=g, dtype=torch.int8).to(cuda_device)
        s = (torch.rand((n, 1), generator=g) * 1e-2).to(cuda_device)
        if n > 2:
            s[0, 0], s[1, 0] = float("nan"), float("inf")
        buf = torch.zeros(n * d + 1, dtype=torch.int8, device=cuda_device)
        view = buf[1:].view(n, d)
        view.copy_(q)
        assert view.data_ptr() % 16 != 0
        for a in (q, view):
            before = ops.LAUNCHES["int8_dequantize"]
            got = ops.int8_dequantize(a, s, odt)
            assert ops.LAUNCHES["int8_dequantize"] == before + 1
            want = ref.int8_dequantize(a, s, odt)
            assert got.dtype == odt and _same(got.float(), want.float())
            if odt == torch.float32:
                assert _same_bits(got, torch.mul(a, s)) and _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5), (1, 4099), (8759, 2047)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tiered_cost_kernel_tails_and_misaligned_views(cuda_device, shape):
    """The static kernel's scalar tail (T·P % 4 != 0) and its scalar loop (a
    view one float past a 16-byte boundary), on both tier tables (infinite
    last bounds): bit-equal to the plain version."""
    from repro_torch.core.planner import dci_scenario

    T, P = shape
    assert (T * P) % 4 != 0
    g = torch.Generator(device="cpu").manual_seed(T + P)
    d = (torch.rand(shape, generator=g) * 500.0).to(cuda_device)
    cum = torch.cumsum(d, dim=0) - d
    buf = torch.zeros((2, T * P + 1), device=cuda_device)
    cv, dv = buf[0, 1:].view(T, P), buf[1, 1:].view(T, P)
    cv.copy_(cum)
    dv.copy_(d)
    assert cv.data_ptr() % 16 != 0 and dv.data_ptr() % 16 != 0
    for tier in (dci_scenario().vpn_tier, AWS_EGRESS_INTERNET):
        for c, dd in ((cum, d), (cv, dv)):
            before = ops.LAUNCHES["tiered_cost"]
            got = ops.tiered_cost(c, dd, tier.bounds_gb, tier.rates)
            assert ops.LAUNCHES["tiered_cost"] == before + 1
            assert _same_bits(got, ref.tiered_cost(c, dd, tier.bounds_gb, tier.rates))


def test_leg_segment_sum_wrapper_refuses_cpu_tensors_and_bad_operands():
    """The segment-sum wrapper launches on CUDA tensors or raises."""
    op = trout.RoutingPlan(paths=((0,), (1, 0)), n_ports=2).operand(torch.float64, "cpu")
    src = torch.zeros((2, 5), dtype=torch.float64)
    idx = (op.index.order, op.index.start)
    with pytest.raises(ValueError, match="CUDA"):
        leg_segment_sum([src], [op.vpn_w], op.leg_pair, *idx)
    with pytest.raises(ValueError, match="one or two planes"):
        leg_segment_sum([src] * 3, [op.vpn_w] * 3, op.leg_pair, *idx)


LEG_CASES = {  # P, T, M, padding legs, max hops
    "unicast-year": (2048, 8760, 128, 0, 1),
    "multihop": (300, 1000, 64, 0, 3),
    "padded-nan": (2048, 777, 128, 2048, 3),
    "one-port": (5, 33, 1, 3, 1),
}


def _leg_case(P, T, M, pad, hops, device):
    rng = np.random.default_rng(P + T + M)
    paths = tuple(tuple(rng.choice(M, size=int(rng.integers(1, min(hops, M) + 1)),
                                   replace=False).tolist()) for _ in range(P))
    plan = trout.RoutingPlan(paths=paths, n_ports=M)
    op = plan.pad_to(plan.total_hops + pad).operand(torch.float64, device)
    src = rng.normal(scale=100.0, size=(2, P, T))
    src[:, 0, 3], src[:, 0, 5] = np.nan, np.inf
    src[:, 1, 7] = -0.0
    return [_t(s, device) for s in src], op


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LEG_CASES))
def test_leg_segment_sum_kernel_bit_equal_to_plain(cuda_device, case):
    """One- and two-plane launches against the plain leg loop on the card and
    on the CPU, every bit (NaN in the same places)."""
    P, T, M, pad, hops = LEG_CASES[case]
    srcs, op = _leg_case(P, T, M, pad, hops, cuda_device)
    ws = (op.vpn_w, op.attach_w)
    before = ops.LAUNCHES["leg_segment_sum"]
    both = ops.leg_segment_sum(tuple(srcs), op.leg_pair, op.leg_port, ws, M,
                               index=(op.index.order, op.index.start))
    one = ops.leg_segment_sum(srcs[1], op.leg_pair, op.leg_port, ws[1], M)
    assert ops.LAUNCHES["leg_segment_sum"] == before + 2
    assert torch.equal(one.view(torch.int64), both[1].view(torch.int64))
    for s, w, got in zip(srcs, ws, both):
        want = ref.leg_segment_sum_ref(s, op.leg_pair, op.leg_port, w, M)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
        if case == "multihop":
            cpu = ref.leg_segment_sum_ref(s.cpu(), op.leg_pair.cpu(), op.leg_port.cpu(),
                                          w.cpu(), M)
            assert torch.equal(got.cpu().view(torch.int64), cpu.view(torch.int64))


TOPOLOGY_CASES = {
    "relay": lambda: tscen.build_relay_scenario(horizon=1200, seed=0),
    "multicast": lambda: tscen.build_multicast_scenario(n_leaves=4, horizon=1200, seed=0),
    "topology-64": lambda: tscen.build_topology_scenario(
        64, n_facilities=8, ports_per_facility=4, horizon=2000, seed=0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_plan_topology_gpu_matches_cpu(cuda_device, case):
    sc = TOPOLOGY_CASES[case]()
    ops.reset_launches()
    got = plan_topology(sc.topo, sc.demand, device=cuda_device)
    assert {k: ops.LAUNCHES[k] for k in ("tiered_cost_batched", "leg_segment_sum",
                                         "fsm_scan")} == {
        "tiered_cost_batched": 1, "leg_segment_sum": 1, "fsm_scan": 1}
    assert got["x"].is_cuda
    want = plan_topology(sc.topo, sc.demand, device="cpu")
    for k in ("x", "state", "n_pairs", "pair_demand"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("toggle_cost", "static_vpn", "static_cci", "vpn_hourly", "cci_hourly",
              "port_demand"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-9, atol=1e-9)


def _routed_scenario(name, pad, hpm):
    """A topology scenario with its calendar set to ``hpm`` hours a month and
    its routing padded by ``pad`` legs: (scenario, spec, routing)."""
    sc = {"relay": lambda: tscen.build_relay_scenario(horizon=200, seed=0),
          "multicast": lambda: tscen.build_multicast_scenario(n_leaves=3, horizon=200, seed=0),
          "topology": lambda: tscen.build_topology_scenario(64, n_facilities=8,
                                                            ports_per_facility=4,
                                                            horizon=200, seed=0),
          # 200 or 400 pairs on 4 ports: the hottest port holds 76 or 165 legs
          "hot-port": lambda: tscen.build_topology_scenario(200, n_facilities=2,
                                                            ports_per_facility=2,
                                                            horizon=200, seed=0),
          "hotter-port": lambda: tscen.build_topology_scenario(400, n_facilities=2,
                                                               ports_per_facility=2,
                                                               horizon=200, seed=0),
          # the streamed 2048-pair cell over 200 hours: ports with no legs, a 105-leg port
          "main-cell": lambda: tscen.build_topology_scenario(2048, n_facilities=32,
                                                             ports_per_facility=4, reach=2,
                                                             horizon=200, seed=0)}[name]()
    topo = dataclasses.replace(sc.topo, hours_per_month=hpm)
    r = optimize_routing(topo, sc.demand)
    return sc, topo, r.pad_to(r.n_legs + pad)


def test_stream_chunk_routed_wrapper_refuses_cpu_tensors_and_bad_operands():
    """The routed chunk's wrapper launches on CUDA tensors or raises: CPU
    operands, a block of the wrong length, a routing without its port-major
    index or with an index that lacks the port-major leg descriptors, and a
    carry of the wrong type are refused before anything is built."""
    sc, topo, r = _routed_scenario("relay", 2, 730)
    rt = FleetRuntime(topo, routing=r, device="cpu")
    block, K, endo = rt._pack(sc.demand[:, :24], None)
    args = list(rt._chunk_args(torch.from_numpy(block), K, endo))
    with pytest.raises(ValueError, match="CUDA"):
        stream_chunk_routed(*args)
    with pytest.raises(ValueError, match="block"):
        stream_chunk_routed(args[0][:-1], *args[1:])
    no_index = list(args)
    no_index[17] = args[17]._replace(index=None)     # the routing operand
    with pytest.raises(ValueError, match="index"):
        stream_chunk_routed(*no_index)
    idx = args[17].index
    no_legs = list(args)
    no_legs[17] = args[17]._replace(index=idx._replace(leg_pair_pm=None, vpn_w_pm=None,
                                                       attach_w_pm=None))
    with pytest.raises(ValueError, match="leg descriptors"):
        stream_chunk_routed(*no_legs)
    bad = list(args)
    bad[-4] = bad[-4].to(torch.int64)                 # the FSM carry
    with pytest.raises(ValueError, match="operand"):
        stream_chunk_routed(*bad)


ROUTED_CASES = {  # scenario, padding legs, billing month, first hour, Ks, endogenous, NaN hours
    "relay-padded": ("relay", 3, 730, 48, [24] * 3, False, ()),
    "multicast-tree": ("multicast", 0, 730, 24, [24] * 3, False, ()),
    "nan-pair0-padded": ("topology", 4, 730, 48, [24] * 2, False, (40, 51, 58)),
    "k1-month-start": ("topology", 0, 30, 28, [1] * 4, False, ()),
    "k24-month-inside": ("topology", 0, 30, 48, [24] * 3, False, ()),
    "past-hbuf": ("relay", 0, 730, 48, [120], False, ()),
    "endogenous": ("topology", 0, 730, 48, [24] * 3, True, ()),
    "hot-port-76-legs": ("hot-port", 0, 730, 48, [24, 1, 33], False, ()),
    "hot-port-165-legs": ("hotter-port", 0, 730, 48, [24, 1, 33], False, ()),
    "main-cell-empty-ports": ("main-cell", 0, 730, 48, [24, 5], False, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ROUTED_CASES))
@pytest.mark.parametrize("form", ["port_block", "small_port"])
def test_stream_chunk_routed_kernel_matches_plain(cuda_device, monkeypatch, form, case):
    """The routed chunk kernel against stream_chunk_routed_ref on the card,
    on the same packed blocks and carries of a stream's own state, every
    output bit (NaN in the same places): a padded relay routing, a multicast
    tree, NaN demand in pair 0 under padding legs, K = 1 across a month
    start, month starts inside K = 24 chunks, K past the window ring and the
    32-hour tile, endogenous CCI demand, ports of 76 and 165 legs (one and
    two of the kernel's 128-leg tiles; K = 24, 1 and 33), and the
    2048-pair cell's routing with its empty ports and a 105-leg port (K = 24
    and 5). Each launch form is forced after the warm-up; where the
    small-port form does not take the call (a port of more than 32 legs),
    forcing it raises."""
    name, pad, hpm, t_first, Ks, endo, nan_hours = ROUTED_CASES[case]
    sc, topo, r = _routed_scenario(name, pad, hpm)
    legs = np.bincount([m for path in r.paths for m in path], minlength=topo.n_ports)
    want = {"hot-port": 76, "hotter-port": 165, "main-cell": 105}
    if name in want:
        assert legs.max() == want[name]
    if name == "main-cell":
        assert legs.min() == 0
    demand = sc.demand.copy()
    demand[0, list(nan_hours)] = np.nan
    cci = demand * 1.5 if endo else None
    cblk = lambda a, b: None if cci is None else cci[:, a:b]
    rt = FleetRuntime(topo, routing=r, device=cuda_device)
    t = 0
    while t < t_first:
        k = min(24, t_first - t)
        rt.step_many(demand[:, t:t + k], cci_demand_block=cblk(t, t + k))
        t += k
    monkeypatch.setattr(ops, "_stream_chunk_routed_kernel",
                        functools.partial(stream_chunk_routed, form=form))
    for K in Ks:
        block, _, e = rt._pack(demand[:, t:t + K], cblk(t, t + K))
        dev_block = torch.from_numpy(block).to(cuda_device)
        args = rt._chunk_args(dev_block, K, e)
        Kt = args[5].shape[-1]                          # args[5]: the pairs' tier bounds
        if form == "small_port" and not small_port_fits(rt.arrays.routing.index,
                                                        rt.n_demand_rows, K, Kt, e):
            with pytest.raises(ValueError, match="form 'small_port'"):
                rt._launch(dev_block, K, e)
            return
        want, want_fsm = ref.stream_chunk_routed_ref(*args,
                                                     renew_in_chunks=rt.policy.renew_in_chunks)
        before = ops.LAUNCHES["stream_chunk_routed"]
        small_before = ops.LAUNCHES["stream_chunk_routed_small_port"]
        got = rt._launch(dev_block, K, e)
        assert ops.LAUNCHES["stream_chunk_routed_small_port"] == \
            small_before + (form == "small_port")
        assert ops.LAUNCHES["stream_chunk_routed"] == before + 1
        assert _same_bits(got, want), (case, t)
        assert _same_bits(rt._state.fsm, want_fsm), (case, t)
        rt._commit(got.cpu().numpy(), K)
        t += K
    if nan_hours:
        assert bool(torch.isnan(got[:8 * Ks[-1] * rt.n_rows]).any())


@pytest.mark.cuda
def test_topology_runtime_gpu_matches_cpu(cuda_device):
    """A 64-pair topology stream on the card (K = 24 chunks, a reroute at a
    chunk boundary, then a per-tick tail) against the CPU stream hour by
    hour with the same reroute, every field; one routed chunk launch a chunk
    and tick, and none of the fleet or planning kernels."""
    sc, topo, r = _routed_scenario("topology", 8, 730)
    moved = np.asarray(r.primary).copy()
    for i, pr in enumerate(topo.pairs[:6]):
        moved[i] = next((c for c in pr.candidates if c != moved[i]), moved[i])
    r1 = topo.plan(moved)
    ops.reset_launches()
    rt = FleetRuntime(topo, routing=r, device=cuda_device)
    outs = []
    for t in range(0, 192, 24):
        if t == 96:
            rt.reroute(r1)
        outs.append(rt.step_many(sc.demand[:, t:t + 24]))
    outs += [{k: v[:, None] for k, v in rt.step(sc.demand[:, t]).items()}
             for t in range(192, 200)]
    got = {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}
    assert ops.LAUNCHES["stream_chunk_routed"] == 8 + 8
    for name in ("stream_chunk", "leg_segment_sum", "tiered_cost_scan", "fsm_chunk"):
        assert ops.LAUNCHES[name] == 0, name
    cpu = FleetRuntime(topo, routing=r, device="cpu")
    touts = []
    for t in range(200):
        if t == 96:
            cpu.reroute(r1)
        touts.append(cpu.step(sc.demand[:, t]))
    want = {k: np.stack([o[k] for o in touts], 1) for k in touts[0]}
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert 0 < got["x"].sum() < got["x"].size


#: (D, T_cci) of the offline-DP batches: every edge branch of the reference
#: DP (D = 0 and 1, T_cci = 1) beside the scenarios' sizes.
DP_ROWS = tuple((D, Tc) for D in (0, 1, 2, 72) for Tc in (1, 2, 168))


def oracle_batch(case: str, T: int = 1200, seed: int = 0):
    """``(vpn, cci, D, T_cci)`` numpy rows for the offline DP.

    ``mixed``: DP_ROWS with regime-switching costs, so optima toggle;
    ``nan``: the same with NaN hours in VPN and in CCI, early and late;
    ``ties``: whole-dollar costs, CCI equal to VPN on every other row, so
    stay/request, stay/release and the start state tie; ``year``: 256 rows
    of the fleet scenario's D in [24, 96], T_cci in [72, 336] over T hours,
    with the DP_ROWS first."""
    rng = np.random.default_rng(seed)
    rows = list(DP_ROWS)
    if case == "year":
        rows += [(int(rng.integers(24, 97)), int(rng.integers(72, 337)))
                 for _ in range(256 - len(rows))]
    n = len(rows)
    vpn = rng.uniform(5.0, 50.0, size=(n, T))
    regime = np.repeat(rng.uniform(0.6, 1.4, size=(n, T // 40 + 1)), 40, axis=1)[:, :T]
    cci = vpn * regime
    if case == "nan":
        vpn[0::3, T // 3] = np.nan
        cci[1::3, T // 2] = np.nan
        cci[2::3, T - 1] = np.nan
        vpn[5, :3] = np.nan
    elif case == "ties":
        vpn = np.round(vpn)
        cci = np.round(cci)
        cci[1::2] = vpn[1::2]
    D = np.array([d for d, _ in rows], np.int32)
    Tc = np.array([tc for _, tc in rows], np.int32)
    return vpn, cci, D, Tc


def test_oracle_dp_wrapper_refuses_cpu_tensors_and_bad_operands():
    """The offline-DP wrapper launches on CUDA tensors or raises."""
    from repro_torch.kernels.oracle_dp import oracle_dp

    vpn, cci, D, Tc = (_t(a) for a in oracle_batch("mixed", T=8))
    with pytest.raises(ValueError, match="CUDA"):
        oracle_dp(vpn, cci, D, Tc)
    with pytest.raises(ValueError, match=r"\(N, T\)"):
        oracle_dp(vpn[0], cci, D, Tc)


@pytest.mark.cuda
@pytest.mark.parametrize("head_start", [True, False], ids=["head-start", "off-start"])
@pytest.mark.parametrize("case", ["mixed", "nan", "ties", "year"])
@pytest.mark.parametrize("form", ["register", "large"])
def test_oracle_dp_kernel_bit_equal_to_plain(cuda_device, form, case, head_start):
    """One ``oracle_dp`` launch, in the forced form, against the plain
    version on the CPU, every output bit (NaN in the same places), and
    against the numpy DP on the edge rows; ``ops.oracle_dp`` (the register
    form for these rows) too; the guards refuse impossible rows."""
    from repro_torch.core.costmodel import HourlyCosts
    from repro_torch.core.oracle import offline_optimal
    from repro_torch.core.pricing import CostParams
    from repro_torch.kernels.oracle_dp import oracle_dp

    vpn, cci, D, Tc = oracle_batch(case, T=8760 if case == "year" else 1200)
    dev = [_t(a, cuda_device) for a in (vpn, cci, D, Tc)]
    before = ops.LAUNCHES["oracle_dp"]
    total, start_on = oracle_dp(*dev, allow_head_start=head_start, form=form)
    assert ops.LAUNCHES["oracle_dp"] == before + 1
    want_total, want_on = ref.oracle_dp_ref(*(_t(a) for a in (vpn, cci, D, Tc)),
                                            allow_head_start=head_start)
    assert _same_bits(total.cpu(), want_total)
    assert torch.equal(start_on.cpu(), want_on)
    auto_total, auto_on = ops.oracle_dp(*dev, allow_head_start=head_start)
    assert ops.LAUNCHES["oracle_dp"] == before + 2
    assert _same_bits(auto_total.cpu(), want_total) and torch.equal(auto_on.cpu(), want_on)
    T = vpn.shape[1]
    for i in (0, 4, 9):
        p = CostParams(1.0, 0.1, 0.02, 0.1, flat_rate(0.1), D=int(D[i]), T_cci=int(Tc[i]))
        z = np.zeros(T)
        r = offline_optimal(p, costs=HourlyCosts(z, vpn[i], z, cci[i]),
                            allow_head_start=head_start)
        want = torch.tensor([r.total_cost], dtype=torch.float64)
        assert _same_bits(total[i:i + 1].cpu(), want)
        assert bool(start_on[i]) == r.start_on
    if case == "mixed":
        bad = _t(D, cuda_device)
        bad[3] = -1
        with pytest.raises(ValueError, match="D >= 0"):
            oracle_dp(dev[0], dev[1], bad, dev[3], form=form)
        huge = _t(Tc, cuda_device)
        huge[0] = 20000
        with pytest.raises(ValueError, match="states|register form"):
            oracle_dp(dev[0], dev[1], dev[2], huge, form=form)
        with pytest.raises(ValueError, match="states"):
            ops.oracle_dp(dev[0], dev[1], dev[2], huge)


def oracle_layout_batch(case: str, seed: int = 3):
    """``(vpn, cci, D, T_cci)`` numpy batches the register form's layout
    makes risky. ``shuffled``: 39 rows (not a multiple of a block's four)
    over every instance from (0, 0) to (12, 3), the DP's edge rows among
    them, in a shuffled order, over 1000 hours (not a multiple of the 64-hour
    tile); ``one``: a single row; ``T0``, ``T1``, ``T65``: horizons of 0, 1
    and a tile and an hour; ``limit``: rows at the largest instance (T_cci
    384 with D 97; T_cci 385 with D 0) beside small ones; ``past``: the same
    with rows one hour past it (T_cci 385 with D 1, D 98), which take the
    large-row form in the same call."""
    rng = np.random.default_rng(seed)
    if case == "shuffled":
        rows = list(DP_ROWS) + [(97, 384), (0, 385), (66, 353), (65, 352), (34, 33),
                                (33, 32), (2, 64), (3, 65), (50, 200), (24, 72)]
        rows += [(int(rng.integers(0, 98)), int(rng.integers(1, 385))) for _ in range(39 - len(rows))]
        rows = [rows[i] for i in rng.permutation(len(rows))]
        T = 1000
    elif case == "one":
        rows, T = [(48, 168)], 777
    elif case in ("T0", "T1", "T65"):
        rows, T = list(DP_ROWS) + [(97, 384)], {"T0": 0, "T1": 1, "T65": 65}[case]
    elif case == "limit":
        rows, T = [(97, 384), (0, 385), (2, 1), (0, 1), (1, 1)], 900
    else:
        rows, T = [(97, 384), (1, 385), (98, 384), (0, 385), (98, 1), (2, 3)], 900
    n = len(rows)
    vpn = rng.uniform(5.0, 50.0, size=(n, T))
    cci = vpn * np.repeat(rng.uniform(0.6, 1.4, size=(n, T // 40 + 1)), 40, axis=1)[:, :T]
    if n > 1 and T > 10:
        vpn[1, T // 2] = np.nan
    D = np.array([d for d, _ in rows], np.int32)
    Tc = np.array([tc for _, tc in rows], np.int32)
    return vpn, cci, D, Tc


@pytest.mark.cuda
@pytest.mark.parametrize("head_start", [True, False], ids=["head-start", "off-start"])
@pytest.mark.parametrize("case", ["shuffled", "one", "T0", "T1", "T65", "limit", "past"])
def test_oracle_dp_forms_on_layout_edges(cuda_device, case, head_start):
    """Both forms against the plain version on the CPU, every bit, on the
    batches the register form's layout makes risky (rows of every instance
    shuffled, N not a multiple of four, N = 1, horizons of 0, 1 and past a
    tile, the largest instance); rows past it take the large-row form in
    the same call (two launches), and forcing the register form on them
    raises."""
    from repro_torch.kernels.oracle_dp import launch_plan, oracle_dp

    vpn, cci, D, Tc = oracle_layout_batch(case)
    dev = [_t(a, cuda_device) for a in (vpn, cci, D, Tc)]
    want = ref.oracle_dp_ref(*(_t(a) for a in (vpn, cci, D, Tc)), allow_head_start=head_start)
    n_large = int(launch_plan(dev[2], dev[3]).large.sum())
    assert (n_large > 0) == (case == "past")
    for form in ("auto", "large") + (("register",) if case != "past" else ()):
        before = ops.LAUNCHES["oracle_dp"]
        total, start_on = oracle_dp(*dev, allow_head_start=head_start, form=form)
        torch.cuda.synchronize()
        mixed = form == "auto" and n_large > 0
        assert ops.LAUNCHES["oracle_dp"] == before + (2 if mixed else 1), form
        assert _same_bits(total.cpu(), want[0]), form
        assert torch.equal(start_on.cpu(), want[1]), form
    if case == "past":
        with pytest.raises(ValueError, match="register form"):
            oracle_dp(*dev, form="register")


# -- the forecast slice: forecaster_scan and the gated fsm_scan -----------------

from repro_torch.kernels.forecaster import FAST_STATE, forecaster_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402


def _forecaster_inputs(seed, n, T, S, h0, device=CPU):
    """Seeded float32 operands: log1p-like inputs with one NaN hour in row 0
    (when T > 5), sigmoid'd timescales, readout weights and bias, and a zero
    or seeded h0."""
    rng = np.random.default_rng(seed)
    u = rng.normal(0.6, 0.5, (n, T)).astype(np.float32)
    if T > 5:
        u[0, 5] = np.nan
    a = torch.sigmoid(torch.from_numpy(rng.normal(1.0, 2.0, S).astype(np.float32)))
    w = rng.normal(0, 0.1, S).astype(np.float32)
    b = np.float32(rng.normal(0, 0.02))
    h = (np.zeros((n, S), np.float32) if h0 == "zero"
         else rng.normal(0.4, 0.3, (n, S)).astype(np.float32))
    return (_t(u, device), a.to(device), (1.0 - a).to(device), _t(w, device),
            torch.tensor(b, device=device), _t(h, device))


def _gate_inputs(seed, n, T, margin, device=CPU):
    """FSM inputs plus the gate's operands: predictions in 50-hour regimes
    and cost coefficients whose predicted cost ratio runs about 0.7-1.4, so
    that it straddles the gates (rows 3, 14, ... with slopes of 0), row 1's
    predictions -1 at hour T // 5, below -1 at T // 4 and NaN from T // 3,
    and per-row margins: ``gate = (pred, coef, margin)``."""
    vpn, cci, tog = _fsm_inputs(seed, n, T)
    rng = np.random.default_rng(seed + 1)
    pred = (100.0 * np.repeat(rng.uniform(0.3, 3.0, (n, T // 50 + 1)), 50, axis=1)[:, :T]
            * rng.uniform(0.9, 1.1, (n, T)))
    if n > 1:
        pred[1, T // 5] = -1.0
        pred[1, T // 4] = -1.5
        pred[1, T // 3:] = np.nan
    a_v, b_v, d = rng.uniform(-3.0, -1.0, n), rng.uniform(0.6, 1.0, n), rng.uniform(-0.15, 0.15, n)
    coef = np.stack([a_v, b_v, a_v + np.log(rng.uniform(0.85, 1.15, n)) - 4.6 * d, b_v + d], 1)
    coef[3::11, 1::2] = 0.0
    m = np.full(n, margin) if margin != "mixed" else np.resize([0.0, 0.05, 0.15, 1e30], n)
    tp = ToggleParams(**{k: _t(v, device) for k, v in tog.items()})
    gate = tuple(_t(a, device) for a in (pred, coef, np.asarray(m, np.float64)))
    return _t(vpn, device), _t(cci, device), tp, gate


def _card_planes(gate):
    """The predicted mode costs torch's ops form from a gate (pred, coef,
    margin) on its device, brought to the CPU with the margins: the plain
    gating the card's kernel is held to bit for bit."""
    pred, coef, m = gate
    return tuple(x.cpu() for x in tpol.predicted_mode_costs(pred, coef, torch.float64) + (m,))


def test_forecast_kernel_wrappers_refuse_cpu_tensors_and_bad_operands():
    """Both new launches take CUDA tensors or raise before anything is
    built: CPU operands (at any state size: past the compile-time instances
    too, where the dispatcher's plain version gives the CPU's result), no
    state, float64 inputs, a gate of the wrong shape."""
    args = _forecaster_inputs(0, 3, 10, 8, "seeded")
    with pytest.raises(ValueError, match="CUDA"):
        forecaster_scan(*args)
    past = list(_forecaster_inputs(0, 3, 10, FAST_STATE + 1, "zero"))
    with pytest.raises(ValueError, match="CUDA"):
        forecaster_scan(*past)
    got, want = ops.forecaster_scan(*past), ref.forecaster_scan_ref(*past)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    with pytest.raises(ValueError, match="S >= 1"):
        forecaster_scan(past[0], *(x[:0] for x in past[1:4]), past[4])
    with pytest.raises(ValueError, match="float32"):
        forecaster_scan(args[0].double(), *args[1:])
    vpn, cci, tp, gate = _gate_inputs(0, 3, 40, 0.05)
    one = torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fsm_scan(vpn, cci, *tp, one, one, gate=gate)
    with pytest.raises(ValueError, match="pred"):
        fsm_scan(vpn, cci, *tp, one, one, gate=(gate[0][:, :7], gate[1], gate[2]))
    with pytest.raises(ValueError, match="coef"):
        fsm_scan(vpn, cci, *tp, one, one, gate=(gate[0], gate[1][:, :3], gate[2]))
    with pytest.raises(ValueError, match="coef"):
        fsm_scan(vpn, cci, *tp, one, one, gate=(gate[0], gate[1].float(), gate[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("h0", ["zero", "seeded"])
@pytest.mark.parametrize("S", [1, 3, 8, 16, 17, 33, 100])
@pytest.mark.parametrize("shape", [(1, 1), (17, 63), (300, 700), (33, 129)],
                         ids=lambda s: "x".join(map(str, s)))
def test_forecaster_kernel_bit_equal_to_plain(cuda_device, shape, S, h0):
    """Every bit of y and h against the plain version on the CPU, with and
    without the readout, h0 given and not, a NaN hour in row 0."""
    n, T = shape
    cpu = _forecaster_inputs(n * T + S, n, T, S, h0)
    dev = [a.to(cuda_device) for a in cpu]
    for write_y in (True, False):
        for given in (True, False):
            h_in = dev[5] if given else None
            before = ops.LAUNCHES["forecaster_scan"]
            y, h = ops.forecaster_scan(*dev[:5], h_in, write_y=write_y)
            assert ops.LAUNCHES["forecaster_scan"] == before + 1
            wy, wh = ref.forecaster_scan_ref(*cpu[:5], cpu[5] if given else None,
                                             write_y=write_y)
            assert _same_bits(h.cpu(), wh), (write_y, given)
            if write_y:
                assert _same_bits(y.cpu(), wy), given
            else:
                assert y is None


@pytest.mark.cuda
def test_forecaster_entry_points_on_the_card_match_the_cpu(cuda_device):
    """predict, apply and step on the card: apply on the same inputs equals
    the CPU's bit for bit, and T steps equal apply bit for bit; the card's
    log1p and expm1 may differ from the CPU's in the last place (and the
    EMA carries such a difference on), so predictions agree to rtol=1e-5,
    atol=1e-6 GB/hr."""
    rng = np.random.default_rng(4)
    series = rng.uniform(0, 100, (40, 500))
    scale = np.maximum(series.mean(axis=1), 1e-9)
    params = tssm.demand_forecaster_init(None, 8, device=cuda_device)
    params["w"] = _t(rng.normal(0, 0.1, 8).astype(np.float32), cuda_device)
    params["bias"] = torch.tensor(np.float32(0.01), device=cuda_device)
    got = tssm.demand_forecaster_predict(params, series, scale)
    assert got.is_cuda and got.dtype == torch.float64
    cpu_params = {k: v.cpu() for k, v in params.items()}
    want = tssm.demand_forecaster_predict(cpu_params, series, scale, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    u = torch.log1p(_t(series / scale[:, None]).float())
    y = tssm.demand_forecaster_apply(params, u.to(cuda_device))
    assert torch.equal(y.cpu(), tssm.demand_forecaster_apply(cpu_params, u))
    u = u.to(cuda_device)
    h = torch.zeros((40, 8), dtype=torch.float32, device=cuda_device)
    for t in range(20):
        h, y_t = tssm.demand_forecaster_step(params, h, u[:, t])
        assert torch.equal(y_t, y[:, t])


@pytest.mark.cuda
@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("margin", [0.0, 0.05, 1e30, "mixed"])
def test_gated_fsm_kernel_bit_equal_to_cpu_plain(cuda_device, margin, renew):
    """The gated instance on the prediction and the cost coefficients: x,
    state and total_cost every bit equal to the plain gating on the CPU of
    the predicted costs torch's ops form on the card (row 1's predictions
    -1, below -1 and NaN), counted in fsm_scan_gated; at margin 1e30 it
    decides as the reactive instance on every row but row 1 (whose costs of
    0 and NaN veto every realized trigger)."""
    vpn, cci, tp, gate = _gate_inputs(21, 40, 2000, margin)
    one = torch.ones(40, dtype=torch.int32)
    dev = lambda a: a.to(cuda_device)
    dgate = tuple(dev(g) for g in gate)
    before = dict(ops.LAUNCHES)
    got = ops.fsm_scan(dev(vpn), dev(cci), *tp.to(cuda_device), dev(one), dev(one),
                       renew_in_chunks=renew, gate=dgate)
    assert ops.LAUNCHES["fsm_scan_gated"] == before["fsm_scan_gated"] + 1
    assert ops.LAUNCHES["fsm_scan"] == before["fsm_scan"]
    want = ref.fsm_scan_planes_ref(vpn, cci, *tp, one, one, renew_in_chunks=renew,
                                   planes=_card_planes(dgate))
    assert 0 < int(want["x"].sum()) < want["x"].numel()
    for k in ("x", "state", "total_cost"):
        assert torch.equal(got[k].cpu(), want[k]), k
    if margin == 1e30:
        reactive = ops.fsm_scan(dev(vpn), dev(cci), *tp.to(cuda_device), dev(one), dev(one),
                                renew_in_chunks=renew)
        finite = torch.arange(40, device=cuda_device) != 1
        for k in ("x", "state", "total_cost"):
            assert torch.equal(got[k][finite], reactive[k][finite]), k
        assert not torch.equal(got["x"][1], reactive["x"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FSM_EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gated_fsm_kernel_edge_shapes_bit_equal_to_cpu_plain(cuda_device, shape):
    """Ragged N and T, windows from 1 hour to past T, misaligned planes, the
    prediction misaligned too: every output bit equal to the plain gating on
    the CPU of the card's predicted costs."""
    n, T = shape
    args = _fsm_edge_args(n, T, cuda_device, 1)
    _, _, _, gate = _gate_inputs(n + T, n, T, "mixed")
    buf = torch.zeros(n * T + 1, dtype=torch.float64, device=cuda_device)
    pred = buf[1:].view(n, T)
    pred.copy_(gate[0])
    dgate = (pred, gate[1].to(cuda_device), gate[2].to(cuda_device))
    assert dgate[0].data_ptr() % 16 == 8
    planes = _card_planes(dgate)
    for renew in (False, True):
        got = ops.fsm_scan(*args, renew_in_chunks=renew, gate=dgate)
        want = ref.fsm_scan_planes_ref(*(a.cpu() for a in args), renew_in_chunks=renew,
                                       planes=planes)
        for k in ("x", "state", "total_cost"):
            assert torch.equal(got[k].cpu(), want[k]), (k, renew)


def _gate_stress(seed, n, T, device=CPU):
    """Gate operands whose predictions sit near the thresholds: each row's
    cost ratio crosses its four thresholds at lp = 2 to 22 and each hour
    takes one crossing, moved by a factor 1 +- 10^u, u in [-16, -3]; rows 3,
    14, ... have a margin of 1e30. Returns (pred, coef, margin, theta1,
    theta2)."""
    rng = np.random.default_rng(seed)
    a_v, b_v = rng.uniform(-3.0, -1.0, n), rng.uniform(0.6, 1.0, n)
    d = rng.choice([-1.0, 1.0], n) * rng.uniform(0.05, 0.3, n)
    th1, th2 = rng.uniform(0.85, 0.95, n), rng.uniform(1.05, 1.2, n)
    m = rng.choice([0.0, 0.05, 0.15], n)
    m[3::11] = 1e30
    c0 = np.log(th1) - d * rng.uniform(8.0, 12.0, n)
    t = np.stack([th1 - m, th1 + m, th2 + m, th2 - m], 1)
    lt = np.log(np.maximum(np.take_along_axis(t, rng.integers(0, 4, (n, T)), 1), 1e-300))
    with np.errstate(over="ignore"):
        pred = np.expm1((lt - c0[:, None]) / d[:, None]) * (
            1 + rng.choice([-1.0, 1.0], (n, T)) * 10.0 ** rng.uniform(-16, -3, (n, T)))
    pred[3::11] = rng.uniform(0, 500, (len(pred[3::11]), T))
    return tuple(_t(a, device) for a in (pred, np.stack([a_v, b_v, a_v + c0, b_v + d], 1), m,
                                          th1, th2))


def test_gate_masks_wrapper_refuses_cpu_tensors_and_bad_operands():
    """The gate stage's check launch takes CUDA tensors or raises before
    anything is built; a coefficient table of another shape names coef."""
    args = _gate_stress(0, 3, 40)
    with pytest.raises(ValueError, match="CUDA"):
        gate_masks(*args)
    with pytest.raises(ValueError, match="coef"):
        gate_masks(args[0], args[1][:, :3], *args[2:])
    with pytest.raises(ValueError, match="pred"):
        gate_masks(args[0].float(), *args[1:])
    assert ref.gate_masks_ref(*tpol.predicted_mode_costs(args[0], args[1], torch.float64),
                              *args[2:]).shape == (3, 1, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("screen", [True, False], ids=["screen", "exact"])
@pytest.mark.parametrize("shape", [(1, 1), (17, 63), (33, 700), (300, 129), (2048, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gate_masks_near_thresholds_equal_the_card_costs_bits(cuda_device, shape, screen):
    """The gated fsm_scan's gate stage (``gate_masks``) on predictions that
    sit near the thresholds: every mask bit equals the compares of the
    predicted costs torch's ops form on the card (``ref.gate_masks_ref``),
    with the float32 screen deciding what it can and without it."""
    n, T = shape
    args = _gate_stress(n * 7 + T, n, T, cuda_device)
    planes = tpol.predicted_mode_costs(args[0], args[1], torch.float64)
    want = ref.gate_masks_ref(*(x.cpu() for x in planes + args[2:]))
    got = gate_masks(*args, screen=screen)
    assert got.shape == want.shape and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_forecast_plan_gpu_matches_cpu(cuda_device):
    """plan_fleet with a forecast-gated policy (predictions from the
    forecaster's init, in-scan cost fit): one forecaster_scan per forecast,
    one gated fsm_scan per plan; decisions equal the CPU's, costs rtol 1e-9."""
    sc = build_fleet_scenario(16, horizon=2000, seed=0)
    scale = np.maximum(sc.demand.mean(axis=1), 1e-9)
    plans = {}
    for dev in (cuda_device, CPU):
        ops.reset_launches()
        params = tssm.demand_forecaster_init(None, 8, device=dev)
        pred = tssm.demand_forecaster_predict(params, sc.demand, scale, device=dev)
        arrays = sc.fleet.stack(torch.float64, dev)
        pol = tpol.forecast_gated_policy(arrays.toggle, pred, margin=0.05)
        plans[dev.type] = plan_fleet(arrays, sc.demand, policy=pol, device=dev)
        want = 1 if dev.type == "cuda" else 0
        assert ops.LAUNCHES["forecaster_scan"] == want
        assert ops.LAUNCHES["fsm_scan_gated"] == want and ops.LAUNCHES["fsm_scan"] == 0
    got, want = plans["cuda"], plans["cpu"]
    for k in ("x", "state"):
        assert torch.equal(got[k].cpu(), want[k]), k
    torch.testing.assert_close(got["toggle_cost"].cpu(), want["toggle_cost"], rtol=1e-9,
                               atol=0)


# -- training the forecaster: forecaster_scan_bwd -----------------------------------

from repro_torch.kernels.forecaster import checkpoint_shape, forecaster_scan_bwd  # noqa: E402


def _bwd_inputs(seed, n, T, S, dy_kind, device=CPU):
    """The forward's operands (:func:`_forecaster_inputs`, seeded h0) and a
    ``dy``: zeros, or seeded with the mask's zeros past hour ``T - 5``."""
    u, a, oma, w, _, h = _forecaster_inputs(seed, n, T, S, "seeded", device)
    rng = np.random.default_rng(seed + 7)
    if dy_kind == "zero":
        dy = np.zeros((n, T), np.float32)
    else:
        dy = rng.normal(0, 1e-3, (n, T)).astype(np.float32)
        dy[:, max(T - 5, 0):] = 0.0
    return u, _t(dy, device), a, oma, w, h


def test_forecaster_bwd_wrapper_refuses_cpu_tensors_and_bad_operands():
    """The backward launch takes CUDA tensors or raises before anything is
    built: CPU operands (at any state size: past the compile-time instances
    too, where the dispatcher's plain version gives the CPU's result), float64
    inputs, a dy of another shape."""
    u, dy, a, oma, w, h = _bwd_inputs(0, 3, 10, 8, "seeded")
    with pytest.raises(ValueError, match="CUDA"):
        forecaster_scan_bwd(u, dy, a, oma, w, h)
    big = _bwd_inputs(0, 3, 10, FAST_STATE + 1, "zero")
    with pytest.raises(ValueError, match="CUDA"):
        forecaster_scan_bwd(*big)
    got, want = ops.forecaster_scan_bwd(*big), ref.forecaster_scan_bwd_ref(*big)
    assert all(_same_bits(g, w_) for g, w_ in zip(got, want))
    with pytest.raises(ValueError, match="float32"):
        forecaster_scan_bwd(u.double(), dy, a, oma, w)
    with pytest.raises(ValueError, match="one shape"):
        forecaster_scan_bwd(u, dy[:, :7], a, oma, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dy_kind", ["zero", "seeded"])
@pytest.mark.parametrize("S", [1, 3, 8, 16, 17, 33, 100])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (17, 63), (17, 65), (300, 129), (33, 700)],
                         ids=lambda s: "x".join(map(str, s)))
def test_forecaster_bwd_kernel_bit_equal_to_plain(cuda_device, shape, S, dy_kind):
    """Every bit of the four gradients against the plain version on the CPU,
    h0 given and not, the checkpoints formed by the call or handed over by
    the forward kernel, a NaN hour in row 0 (so every gradient the row feeds
    is NaN), one launch a call."""
    n, T = shape
    cpu = _bwd_inputs(n * T + S, n, T, S, dy_kind)
    dev = [x.to(cuda_device) for x in cpu]
    for given in (True, False):
        h_dev, h_cpu = (dev[5], cpu[5]) if given else (None, None)
        want = ref.forecaster_scan_bwd_ref(*cpu[:5], h_cpu)
        for from_fwd in (False, True):
            kw = {}
            if from_fwd:
                ckpt = ops.forecaster_checkpoints(dev[0], S)
                ops.forecaster_scan(dev[0], *dev[2:5], torch.zeros((), device=cuda_device),
                                    h_dev, ckpt=ckpt)
                kw = dict(ckpt=ckpt)
            before = ops.LAUNCHES["forecaster_scan_bwd"]
            got = ops.forecaster_scan_bwd(*dev[:5], None if from_fwd else h_dev, **kw)
            assert ops.LAUNCHES["forecaster_scan_bwd"] == before + 1
            for g, wv, name in zip(got, want, ("da", "d_one_minus_a", "dw", "dbias")):
                assert g.is_cuda and _same_bits(g.cpu(), wv), (name, given, from_fwd)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 3, 8, 16, 17, 33, 100])
@pytest.mark.parametrize("shape", [(1, 1), (17, 63), (17, 64), (300, 700), (33, 129)],
                         ids=lambda s: "x".join(map(str, s)))
def test_forecaster_checkpoints_bit_equal_to_plain(cuda_device, shape, S):
    """The forward's checkpoint output equals the plain scan's (the states it
    walks) in every bit, NaN in the same places, with and without the
    readout, h0 given and not; ``y`` and ``h`` equal the store-free call's."""
    n, T = shape
    cpu = _forecaster_inputs(n * T + S, n, T, S, "seeded")
    dev = [a.to(cuda_device) for a in cpu]
    for write_y in (True, False):
        for given in (True, False):
            h_dev, h_cpu = (dev[5], cpu[5]) if given else (None, None)
            ckpt = torch.full(checkpoint_shape(n, T, S), float("inf"), device=cuda_device)
            y, h = ops.forecaster_scan(*dev[:5], h_dev, write_y=write_y, ckpt=ckpt)
            y0, h0 = ops.forecaster_scan(*dev[:5], h_dev, write_y=write_y)
            want = torch.empty(checkpoint_shape(n, T, S))
            wy, wh = ref.forecaster_scan_ref(*cpu[:5], h_cpu, write_y=write_y, ckpt=want)
            assert _same_bits(ckpt.cpu(), want), (write_y, given)
            assert _same_bits(h, h0) and _same_bits(h.cpu(), wh), (write_y, given)
            if write_y:
                assert _same_bits(y, y0) and _same_bits(y.cpu(), wy), given


@pytest.mark.cuda
def test_forecaster_wrappers_refuse_bad_checkpoints(cuda_device):
    """A checkpoint tensor of the wrong shape, dtype or device, or not
    contiguous, is refused by the forward and the backward launch; the
    backward takes checkpoints or h0, not both."""
    u, dy, a, oma, w, h = (x.to(cuda_device) for x in _bwd_inputs(0, 5, 130, 8, "seeded"))
    bias = torch.zeros((), device=cuda_device)
    good = torch.empty(checkpoint_shape(5, 130, 8), device=cuda_device)
    bad = (torch.empty((2, 5, 8), device=cuda_device),
           good.double(), good.cpu(), torch.empty((3, 8, 5), device=cuda_device).transpose(1, 2))
    for ck in bad:
        with pytest.raises(ValueError, match="ckpt"):
            forecaster_scan(u, a, oma, w, bias, ckpt=ck)
        with pytest.raises(ValueError, match="ckpt"):
            forecaster_scan_bwd(u, dy, a, oma, w, ckpt=ck)
    forecaster_scan(u, a, oma, w, bias, h, ckpt=good)
    with pytest.raises(ValueError, match="not both"):
        forecaster_scan_bwd(u, dy, a, oma, w, h, ckpt=good)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 32])
def test_forecaster_training_on_the_card_matches_the_cpu(cuda_device, S):
    """train_demand_forecaster on the card: one forecaster_scan and one
    forecaster_scan_bwd launch a step, and every parameter bit and every
    step's loss equal to the CPU port's on the same series (the inputs are
    formed on the host, every reduction walks a fixed order and every square
    root is rounded once); S = 32 through the kernels' run-time instances."""
    rng = np.random.default_rng(5)
    t = np.arange(300)
    series = np.concatenate([
        50 * (1 + 0.5 * np.sin(2 * np.pi * t / 168)) + rng.normal(0, 4, (20, t.size)),
        30 * (1 + t / 300) + rng.normal(0, 3, (12, t.size)),
    ]).clip(min=0.0)
    steps = 12
    ops.reset_launches()
    card_losses, cpu_losses = [], []
    got, scale = tssm.train_demand_forecaster(series, 48, state_dim=S, steps=steps,
                                              device=cuda_device, losses=card_losses)
    assert ops.LAUNCHES["forecaster_scan"] == steps
    assert ops.LAUNCHES["forecaster_scan_bwd"] == steps
    want, cpu_scale = tssm.train_demand_forecaster(series, 48, state_dim=S, steps=steps,
                                                   device="cpu", losses=cpu_losses)
    assert np.array_equal(scale, cpu_scale)
    for k in want:
        assert got[k].is_cuda and _same_bits(got[k].cpu(), want[k]), k
    np.testing.assert_allclose([float(x) for x in card_losses],
                               [float(x) for x in cpu_losses], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 17, 32, 100])
def test_adamw_update_on_the_card_equals_the_cpu(cuda_device, n):
    """Five AdamW steps of a leaf of n values (and a scalar leaf) from seeded
    gradients, clipped and not: every parameter and moment bit on the card
    equals the CPU's (the square roots are rounded once on both)."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    rng = np.random.default_rng(n)
    for clip in (1.0, 0.0):
        cfg = AdamWConfig(lr=2e-2, weight_decay=0.1, clip_norm=clip)
        p = {"x": torch.tensor(rng.normal(0, 1, n), dtype=torch.float32),
             "b": torch.tensor(rng.normal(), dtype=torch.float32)}
        sides = {"cpu": (p, adamw_init(p, cfg))}
        pc = {k: v.to(cuda_device) for k, v in p.items()}
        sides["card"] = (pc, adamw_init(pc, cfg))
        for _ in range(5):
            g = {k: rng.normal(0, 1e-2, np.shape(v)).astype(np.float32) for k, v in p.items()}
            for side, (prm, st) in list(sides.items()):
                gt = {k: torch.tensor(v, device=prm[k].device) for k, v in g.items()}
                prm, st, _ = adamw_update(prm, gt, st, cfg)
                sides[side] = (prm, st)
            (pa, sa), (pb, sb) = sides["cpu"], sides["card"]
            for k in pa:
                assert _same_bits(pb[k].cpu(), pa[k]), (k, clip)
                assert _same_bits(sb["m"][k].cpu(), sa["m"][k]) and _same_bits(
                    sb["v"][k].cpu(), sa["v"][k]), (k, clip)


# -- the forecast stream: the gated stream_chunk and stream_chunk_routed ---------

MARGIN_KINDS = (0.0, 0.05, "rows", 1e30)


def _gated_policy(toggle, rows, T_pred, margin, renew, seed):
    """A forecast-gated policy on ``rows`` decision rows with seeded
    regime-switching predictions over ``T_pred`` hours (rows 3 and 10 NaN
    from hour 700, when they exist) and coefficients whose predicted CCI/VPN
    cost ratio straddles the gates; ``margin`` one of MARGIN_KINDS ("rows":
    0, 0.05, 0.15 and 1e30 by row)."""
    rng = np.random.default_rng(seed)
    pred = np.repeat(rng.uniform(0.0, 3000.0, (rows, T_pred // 24 + 1)), 24, axis=1)[:, :T_pred]
    pred = pred * rng.uniform(0.8, 1.2, (rows, T_pred))
    for r in (3, 10):
        if r < rows:
            pred[r, min(700, T_pred - 1):] = np.nan
    a_v = np.log(rng.uniform(5.0, 50.0, rows))
    b_v = rng.uniform(0.1, 0.5, rows)
    coef = np.stack([a_v, b_v, a_v + rng.normal(0, 0.2, rows), b_v + rng.normal(0, 0.05, rows)], 1)
    m = np.resize([0.0, 0.05, 0.15, 1e30], rows) if margin == "rows" else margin
    return tpol.forecast_gated_policy(toggle, pred, margin=m, cost_coef=coef, renew_in_chunks=renew)


def _tier_tables(Kt, rows, seed, device):
    """(rows, Kt) tier tables: increasing bounds with PAD_BOUND last,
    decreasing rates."""
    rng = np.random.default_rng(seed)
    bounds = np.cumsum(rng.uniform(100.0, 3000.0, (rows, Kt)), axis=1)
    bounds[:, -1] = 1e30
    rates = -np.sort(-rng.uniform(0.02, 0.2, (rows, Kt)), axis=1)
    return _t(bounds, device), _t(rates, device)


def _gated_fleet_configs(K):
    """Four (Kt, endogenous, renew, margin, T_pred) settings a K: Kt cycles
    through 1-8 with K, every margin kind and both flags appear, and T_pred
    falls at 722, 726, 730 or 734, inside the chunks the test steps."""
    return [(1 + (K + j) % 8, j % 2 == 1, j >= 2, MARGIN_KINDS[j], 722 + 4 * j)
            for j in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", list(range(1, 31)) + [168])
def test_stream_chunk_gated_matches_plain(cuda_device, K):
    """The gated stream_chunk, forced through both launch forms (the tick
    form where it has an instance, K <= 5), against stream_chunk_ref with
    the same gate on the same blocks of a stream's own state, every output
    bit: 64 links with tier tables of 1-8 tiers, endogenous CCI demand on
    and off, renew_in_chunks on and off, margins of 0, 0.05, per-row values
    and 1e30, NaN predictions in two links and hours past T_pred, across
    the month start at hour 730; each gated launch counts under
    stream_chunk_gated alone."""
    sc = build_fleet_scenario(64, horizon=1200, seed=0)
    for Kt, endo, renew, margin, T_pred in _gated_fleet_configs(K):
        arrays = sc.fleet.stack(torch.float64, cuda_device)
        b, r = _tier_tables(Kt, 64, K + Kt, cuda_device)
        arrays = arrays._replace(tier_bounds=b, tier_rates=r)
        pol = _gated_policy(arrays.toggle, 64, T_pred, margin, renew, 31 * K + Kt)
        rt = FleetRuntime(arrays, policy=pol, device=cuda_device)
        cci = sc.demand * 1.5 if endo else None
        cblk = lambda a, b_: None if cci is None else cci[:, a:b_]
        for t in range(0, 720, 24):
            rt.step_many(sc.demand[:, t:t + 24], cci_demand_block=cblk(t, t + 24))
        t, end = 720, 720 + max(16, K)
        forms = ("tick", "chunk") if K <= TICK_MAX_K else ("chunk",)
        while t < end:
            block, _, e = rt._pack(sc.demand[:, t:t + K], cblk(t, t + K))
            args = rt._chunk_args(torch.from_numpy(block).to(cuda_device), K, e)
            want, want_fsm = ref.stream_chunk_ref(*args, renew_in_chunks=renew, gate=rt._gate)
            for form in forms:
                before = dict(ops.LAUNCHES)
                got, got_fsm = _stream_chunk_launch(form, *args, renew_in_chunks=renew,
                                                    gate=rt._gate)
                assert ops.LAUNCHES["stream_chunk_gated"] == before["stream_chunk_gated"] + 1
                assert ops.LAUNCHES["stream_chunk"] == before["stream_chunk"]
                assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm), \
                    (K, form, t, Kt, endo, renew, margin)
            rt._launch(args[0], K, e)
            rt._commit(want.cpu().numpy(), K)
            t += K


@pytest.mark.cuda
def test_stream_chunk_gated_margin_1e30_is_the_reactive_instance(cuda_device):
    """With margin 1e30 and finite predictions the gated instances decide as
    the reactive ones, every output bit, in both forms and in the routed
    chunk."""
    sc = build_fleet_scenario(64, horizon=1200, seed=0)
    arrays = sc.fleet.stack(torch.float64, cuda_device)
    pol = _gated_policy(arrays.toggle, 64, 1200, 1e30, False, 5)
    pol = pol._replace(pred_demand=torch.nan_to_num(pol.pred_demand, nan=1.0))
    rt = FleetRuntime(arrays, policy=pol, device=cuda_device)
    for t in range(0, 720, 24):
        rt.step_many(sc.demand[:, t:t + 24])
    for K, form in ((1, "tick"), (5, "tick"), (24, "chunk"), (168, "chunk")):
        block, _, e = rt._pack(sc.demand[:, 720:720 + K], None)
        args = rt._chunk_args(torch.from_numpy(block).to(cuda_device), K, e)
        got = _stream_chunk_launch(form, *args, gate=rt._gate)
        want = _stream_chunk_launch(form, *args)
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1]), (K, form)
    rsc, topo, r = _routed_scenario("topology", 4, 730)
    rpol = _gated_policy(topo.stack(r, torch.float64, cuda_device).toggle, topo.n_ports, 200,
                         1e30, False, 6)
    rpol = rpol._replace(pred_demand=torch.nan_to_num(rpol.pred_demand, nan=1.0))
    rrt = FleetRuntime(topo, routing=r, policy=rpol, device=cuda_device)
    rrt.step_many(rsc.demand[:, :48])
    block, _, e = rrt._pack(rsc.demand[:, 48:72], None)
    args = rrt._chunk_args(torch.from_numpy(block).to(cuda_device), 24, e)
    got, want = stream_chunk_routed(*args, gate=rrt._gate), stream_chunk_routed(*args)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


GATED_ROUTED_CASES = {  # scenario, pad, month, first hour, Ks, endogenous, NaN pair hours,
    #                     margin, renew, T_pred
    "relay-padded-k24": ("relay", 3, 730, 48, [24] * 3, False, (), 0.05, False, 100),
    "multicast-rows-renew": ("multicast", 0, 730, 24, [24] * 3, False, (), "rows", True, 60),
    "nan-pair0-k24": ("topology", 4, 730, 48, [24] * 2, False, (40, 51, 58), 0.0, False, 200),
    "k1-month-start": ("topology", 0, 30, 28, [1] * 4, False, (), "rows", True, 30),
    "k5-past-T_pred": ("topology", 0, 30, 40, [5] * 3, False, (), 0.05, False, 47),
    "k33-endogenous": ("topology", 0, 730, 48, [33, 24], True, (), 0.0, True, 90),
    "k168-past-T_pred": ("relay", 0, 730, 24, [168], False, (), "rows", False, 120),
    "hot-port-165-legs": ("hotter-port", 0, 730, 48, [24, 1, 33], False, (), 0.05, False, 200),
    "main-cell-empty-ports": ("main-cell", 0, 730, 48, [24, 5], False, (), "rows", False, 200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATED_ROUTED_CASES))
def test_stream_chunk_routed_gated_matches_plain(cuda_device, case):
    """The routed chunk's gated instance against stream_chunk_routed_ref
    with the same per-port gate on the card, every output bit: relay and
    multicast routings, NaN demand under padding legs, K = 1 across a month
    start, K = 5, 33 and 168 past T_pred, endogenous CCI demand, a 165-leg
    port, the 2048-pair cell's routing with its empty ports; margins 0,
    0.05 and per port, both renewals, NaN predictions (ports 3 and 10 where
    they exist); one stream_chunk_routed_gated launch a chunk."""
    name, pad, hpm, t_first, Ks, endo, nan_hours, margin, renew, T_pred = \
        GATED_ROUTED_CASES[case]
    sc, topo, r = _routed_scenario(name, pad, hpm)
    demand = sc.demand.copy()
    demand[0, list(nan_hours)] = np.nan
    cci = demand * 1.5 if endo else None
    cblk = lambda a, b: None if cci is None else cci[:, a:b]
    toggle = topo.stack(r, torch.float64, cuda_device).toggle
    pol = _gated_policy(toggle, topo.n_ports, T_pred, margin, renew, len(case))
    rt = FleetRuntime(topo, routing=r, policy=pol, device=cuda_device)
    t = 0
    while t < t_first:
        k = min(24, t_first - t)
        rt.step_many(demand[:, t:t + k], cci_demand_block=cblk(t, t + k))
        t += k
    for K in Ks:
        block, _, e = rt._pack(demand[:, t:t + K], cblk(t, t + K))
        dev_block = torch.from_numpy(block).to(cuda_device)
        want, want_fsm = ref.stream_chunk_routed_ref(*rt._chunk_args(dev_block, K, e),
                                                     renew_in_chunks=renew, gate=rt._gate)
        before = dict(ops.LAUNCHES)
        got = rt._launch(dev_block, K, e)
        assert ops.LAUNCHES["stream_chunk_routed_gated"] == \
            before["stream_chunk_routed_gated"] + 1
        assert ops.LAUNCHES["stream_chunk_routed"] == before["stream_chunk_routed"]
        assert _same_bits(got, want), (case, t)
        assert _same_bits(rt._state.fsm, want_fsm), (case, t)
        rt._commit(got.cpu().numpy(), K)
        t += K


@pytest.mark.cuda
def test_forecast_streams_on_the_card_equal_the_card_plans(cuda_device):
    """The forecast-gated stream on the card against the card's offline plan
    of the same policy (the same predicted costs), every bit of x and state,
    and its cost series, which no policy changes, every bit against the CPU
    plan's (the card plan's monthly_cumsum is a parallel scan, the stream's
    sequential): fleet mode at 16 x 2000 (K = 24 chunks, then per-tick
    hours), topology mode on 64 pairs x 200 h with a reroute at hour 96
    against replay_plan_topology. Only the gated instances launch."""
    sc = build_fleet_scenario(16, horizon=2000, seed=0)
    arrays = sc.fleet.stack(torch.float64, cuda_device)
    pol = _gated_policy(arrays.toggle, 16, 2000, "rows", False, 1)
    ops.reset_launches()
    rt = FleetRuntime(arrays, policy=pol, device=cuda_device)
    outs = [rt.step_many(sc.demand[:, t:t + 24]) for t in range(0, 1992, 24)]
    outs += [{k: v[:, None] for k, v in rt.step(sc.demand[:, t]).items()}
             for t in range(1992, 2000)]
    got = {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}
    assert ops.LAUNCHES["stream_chunk_gated"] == 83 + 8
    assert ops.LAUNCHES["stream_chunk"] == ops.LAUNCHES["fsm_scan_gated"] == 0
    plan = plan_fleet(arrays, sc.demand, policy=pol, device=cuda_device)
    cpu = plan_fleet(sc.fleet, sc.demand, device="cpu")
    for k, want in (("x", plan["x"]), ("state", plan["state"]),
                    ("vpn_cost", cpu["vpn_hourly"]), ("cci_cost", cpu["cci_hourly"])):
        assert np.array_equal(got[k], want.cpu().numpy()), k
    assert (got["x"] != plan_fleet(arrays, sc.demand, device=cuda_device)["x"].cpu().numpy()).any()

    tsc, topo, r = _routed_scenario("topology", 8, 730)
    moved = np.asarray(r.primary).copy()
    for i, pr in enumerate(topo.pairs[:6]):
        moved[i] = next((c for c in pr.candidates if c != moved[i]), moved[i])
    r1 = topo.plan(moved)
    tarr = topo.stack(r, torch.float64, cuda_device)
    tpolicy = _gated_policy(tarr.toggle, topo.n_ports, 200, 0.05, False, 2)
    ops.reset_launches()
    trt_ = FleetRuntime(topo, routing=r, policy=tpolicy, device=cuda_device)
    outs = []
    for t in range(0, 192, 24):
        if t == 96:
            trt_.reroute(r1)
        outs.append(trt_.step_many(tsc.demand[:, t:t + 24]))
    outs += [{k: v[:, None] for k, v in trt_.step(tsc.demand[:, t]).items()}
             for t in range(192, 200)]
    got = {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}
    assert ops.LAUNCHES["stream_chunk_routed_gated"] == 8 + 8
    assert ops.LAUNCHES["stream_chunk_routed"] == 0
    rep = replay_plan_topology(tarr, tsc.demand, [(0, r), (96, r1)], policy=tpolicy,
                               device=cuda_device)
    cpu = replay_plan_topology(topo.stack(r, torch.float64, CPU), tsc.demand,
                               [(0, r), (96, r1)], device="cpu")
    for k, want in (("x", rep["x"]), ("state", rep["state"]),
                    ("vpn_cost", cpu["vpn_hourly"]), ("cci_cost", cpu["cci_hourly"])):
        assert np.array_equal(got[k], want.cpu().numpy()), k


def test_gated_chunk_wrappers_refuse_cpu_tensors_and_bad_gates():
    """Both chunk wrappers take a gate of CUDA tensors or raise before
    anything is built: CPU planes, T_pred that is not the planes' hour count
    or is 0, and planes of the wrong row count."""
    sc = build_fleet_scenario(4, horizon=48, seed=0)
    arrays = sc.fleet.stack(torch.float64, CPU)
    pol = _gated_policy(arrays.toggle, 4, 30, 0.05, False, 0)
    rt = FleetRuntime(arrays, policy=pol, device="cpu")
    block, K, endo = rt._pack(sc.demand[:, :24], None)
    args = rt._chunk_args(torch.from_numpy(block), K, endo)
    p_vpn, p_cci, m, T_pred = rt._gate
    assert T_pred == 30 and p_vpn.shape == (30, 4)
    with pytest.raises(ValueError, match="CUDA"):
        stream_chunk(*args, gate=rt._gate)
    for bad in ((p_vpn, p_cci, m, 29), (p_vpn[:0], p_cci[:0], m, 0),
                (p_vpn[:, :3], p_cci, m, 30)):
        with pytest.raises(ValueError, match="gate|operand"):
            stream_chunk(*args, gate=bad)
    rsc, topo, r = _routed_scenario("relay", 2, 730)
    rpol = _gated_policy(topo.stack(r, torch.float64, CPU).toggle, topo.n_ports, 30, 0.05,
                         False, 0)
    rrt = FleetRuntime(topo, routing=r, policy=rpol, device="cpu")
    block, K, endo = rrt._pack(rsc.demand[:, :24], None)
    rargs = rrt._chunk_args(torch.from_numpy(block), K, endo)
    with pytest.raises(ValueError, match="CUDA"):
        stream_chunk_routed(*rargs, gate=rrt._gate)
    g = rrt._gate
    with pytest.raises(ValueError, match="gate"):
        stream_chunk_routed(*rargs, gate=(g[0], g[1], g[2], 31))


# -- the live forecast stream: the live stream_chunk and stream_chunk_routed -----

from repro_torch.fleet import StreamingForecaster  # noqa: E402
from repro_torch.fleet import engine as teng  # noqa: E402
from repro_torch.kernels.stream_chunk import LIVE_MATH, live_math  # noqa: E402

LIVE_STATES = (1, 8, 16, 3, 17, 33)   # past 16: the run-time instances, two and three passes


def _live_params(S, seed, device):
    """Forecaster parameters with S states: the persistence init's
    timescales, readout weights and bias drawn from the seed."""
    rng = np.random.default_rng(seed)
    p = tssm.demand_forecaster_init(None, S, device=device)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
    return dict(p, w=f32(0.3 * rng.standard_normal(S)), bias=f32(0.05 * rng.standard_normal()))


def _live_forecaster(S, seed, history, device):
    """A StreamingForecaster warmed through ``history`` (rows, H) on ``device``."""
    return StreamingForecaster.from_history(_live_params(S, seed, device), history,
                                            device=device)


def _live_args(rt):
    """The runtime's live operands at its current state, as the chunk
    wrappers take them."""
    st = rt._state
    return (st.ssm_h, st.pred_live, *rt._live)


def _same_chunk(got, want):
    return len(got) == len(want) and all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", LIVE_MATH)
def test_live_transcendentals_equal_torch(cuda_device, fn):
    """The live instances' log1p, exp, expm1 (float64) and log1pf (float32),
    built as the kernels are (-fmad=false), against torch's CUDA ops over
    2^20 values each in the ranges the live path feeds them (forecasts of 0
    to 1e7, the cost fit's exponents, readouts, normalised demand) plus
    zeros, NaN and infinities: every bit equal."""
    rng = np.random.default_rng(LIVE_MATH.index(fn))
    n = 1 << 20
    x = {"log1p": lambda: 10.0 ** rng.uniform(-9, 7, n),
         "exp": lambda: rng.uniform(-40, 40, n),
         "expm1": lambda: rng.uniform(-12, 16, n).astype(np.float32).astype(np.float64),
         "log1pf": lambda: rng.uniform(0, 60, n).astype(np.float32)}[fn]()
    x[:4] = [0.0, np.nan, np.inf, -0.0]
    xt = torch.from_numpy(x).to(cuda_device)
    want = {"log1p": torch.log1p, "exp": torch.exp, "expm1": torch.expm1,
            "log1pf": torch.log1p}[fn](xt)
    assert _same_bits(live_math(xt, fn), want), fn


def _live_fleet_configs(K):
    """Four (Kt, endogenous, renew, margin, S) settings a K: Kt cycles
    through 1-8 with K, and every margin kind, state size and flag appears."""
    return [(1 + (K + j) % 8, j % 2 == 1, j >= 2, MARGIN_KINDS[j],
             LIVE_STATES[(K + j) % len(LIVE_STATES)]) for j in range(4)]


def _live_fleet(K_seed, Kt, margin, renew, S, device, sc, demand):
    """A 64-link live runtime with Kt-tier tables, its cost coefficients and
    margins from _gated_policy and a forecaster warmed through hours 900-1199
    of the demand, streamed to hour 720."""
    arrays = sc.fleet.stack(torch.float64, device)
    b, r = _tier_tables(Kt, 64, K_seed + Kt, device)
    arrays = arrays._replace(tier_bounds=b, tier_rates=r)
    pol = _gated_policy(arrays.toggle, 64, 2, margin, renew, 31 * K_seed + Kt)
    cap = np.array([l.capacity_gb_hr for l in sc.fleet.links])[:, None]
    fc = _live_forecaster(S, K_seed + S, np.minimum(sc.demand[:, 900:], cap), device)
    return arrays, pol, FleetRuntime(arrays, policy=pol, forecaster=fc, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("K", list(range(1, 31)) + [168])
def test_stream_chunk_live_matches_plain(cuda_device, K):
    """The live stream_chunk, forced through both launch forms (the tick
    form where it has an instance, K <= TICK_MAX_K_LIVE = 3), against
    stream_chunk_ref with the same
    live operands on the same blocks of a stream's own state, every output
    bit of the result (the prediction plane included), the FSM carry and
    the forecaster's state: 64 links with 1-8 tiers, S = 1, 3, 8, 16, 17 and 33,
    endogenous CCI demand and renew_in_chunks on and off, margins of 0,
    0.05, per-row values and 1e30, NaN demand in three links, across the
    month start at hour 730; each launch counts under stream_chunk_live
    alone."""
    sc = build_fleet_scenario(64, horizon=1200, seed=0)
    demand = sc.demand.copy()
    demand[[5, 17], 600] = np.nan
    demand[40, 735] = np.nan
    for Kt, endo, renew, margin, S in _live_fleet_configs(K):
        _, _, rt = _live_fleet(K, Kt, margin, renew, S, cuda_device, sc, demand)
        cci = demand * 1.5 if endo else None
        cblk = lambda a, b_: None if cci is None else cci[:, a:b_]
        for t in range(0, 720, 24):
            rt.step_many(demand[:, t:t + 24], cci_demand_block=cblk(t, t + 24))
        t, end = 720, 720 + max(16, K)
        forms = ("tick", "chunk") if K <= TICK_MAX_K_LIVE else ("chunk",)
        while t < end:
            block, _, e = rt._pack(demand[:, t:t + K], cblk(t, t + K))
            args = rt._chunk_args(torch.from_numpy(block).to(cuda_device), K, e)
            live = _live_args(rt)
            want = ref.stream_chunk_ref(*args, renew_in_chunks=renew, live=live)
            assert want[0].shape == (9 * K + 4, 64) and want[2].shape == (64, S)
            for form in forms:
                before = dict(ops.LAUNCHES)
                got = _stream_chunk_launch(form, *args, renew_in_chunks=renew, live=live)
                assert ops.LAUNCHES["stream_chunk_live"] == before["stream_chunk_live"] + 1
                assert ops.LAUNCHES["stream_chunk"] == before["stream_chunk"]
                assert ops.LAUNCHES["stream_chunk_gated"] == before["stream_chunk_gated"]
                assert _same_chunk(got, want), (K, form, t, Kt, endo, renew, margin, S)
            rt._launch(args[0], K, e)
            rt._commit(want[0].cpu().numpy(), K)
            t += K


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 5, 24, 168])
def test_live_prediction_plane_equals_forecaster_scan(cuda_device, K):
    """The live chunk's prediction plane and state against forecaster_scan
    on the same inputs ``u = log1p(float32(min(demand, capacity) / scale))``
    from the same state, then ``maximum(expm1(y), 0)·scale``, every bit; NaN
    demand poisons its row from that hour on."""
    sc = build_fleet_scenario(64, horizon=1200, seed=1)
    demand = sc.demand.copy()
    demand[7, 722] = np.nan
    _, _, rt = _live_fleet(K, 4, 0.05, False, 8, cuda_device, sc, demand)
    for t in range(0, 720, 24):
        rt.step_many(demand[:, t:t + 24])
    block, _, e = rt._pack(demand[:, 720:720 + K], None)
    args = rt._chunk_args(torch.from_numpy(block).to(cuda_device), K, e)
    h, pred, a, oma, w, bias, scale = _live_args(rt)[:7]
    out, _, h_out = stream_chunk(*args, live=_live_args(rt))
    d = torch.minimum(torch.from_numpy(demand[:, 720:720 + K]).to(cuda_device),
                      rt.arrays.capacity[:, None])
    u = torch.log1p((d / scale[:, None]).to(torch.float32))
    y, h_want = ops.forecaster_scan(u.contiguous(), a, oma, w, bias, h)
    zero = torch.zeros((), dtype=torch.float64, device=cuda_device)
    want = torch.maximum(torch.expm1(y.to(torch.float64)), zero) * scale[:, None]
    assert _same_bits(out[8 * K:9 * K].T.contiguous(), want)
    assert _same_bits(h_out, h_want)
    if K > 2:
        assert torch.isnan(out[8 * K + 2:9 * K, 7]).all() and torch.isfinite(out[8 * K:9 * K, :7]).all()


LIVE_ROUTED_CASES = {  # scenario, pad, month, first hour, Ks, endogenous, NaN pair hours,
    #                    margin, renew, S
    "relay-padded-k24": ("relay", 3, 730, 48, [24] * 3, False, (), 0.05, False, 8),
    "multicast-rows-renew": ("multicast", 0, 730, 24, [24] * 3, False, (), "rows", True, 1),
    "nan-pair0-k24": ("topology", 4, 730, 48, [24] * 2, False, (40, 51, 58), 0.0, False, 16),
    "k1-month-start": ("topology", 0, 30, 28, [1] * 4, False, (), "rows", True, 8),
    "k5-s3": ("topology", 0, 30, 40, [5] * 3, False, (), 0.05, False, 3),
    "k33-endogenous": ("topology", 0, 730, 48, [33, 24], True, (), 0.0, True, 8),
    "k24-endogenous-nan": ("topology", 4, 730, 48, [24, 1, 5], True, (50, 60), 1e30, False, 16),
    "k168": ("relay", 0, 730, 24, [168], False, (), "rows", False, 8),
    "hot-port-165-legs": ("hotter-port", 0, 730, 48, [24, 1, 33], False, (), 0.05, False, 8),
    "main-cell-empty-ports": ("main-cell", 0, 730, 48, [24, 5], True, (), "rows", False, 8),
    "k24-k33-two-passes": ("topology", 0, 730, 48, [24, 33], True, (), 0.05, False, 40),
    "k24-k5-s100": ("relay", 0, 730, 48, [24, 5], False, (), "rows", False, 100),
}


def _live_topology(name, pad, hpm, margin, renew, S, seed, device):
    """A routed scenario, a per-port forecast-gated policy and a live
    runtime whose forecaster is warmed through a seeded port history."""
    sc, topo, r = _routed_scenario(name, pad, hpm)
    toggle = topo.stack(r, torch.float64, device).toggle
    pol = _gated_policy(toggle, topo.n_ports, 2, margin, renew, seed)
    rng = np.random.default_rng(seed)
    hist = rng.uniform(0.0, 800.0, (topo.n_ports, 96)) * rng.uniform(0, 1, (topo.n_ports, 1))
    fc = _live_forecaster(S, seed, hist, device)
    return sc, topo, r, pol, fc, FleetRuntime(topo, routing=r, policy=pol, forecaster=fc,
                                              device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(LIVE_ROUTED_CASES))
def test_stream_chunk_routed_live_matches_plain(cuda_device, case):
    """The routed chunk's live instance (with endogenous demand, folding the
    clipped demand beside the bill) against stream_chunk_routed_ref with
    the same per-port live operands on the card, every output bit (the
    prediction plane included), the FSM carry and the forecaster's state:
    relay and multicast routings, NaN demand under padding legs, K = 1
    across a month start, K = 5, 33 and 168, endogenous CCI demand (d_row
    folds the VPN-path demand), a 165-leg port, the 2048-pair cell's routing
    with its empty ports; S = 1, 3, 8 and 16; margins 0, 0.05, per port and
    1e30; both renewals; one stream_chunk_routed_live launch a chunk."""
    name, pad, hpm, t_first, Ks, endo, nan_hours, margin, renew, S = LIVE_ROUTED_CASES[case]
    sc, topo, r, pol, fc, rt = _live_topology(name, pad, hpm, margin, renew, S, len(case),
                                              cuda_device)
    demand = sc.demand.copy()
    demand[0, list(nan_hours)] = np.nan
    cci = demand * 1.5 if endo else None
    cblk = lambda a, b: None if cci is None else cci[:, a:b]
    t = 0
    while t < t_first:
        k = min(24, t_first - t)
        rt.step_many(demand[:, t:t + k], cci_demand_block=cblk(t, t + k))
        t += k
    for K in Ks:
        block, _, e = rt._pack(demand[:, t:t + K], cblk(t, t + K))
        dev_block = torch.from_numpy(block).to(cuda_device)
        live = _live_args(rt)
        want = ref.stream_chunk_routed_ref(*rt._chunk_args(dev_block, K, e),
                                           renew_in_chunks=renew, live=live)
        before = dict(ops.LAUNCHES)
        got = stream_chunk_routed(*rt._chunk_args(dev_block, K, e), renew_in_chunks=renew,
                                  live=live)
        assert ops.LAUNCHES["stream_chunk_routed_live"] == \
            before["stream_chunk_routed_live"] + 1
        assert ops.LAUNCHES["stream_chunk_routed"] == before["stream_chunk_routed"]
        assert ops.LAUNCHES["stream_chunk_routed_gated"] == before["stream_chunk_routed_gated"]
        assert _same_chunk(got, want), (case, t, K)
        rt._launch(dev_block, K, e)
        rt._commit(want[0].cpu().numpy(), K)
        t += K


def _stitched_port_demand(arrays, demand, schedule, hours_per_month):
    """The clipped port demand a stream folds under a routing schedule
    (replay_plan_topology's route stage, segment by segment)."""
    dev = arrays.toggle.theta1.device
    d_pair, vpn_pair = teng._pair_stage(arrays, torch.as_tensor(demand, device=dev),
                                        hours_per_month=hours_per_month)
    T, E, M = demand.shape[1], arrays.routing.n_legs, arrays.n_ports
    starts = [s for s, _ in schedule] + [T]
    parts = []
    for (a, b), (_, plan) in zip(zip(starts, starts[1:]), schedule):
        op = plan.pad_to(E).operand(torch.float64, dev)
        parts.append(teng._route_stage(arrays, op, d_pair[:, a:b], vpn_pair[:, a:b])[0])
    return torch.cat(parts, dim=1)


@pytest.mark.cuda
def test_live_streams_on_the_card_equal_the_card_plans(cuda_device):
    """The live stream on the card against the card's forecaster and plans:
    fleet mode at 16 x 2000 after 500 hours of history (K = 24 chunks, then
    per-tick hours), its forecasts every bit of demand_forecaster_predict's
    columns H + t over history and clipped stream, its decisions every bit
    of plan_fleet fed columns H - 1 + t; topology mode on 64 pairs x 200 h
    with a reroute at hour 96, against the predictions over the stitched
    port demand and replay_plan_topology of the two-segment schedule. Only
    the live instances launch."""
    from repro_torch.models.ssm import demand_forecaster_predict

    sc = build_fleet_scenario(16, horizon=2000, history_hours=500, seed=0)
    arrays = sc.fleet.stack(torch.float64, cuda_device)
    cap = np.array([l.capacity_gb_hr for l in sc.fleet.links])[:, None]
    hist, live = np.minimum(sc.history, cap), np.minimum(sc.demand, cap)
    params = _live_params(8, 0, cuda_device)
    fc = StreamingForecaster.from_history(params, hist, device=cuda_device)
    pol = _gated_policy(arrays.toggle, 16, 2, "rows", False, 1)
    ops.reset_launches()
    rt = FleetRuntime(arrays, policy=pol, forecaster=fc, device=cuda_device)
    outs = [rt.step_many(sc.demand[:, t:t + 24]) for t in range(0, 1992, 24)]
    outs += [{k: v[:, None] for k, v in rt.step(sc.demand[:, t]).items()}
             for t in range(1992, 2000)]
    got = {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}
    assert ops.LAUNCHES["stream_chunk_live"] == 83 + 8
    assert ops.LAUNCHES["stream_chunk"] == ops.LAUNCHES["stream_chunk_gated"] == 0
    H = hist.shape[1]
    y = demand_forecaster_predict(params, np.concatenate([hist, live], 1), fc.scale)
    assert np.array_equal(got["pred_next"], y[:, H:].cpu().numpy(), equal_nan=True)
    rpol = pol._replace(pred_demand=y[:, H - 1:H - 1 + 2000].contiguous())
    plan = plan_fleet(arrays, sc.demand, policy=rpol, device=cuda_device)
    for k in ("x", "state"):
        assert np.array_equal(got[k], plan[k].cpu().numpy()), k

    tsc, topo, r, tpolicy, tfc, trt_ = _live_topology("topology", 8, 730, 0.05, False, 8, 2,
                                                      cuda_device)
    moved = np.asarray(r.primary).copy()
    for i, pr in enumerate(topo.pairs[:6]):
        moved[i] = next((c for c in pr.candidates if c != moved[i]), moved[i])
    r1 = topo.plan(moved)
    ops.reset_launches()
    outs = []
    for t in range(0, 192, 24):
        if t == 96:
            trt_.reroute(r1)
        outs.append(trt_.step_many(tsc.demand[:, t:t + 24]))
    outs += [{k: v[:, None] for k, v in trt_.step(tsc.demand[:, t]).items()}
             for t in range(192, 200)]
    got = {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}
    assert ops.LAUNCHES["stream_chunk_routed_live"] == 8 + 8
    assert ops.LAUNCHES["stream_chunk_routed"] == ops.LAUNCHES["stream_chunk_routed_gated"] == 0
    tarr = topo.stack(r, torch.float64, cuda_device)
    schedule = [(0, r), (96, r1)]
    port_d = _stitched_port_demand(tarr, tsc.demand, schedule, 730)
    h, p0 = tfc.h0, tfc.pred0
    a, oma, w, bias = tssm._operands(tfc.params, cuda_device)
    u = torch.log1p((port_d / trt_._live[4][:, None]).to(torch.float32))
    yy, _ = ops.forecaster_scan(u.contiguous(), a, oma, w, bias, h)
    zero = torch.zeros((), dtype=torch.float64, device=cuda_device)
    want_pred = torch.maximum(torch.expm1(yy.to(torch.float64)), zero) * trt_._live[4][:, None]
    assert np.array_equal(got["pred_next"], want_pred.cpu().numpy(), equal_nan=True)
    tpred = torch.cat([p0[:, None], want_pred[:, :-1]], 1).contiguous()
    rep = replay_plan_topology(tarr, tsc.demand, schedule,
                               policy=tpolicy._replace(pred_demand=tpred), device=cuda_device)
    for k in ("x", "state"):
        assert np.array_equal(got[k], rep[k].cpu().numpy()), k


def test_live_chunk_wrappers_refuse_cpu_tensors_and_bad_operands():
    """Both chunk wrappers take live operands of CUDA tensors or raise before
    anything is built: CPU operands, a gate beside them, a state of 17
    states beside 8-state operands or of the wrong row count, coefficients of
    the wrong shape."""
    sc = build_fleet_scenario(4, horizon=48, seed=0)
    arrays = sc.fleet.stack(torch.float64, CPU)
    pol = _gated_policy(arrays.toggle, 4, 30, 0.05, False, 0)
    fc = _live_forecaster(8, 0, sc.demand[:, :24], CPU)
    rt = FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu")
    block, K, endo = rt._pack(sc.demand[:, :24], None)
    args = rt._chunk_args(torch.from_numpy(block), K, endo)
    live = _live_args(rt)
    with pytest.raises(ValueError, match="CUDA"):
        stream_chunk(*args, live=live)
    gate = (torch.zeros((30, 4), dtype=torch.float64),) * 2 + (live[8], 30)
    with pytest.raises(ValueError, match="exclude"):
        stream_chunk(*args, gate=gate, live=live)
    for i, bad in ((0, torch.zeros((4, 17), dtype=torch.float32)),
                   (0, torch.zeros((3, 8), dtype=torch.float32)),
                   (7, torch.zeros((4, 3), dtype=torch.float64))):
        wrong = list(live)
        wrong[i] = bad
        with pytest.raises(ValueError, match="live|operand"):
            stream_chunk(*args, live=tuple(wrong))
    rsc, topo, r = _routed_scenario("relay", 2, 730)
    rpol = _gated_policy(topo.stack(r, torch.float64, CPU).toggle, topo.n_ports, 30, 0.05,
                         False, 0)
    rfc = _live_forecaster(4, 0, np.ones((topo.n_ports, 10)), CPU)
    rrt = FleetRuntime(topo, routing=r, policy=rpol, forecaster=rfc, device="cpu")
    block, K, endo = rrt._pack(rsc.demand[:, :24], None)
    rargs = rrt._chunk_args(torch.from_numpy(block), K, endo)
    with pytest.raises(ValueError, match="CUDA"):
        stream_chunk_routed(*rargs, live=_live_args(rrt))


# -- observability on the streaming runtime ----------------------------------------


def _obs_stream(rt, demand, K, swap=None):
    """Chunks of K, a per-tick tail, ``rt.reroute(swap[1])`` at hour
    ``swap[0]``; (outputs stacked to (rows, T), the runtime)."""
    T = demand.shape[1]
    outs, t = [], 0
    while t < T:
        if swap is not None and t == swap[0]:
            rt.reroute(swap[1])
        if t + K <= T:
            outs.append(rt.step_many(demand[:, t:t + K]))
            t += K
        else:
            outs.append({k: v[:, None] for k, v in rt.step(demand[:, t]).items()})
            t += 1
    return {k: np.concatenate([o[k] for o in outs], 1) for k in outs[0]}


def _obs_cases(device):
    """(name, spec, runtime keywords, demand, swap) of a fleet and a rerouted
    topology stream, each with a replay-mode gated policy."""
    from repro_torch.fleet import forecast_gated_policy

    sc = build_fleet_scenario(64, horizon=480, seed=0)
    arrays = sc.fleet.stack(torch.float64, CPU)
    pol = _gated_policy(arrays.toggle, 64, 480, "rows", False, 3)
    tsc, topo, r = _routed_scenario("topology", 4, 730)
    moved = np.asarray(r.primary).copy()
    for i, pr in enumerate(topo.pairs[:6]):
        moved[i] = next((c for c in pr.candidates if c != moved[i]), moved[i])
    tarr = topo.stack(r, torch.float64, CPU)
    rng = np.random.default_rng(4)
    topo_pol = forecast_gated_policy(tarr.toggle, rng.uniform(0.0, 300.0, (topo.n_ports, 200)),
                                 margin=0.05, cost_coef=rng.uniform(0.0, 1.0, (topo.n_ports, 4)))
    return [("fleet", sc.fleet, dict(policy=pol), sc.demand, None),
            ("fleet-reactive", sc.fleet, {}, sc.demand, None),
            ("topology", topo, dict(routing=r, policy=topo_pol), tsc.demand, (96, topo.plan(moved)))]


@pytest.mark.cuda
def test_obs_on_off_bit_equal_on_the_card(cuda_device):
    """With observability on the card streams the same decisions, costs and
    carries as without it, bit for bit (K = 24, drains every 72 hours), and
    the honest stream passes every monitor, the divergence replay and the
    regret oracle on the card."""
    from repro_torch.obs import ObsConfig

    for name, spec, kw, demand, swap in _obs_cases(cuda_device):
        plain_rt = FleetRuntime(spec, device=cuda_device, **kw)
        plain = _obs_stream(plain_rt, demand, 24, swap)
        ort = FleetRuntime(spec, device=cuda_device, obs=ObsConfig(
            cadence=72, divergence=True, max_oracle_ratio=float("inf")), **kw)
        got = _obs_stream(ort, demand, 24, swap)
        for k in plain:
            assert np.array_equal(got[k], plain[k], equal_nan=True), (name, k)
        for k in ("dcum", "dcum_month", "vpn_pref", "cci_pref"):
            assert np.array_equal(getattr(ort._state, k), getattr(plain_rt._state, k)), (name, k)
        assert torch.equal(ort._state.fsm, plain_rt._state.fsm), name
        ops.reset_launches()
        ort.obs_check(final=True)
        assert ops.LAUNCHES["oracle_dp"] >= 1, name
        rep = ort.obs_report()
        assert rep.violations == [] and rep.monitors["divergence"]["checks"] == 1, name


@pytest.mark.cuda
def test_obs_drains_on_the_card_equal_the_cpu(cuda_device):
    """The card's drained windows, monitor summaries and trace equal the CPU
    port's bit for bit (the ring is host work on the same planes)."""
    from repro_torch.obs import ObsConfig

    for name, spec, kw, demand, swap in _obs_cases(cuda_device):
        runs = []
        for dev in (cuda_device, CPU):
            rt = FleetRuntime(spec, device=dev, obs=ObsConfig(
                cadence=72, divergence=True, max_oracle_ratio=float("inf")), **kw)
            _obs_stream(rt, demand, 24, swap)
            rt.obs_check(final=True)
            runs.append(rt)
        # JSON text holds every float's shortest round-trip repr (and NaN as NaN).
        dump = lambda rt: json.dumps([[d.to_json() for d in rt.obs.drained],
                                      rt.obs.monitor_summaries(), rt.obs.trace.events])
        assert dump(runs[0]) == dump(runs[1]), name


@pytest.mark.cuda
def test_regret_oracle_on_the_card_equals_offline_optimal(cuda_device):
    """The regret monitor's oracle, one ``oracle_dp`` launch over the recorded
    series on the card, equals the numpy ``offline_optimal`` of each row
    (zero leases, as the reference's row loop builds them) every bit."""
    from repro_torch.core.costmodel import HourlyCosts
    from repro_torch.core.oracle import offline_optimal
    from repro_torch.obs import ObsConfig

    sc = build_fleet_scenario(24, horizon=600, seed=2)
    rt = FleetRuntime(sc.fleet, device=cuda_device,
                      obs=ObsConfig(cadence=120, max_oracle_ratio=float("inf")))
    _obs_stream(rt, sc.demand, 24)
    ops.reset_launches()
    got = rt.obs.regret.oracle_cost()
    assert ops.LAUNCHES["oracle_dp"] in (1, 2)       # one call (two forms if mixed)
    reg = rt.obs.regret
    vpn, cci = np.stack(reg.vpn_hist, 1), np.stack(reg.cci_hist, 1)
    zeros = np.zeros(vpn.shape[1])
    for m in range(vpn.shape[0]):
        p = dataclasses.make_dataclass("P", ["D", "T_cci"])(int(reg.D[m]), int(reg.T_cci[m]))
        want = offline_optimal(p, costs=HourlyCosts(vpn_lease=zeros, vpn_transfer=vpn[m],
                                                    cci_lease=zeros, cci_transfer=cci[m]))
        assert got[m] == want.total_cost, m


# ---------------------------------------------------------------------------
# The gateway's pooled chunk instances (per-row clocks)
# ---------------------------------------------------------------------------

from repro_torch.fleet import RuntimeConfig  # noqa: E402
from repro_torch.fleet.routing import RoutingOperand, index_legs  # noqa: E402
from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec  # noqa: E402

POOL_KINDS = ("reactive", "hysteresis", "replay")


def pooled_bucket(topology: bool, kind: str, device, *, staggered: bool = True, S: int = 4,
                  cadence=None):
    """A gateway (observability on at ``cadence`` when given, else off) whose
    one bucket holds S tenants of one
    shape (6 links, or 6 pairs on 4 ports: 2 padded rows a slot, and a
    reserved pad port), their demand scaled apart. ``staggered``: they join
    at gateway hours 0, 5, 31 and 51 with 24, 730, 40 and 730 hours a month,
    so that after 20 more hours the slots' clocks are 71, 66, 40 and 20: a
    month starts at a chunk's first hour in slot 2 and at its second in slot
    0; otherwise all join at hour 0 with one calendar. ``kind`` "replay" gives
    each a forecast-gated policy of 70 to 128 prediction columns (one
    pred_cap of 128). Returns the gateway and its bucket."""
    T = 400
    hpms = (24, 730, 40, 730) if staggered else (730,) * S
    joins = (0, 5, 31, 51) if staggered else (0,) * S
    rng = np.random.default_rng(7)
    if topology:
        sc = tscen.build_topology_scenario(6, n_facilities=2, ports_per_facility=2, horizon=T,
                                           seed=0)
        routing = optimize_routing(sc.topo, sc.demand)
        arrays = sc.topo.stack(routing, torch.float64, device)
    else:
        sc = build_fleet_scenario(6, horizon=T, seed=0)
        routing, arrays = None, sc.fleet.stack(torch.float64, device)
    tog = arrays.toggle
    M = tog.h.shape[0]
    gw = FleetGateway(GatewayConfig(slots_per_bucket=S, obs=cadence is not None,
                                    cadence=cadence or 64), device=device)
    for i in range(S):
        policy = None
        if kind == "hysteresis":
            policy = tpol.hysteresis_policy(tog, up_hold=1 + i % 3, down_hold=2)
        elif kind == "replay":
            pred = rng.uniform(0.0, 300.0, (M, (70, 100, 128, 90)[i % 4]))
            coef = np.stack([rng.uniform(0.5, 1.5, M), rng.uniform(0.3, 0.6, M),
                             rng.uniform(0.5, 1.5, M), rng.uniform(0.3, 0.6, M)], axis=1)
            policy = tpol.forecast_gated_policy(tog, pred, margin=0.05, cost_coef=coef)
        if topology:
            spec = dataclasses.replace(sc.topo, hours_per_month=hpms[i])
            cfg = RuntimeConfig(routing=routing, policy=policy)
        else:
            spec, cfg = arrays, RuntimeConfig(hours_per_month=hpms[i], policy=policy)
        while gw.hours < joins[i]:
            gw.tick(collect=False)
        gw.join(f"t{i}", TenantSpec(spec=spec, demand=sc.demand * (1.0 + 0.1 * i), config=cfg))
    for _ in range(20):
        gw.tick(collect=False)
    (b,) = gw._live_buckets()
    return gw, b


def pooled_call(gw, b, K: int) -> tuple:
    """``(args, kwargs)`` of the bucket's next pooled chunk of K hours."""
    block, _ = gw._pack(b, K)
    return b.chunk_args(block, K)


def scalar_clock(args, kw) -> tuple:
    """``(args, kwargs)`` of the pooled call with its clocks as ints (they
    must agree on every row): the scalar instance's call."""
    clocks = kw["clocks"]
    t0s = {int(v) for c in clocks[::2] for v in c.tolist()}
    hpms = {int(v) for v in clocks[1].tolist()}
    assert len(t0s) == len(hpms) == 1, (t0s, hpms)
    return [*args, t0s.pop(), hpms.pop()], dict(kw, clocks=None)


def slot_call(args, kw, s: int, b) -> tuple:
    """Slot ``s``'s own scalar chunk call, cut from a pooled call: its rows
    of every operand and carry, its block (its demand and window reads), its
    local leg list (topology) and its clock as ints."""
    key, S = b.key, b.n_slots
    M, P = key.rows_cap, key.pairs_cap
    K = args[1]
    rows = lambda x, n: x[s * n:(s + 1) * n].contiguous()
    cols = lambda x, n: x[:, s * n:(s + 1) * n].contiguous()
    block = args[0]
    nd = K * S * P
    pre = [block[nd + i * K * S * M:nd + (i + 1) * K * S * M].view(K, S, M)[:, s] for i in (0, 1)]
    gate = kw["gate"]
    if gate is not None:
        gate = (cols(gate[0], M), cols(gate[1], M), rows(gate[2], M), gate[3])
    t0, hpm = kw["clocks"][:2]
    kw = dict(kw, gate=gate, clocks=None)
    if key.topology:
        dem = block[:nd].view(S, P, K)[s].reshape(-1)
        pair = [rows(x, P) for x in args[3:7]]
        port = [rows(x, M) for x in args[7:17]]
        r, E = args[17], key.legs_cap
        op = RoutingOperand(leg_pair=rows(r.leg_pair, E) - s * P,
                            leg_port=rows(r.leg_port, E) - s * M, vpn_w=rows(r.vpn_w, E),
                            attach_w=rows(r.attach_w, E), primary=rows(r.primary, P) - s * M)
        cal, fsm, pref = cols(args[18], P), cols(args[19], M), cols(args[20], M)
        clock = [int(t0[s * M]), int(hpm[s * P])]
        one = [torch.cat([dem, *(p.reshape(-1) for p in pre)]), K, False, *pair, *port,
               index_legs(op, M), cal, fsm, pref, *clock]
    else:
        dem = block[:nd].view(K, S, P)[:, s]
        per_row = [rows(x, M) for x in args[3:16]]
        cal, fsm, pref = cols(args[16], P), cols(args[17], M), cols(args[18], M)
        one = [torch.cat([p.reshape(-1) for p in (dem, *pre)]), K, False, *per_row, cal, fsm,
               pref, int(t0[s * M]), int(hpm[s * M])]
    return one, kw


def slot_result(res, fsm, s: int, b, K: int) -> tuple:
    """Slot ``s``'s part of a pooled chunk's result and FSM carry, in the
    layout of its own scalar call's."""
    key, S = b.key, b.n_slots
    M, P = key.rows_cap, key.pairs_cap
    flat = res.reshape(-1)
    planes = flat[:8 * K * S * M].view(8 * K, S, M)[:, s]
    tail = flat[8 * K * S * M:]
    cal = tail[:2 * S * P].view(2, S, P)[:, s]
    pref = tail[2 * S * P:].view(2, S, M)[:, s]
    fsm_s = fsm[:, s * M:(s + 1) * M]
    if key.topology:
        out = torch.cat([planes.reshape(-1), cal.reshape(-1), pref.reshape(-1)])
    else:
        out = torch.cat([planes, cal, pref])
    return out, fsm_s


POOLED_FORMS = [(False, "tick", K) for K in range(1, TICK_MAX_K + 1)] + \
    [(False, "chunk", K) for K in (1, 5, 6, 24, 25)] + [(True, "routed", K)
                                                       for K in (1, 5, 6, 24, 25, 40)]


def _pooled_launch(topology, form, args, kw):
    if topology:
        return stream_chunk_routed(*args, **kw)
    return _stream_chunk_launch(form, *args, **kw)


def test_pooled_wrappers_refuse_cpu_tensors_and_live_mode():
    """The pooled calls launch on CUDA tensors or raise; per-row clocks with
    live= are refused by the wrappers and the plain versions alike."""
    for topology in (False, True):
        gw, b = pooled_bucket(topology, "reactive", CPU)
        args, kw = pooled_call(gw, b, 3)
        with pytest.raises(ValueError, match="CUDA"):
            _pooled_launch(topology, "auto", args, kw)
        plain = ref.stream_chunk_routed_ref if topology else ref.stream_chunk_ref
        with pytest.raises(ValueError, match="no live mode"):
            plain(*args, **dict(kw, live=(None,) * 9))
        with pytest.raises(ValueError, match="pass one or the other"):
            plain(*args, 0, 730, **kw)
        with pytest.raises(ValueError, match="want int t0"):
            plain(*args, **dict(kw, clocks=None))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("topology,form,K", POOLED_FORMS,
                         ids=lambda v: str(v) if not isinstance(v, bool) else
                         ("routed" if v else "fleet"))
def test_pooled_chunk_kernel_matches_plain(cuda_device, topology, form, K, kind):
    """The pooled instance of each chunk kernel, both fleet launch forms and
    the routed kernel, at K around the forms' edges and past the routed
    tile, on a bucket whose slots keep different clocks and calendars (month
    starts inside the chunk, replay columns past a slot's T_pred): every
    output bit equal to the plain version on the same operands, one launch
    counted under the pooled name."""
    gw, b = pooled_bucket(topology, kind, cuda_device)
    args, kw = pooled_call(gw, b, K)
    plain = ref.stream_chunk_routed_ref if topology else ref.stream_chunk_ref
    want, want_fsm = plain(*args, **kw)
    name = ("stream_chunk_routed_pooled" if topology else "stream_chunk_pooled") + \
        ("_gated" if kind == "replay" else "")
    before = ops.LAUNCHES[name]
    got, got_fsm = _pooled_launch(topology, form, args, kw)
    assert ops.LAUNCHES[name] == before + 1
    assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm), (topology, form, K, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("topology,form,K", POOLED_FORMS,
                         ids=lambda v: str(v) if not isinstance(v, bool) else
                         ("routed" if v else "fleet"))
def test_pooled_kernel_equals_the_scalar_instance(cuda_device, topology, form, K, kind):
    """One common clock on every row: the pooled launch gives the scalar
    instance's bits. Distinct clocks: each slot's part of the pooled launch
    equals that slot's own scalar launch, every bit."""
    gw, b = pooled_bucket(topology, kind, cuda_device, staggered=False)
    args, kw = pooled_call(gw, b, K)
    got, got_fsm = _pooled_launch(topology, form, args, kw)
    want, want_fsm = _pooled_launch(topology, form, *scalar_clock(args, kw))
    assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm)
    gw, b = pooled_bucket(topology, kind, cuda_device)
    args, kw = pooled_call(gw, b, K)
    got, got_fsm = _pooled_launch(topology, form, args, kw)
    for s in range(b.n_slots):
        one, kw1 = slot_call(args, kw, s, b)
        want, want_fsm = _pooled_launch(topology, form, one, kw1)
        g, gf = slot_result(got, got_fsm, s, b, K)
        assert _same_bits(g, want) and _same_bits(gf, want_fsm), s


@pytest.mark.cuda
@pytest.mark.parametrize("topology", [False, True], ids=["fleet", "routed"])
def test_gateway_on_the_card_equals_the_cpu(cuda_device, topology):
    """The gateway on the card against the CPU gateway, observability on
    (cadence 24): every step output, billing total and drained window bit
    for bit, through ticks, chunks of 24, a leave and a rejoin into the
    freed slot."""
    runs = []
    for dev in (cuda_device, CPU):
        gw, _ = pooled_bucket(topology, "replay", dev, cadence=24)
        steps = [gw.tick()]                          # to hour 72, a drain hour
        steps += [gw.tick_many(24) for _ in range(2)]
        spec = gw._specs["t1"]
        gw.leave("t1")
        gw.join("t1", spec)
        steps += [gw.tick() for _ in range(5)]
        gw.check()
        runs.append((gw, steps))
    (ga, sa), (gb, sb) = runs
    for oa, ob in zip(sa, sb):
        assert oa.keys() == ob.keys()
        for name in oa:
            for f, v in oa[name].items():
                assert np.array_equal(v, ob[name][f], equal_nan=True), (name, f)
    for name in ("t0", "t1", "t2", "t3"):
        assert ga.billing(name) == gb.billing(name)
        dump = lambda g: json.dumps([d.to_json() for d in g.metrics(name)])
        assert dump(ga) == dump(gb) and ga.metrics(name), name


# -- the routed chunk's two launch forms --------------------------------------
from _routed_cases import synthetic_chunk, synthetic_routing  # noqa: E402

#: (legs of each port, pairs, padding legs on pad port 0, NaN (pair, hour)s of
#: pad pair 0): ports of 0 legs, 1 leg and exactly the small-port form's cap;
#: padding legs and NaN demand in the pad pair; the gateway's bucket shape (8
#: ports a slot, 4 pairs a port); ports so full that a port's slice of the
#: calendars overflows its warp's rows and is walked apart.
SMALL_PORT_CASES = {
    "edges": ([0, 1, SMALL_PORT_MAX_LEGS, 5, 7, 3, 0, 12], 48, 0, ()),
    "pad-nan": ([3, 1, 0, 4, 2, 6], 24, 9, ((0, 0), (0, 17), (0, 30), (0, 39))),
    "bucket": ([12, 0, 4, 4, 3, 2, 6, 1] * 8, 256, 0, ()),
    "slice-overflow": ([30, 28, 31, 29], 36, 0, ()),
}
ROUTED_FORM_KINDS = ("reactive", "replay")


@pytest.mark.cuda
@pytest.mark.parametrize("endo", [False, True], ids=["exo", "endo"])
@pytest.mark.parametrize("pooled", [False, True], ids=["scalar", "pooled"])
@pytest.mark.parametrize("kind", ROUTED_FORM_KINDS)
@pytest.mark.parametrize("K", [1, 24, 25, 40])
@pytest.mark.parametrize("case", sorted(SMALL_PORT_CASES))
def test_stream_chunk_routed_small_port_form_matches_plain(cuda_device, case, K, kind, pooled,
                                                           endo):
    """The small-port form against stream_chunk_routed_ref and the port-block
    form on the same operands, every output bit (NaN in the same places):
    reactive and replay (some ports read past T_pred), scalar and pooled
    (months of 24, 40, 168 and 730 hours starting at and inside the chunk on
    per-pair clocks), K = 1, 24, 25 and 40 (across the hour tile, where the
    port-block form's carries go through its leg_cal scratch), with and
    without CCI demand (a third plane). Each launch counts under its
    instance's name, the small-port form's also under
    stream_chunk_routed_small_port. Where the small-port launch would not fit
    the shared memory (a 32-row port with CCI demand past K = 24), forcing
    it raises and the port-block form alone is held."""
    port_legs, P, pad, nan = SMALL_PORT_CASES[case]
    r = synthetic_routing(port_legs, P, pad_legs=pad, seed=11, device=cuda_device)
    assert r.index.max_legs == max(port_legs[0] + pad, max(port_legs)) <= SMALL_PORT_MAX_LEGS
    nan = [(p, k) for p, k in nan if k < K]
    args, kw = synthetic_chunk(r, P, K, seed=K, device=cuda_device, pooled=pooled,
                               T_pred=60 if kind == "replay" else 0, nan=nan, endo=endo)
    want, want_fsm = ref.stream_chunk_routed_ref(*args, **kw)
    name = "stream_chunk_routed" + ("_pooled" if pooled else "") + \
        ("_gated" if kind == "replay" else "")
    before = dict(ops.LAUNCHES)
    pb, pb_fsm = stream_chunk_routed(*args, **kw, form="port_block")
    assert _same_bits(pb, want) and _same_bits(pb_fsm, want_fsm), (case, K, kind, pooled)
    assert ops.LAUNCHES["stream_chunk_routed_small_port"] == \
        before["stream_chunk_routed_small_port"]
    if not small_port_fits(r.index, P, K, 4, endo):
        assert endo and K > 24, (case, K)
        with pytest.raises(ValueError, match="bytes of shared memory"):
            stream_chunk_routed(*args, **kw, form="small_port")
        return
    got, got_fsm = stream_chunk_routed(*args, **kw, form="small_port")
    assert ops.LAUNCHES[name] == before[name] + 2
    assert ops.LAUNCHES["stream_chunk_routed_small_port"] == \
        before["stream_chunk_routed_small_port"] + 1
    assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm), (case, K, kind, pooled)
    if nan:
        assert bool(torch.isnan(got[:8 * K * len(port_legs)]).any())


@pytest.mark.cuda
def test_stream_chunk_routed_auto_form_follows_the_rule(cuda_device):
    """With no form given the wrapper launches the form the selection rule
    takes from the hottest port its index counted on the host: the small-port
    form from 133 ports on up to 16 legs, from 384 ports on up to 32; the
    port-block form past the cap or below the floor. A runtime streaming a
    routing of 32 ports of few legs launches the port-block form, a gateway
    bucket of 256 such slots the small-port form."""
    counted = lambda: ops.LAUNCHES["stream_chunk_routed_small_port"]
    floor, wide = SMALL_PORT_MIN_PORTS, SMALL_PORT_WIDE_PORTS
    for legs, M, small in ((16, floor, True), (17, floor, False), (16, floor - 1, False),
                           (SMALL_PORT_MAX_LEGS, wide, True),
                           (SMALL_PORT_MAX_LEGS + 1, wide, False),
                           (SMALL_PORT_MAX_LEGS, wide - 1, False)):
        port_legs = [legs] + ([2, 0, 5] * M)[:M - 1]
        r = synthetic_routing(port_legs, legs + 8, seed=5, device=cuda_device)
        assert r.index.n_ports == M
        args, kw = synthetic_chunk(r, legs + 8, 24, seed=5, device=cuda_device)
        before = counted()
        got, got_fsm = stream_chunk_routed(*args, **kw)
        assert counted() == before + small, (legs, M)
        want, want_fsm = ref.stream_chunk_routed_ref(*args, **kw)
        assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm), (legs, M)
    rsc, topo, rr = _routed_scenario("topology", 0, 730)
    rt = FleetRuntime(topo, routing=rr, device=cuda_device)
    cpu = FleetRuntime(topo, routing=rr, device=CPU)
    before = counted()
    got, want = rt.step_many(rsc.demand[:, :24]), cpu.step_many(rsc.demand[:, :24])
    assert counted() == before
    for k in ("x", "state", "vpn_cost", "cci_cost"):
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("K", [24, 40])
@pytest.mark.parametrize("hot_legs,pairs_a_port", [(16, 16), (24, 20), (32, 32)])
def test_stream_chunk_routed_full_rows_with_cci_demand(cuda_device, hot_legs, pairs_a_port, K):
    """384 ports whose rows fill at 32 (16-32 pairs a port), a hottest port of
    16-32 legs, CCI demand and 4 tiers: at K = 40 the small-port launch
    would need more shared memory than a block gets, so the wrapper takes
    the port-block form (no small-port launch) and the call equals the plain
    version; at K = 24 it fits and the small-port form equals the plain
    version and the port-block form."""
    M = SMALL_PORT_WIDE_PORTS
    P = pairs_a_port * M
    r = synthetic_routing([hot_legs] + [3, 1, 0, 6] * (M // 4 - 1) + [2, 2, 5], P, seed=9,
                          device=cuda_device)
    assert (r.index.n_ports, r.index.max_legs) == (M, hot_legs)
    args, kw = synthetic_chunk(r, P, K, seed=K, device=cuda_device, endo=True)
    form = routed_launch_form(r.index, P, K, 4, True)
    assert form == ("small_port" if K <= 24 else "port_block"), (hot_legs, K)
    before = ops.LAUNCHES["stream_chunk_routed_small_port"]
    got, got_fsm = stream_chunk_routed(*args, **kw)
    assert ops.LAUNCHES["stream_chunk_routed_small_port"] == before + (form == "small_port")
    want, want_fsm = ref.stream_chunk_routed_ref(*args, **kw)
    assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm), (hot_legs, K)
    if form == "small_port":
        pb, pb_fsm = stream_chunk_routed(*args, **kw, form="port_block")
        assert _same_bits(pb, got) and _same_bits(pb_fsm, got_fsm)
    else:
        with pytest.raises(ValueError, match="bytes of shared memory"):
            stream_chunk_routed(*args, **kw, form="small_port")


@pytest.mark.cuda
def test_gateway_topology_bucket_takes_the_small_port_form(cuda_device):
    """A card gateway of 256 topology tenants (32 pairs on 8 ports: 2048
    ports of at most 12 legs): every tick and chunk is one pooled launch in
    the small-port form, and its first tenant equals a standalone card
    runtime on every field."""
    from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec
    from repro_torch.fleet import RuntimeConfig

    sc = tscen.build_topology_scenario(32, n_facilities=4, ports_per_facility=2, horizon=80,
                                       seed=0)
    plan = optimize_routing(sc.topo, sc.demand)
    gw = FleetGateway(GatewayConfig(slots_per_bucket=256, queue_limit=256, obs=False),
                      device=cuda_device)
    for i in range(256):
        gw.join(f"t{i}", TenantSpec(spec=sc.topo, demand=sc.demand * (1.0 + 0.01 * (i % 97)),
                                    config=RuntimeConfig(routing=plan)))
    rt = FleetRuntime(sc.topo, routing=plan, device=cuda_device)
    before = ops.LAUNCHES["stream_chunk_routed_small_port"]
    for t in range(3):
        got = gw.tick()["t0"]
        want = rt.step(np.ascontiguousarray(sc.demand[:, t]))
        for f in ("x", "state", "vpn_cost", "cci_cost", "cost"):
            assert np.array_equal(np.asarray(got[f]), np.asarray(want[f])), (t, f)
    got, want = gw.tick_many(24)["t0"], rt.step_many(sc.demand[:, 3:27])
    for f in ("x", "state", "vpn_cost", "cci_cost", "cost"):
        assert np.array_equal(np.asarray(got[f]), np.asarray(want[f])), f
    assert ops.LAUNCHES["stream_chunk_routed_small_port"] == before + 4


# ---------------------------------------------------------------------------
# The MoE layer: routing, dispatch and combine (Mixtral's shapes, DeepSeek-V3's router)
# ---------------------------------------------------------------------------

# name: (G, N, E, k, C, router, logits): Mixtral's prefill and decode groups
# (C = 320 and 8), DeepSeek-V3's router, the all-zero router (every token
# picks experts 0 and 1, most slots drop) and scores tied by rounding.
MOE_ROUTE_CASES = {
    "mixtral-prefill": (4, 1024, 8, 2, 320, "softmax", "normal"),
    "mixtral-decode": (4, 1, 8, 2, 8, "softmax", "normal"),
    "deepseek-v3-router": (4, 1024, 256, 8, 40, "sigmoid", "normal"),
    "zero-router": (4, 1024, 8, 2, 320, "softmax", "zeros"),
    "rounded-ties": (2, 64, 8, 2, 16, "sigmoid", "saturated"),
}
# G, N, E, k, C, d: Mixtral's prefill and decode, and a row the 16-byte path cannot take
MOE_COPY_SHAPES = [(4, 1024, 8, 2, 320, 4096), (4, 1, 8, 2, 8, 4096), (2, 64, 4, 2, 24, 4094)]


def _moe_logits(G, N, E, kind, device, seed=31):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        a = np.zeros((G, N, E), np.float32)
    elif kind == "saturated":   # sigmoid scores that round to 1.0: ties among different logits
        a = (20.0 + rng.integers(0, 4, (G, N, E)) * np.float32(2e-6)).astype(np.float32)
    else:
        a = rng.standard_normal((G, N, E)).astype(np.float32)
    return torch.as_tensor(a, device=device)


def _moe_routing(G, N, E, k, C, device, seed=32):
    logits = _moe_logits(G, N, E, "normal", device, seed)
    return ref.moe_route_ref(logits, k, C)


def test_moe_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.moe import moe_combine, moe_dispatch, moe_route

    r = ref.moe_route_ref(torch.zeros((1, 4, 4)), 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        moe_route(torch.zeros((1, 4, 4)), 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        moe_dispatch(torch.zeros((1, 4, 16)), r.src, 2)
    with pytest.raises(ValueError, match="CUDA"):
        moe_combine(torch.zeros((4, 1, 8, 16)), r.gate_idx, r.pos, r.keep, r.gate_w)
    with pytest.raises(ValueError, match="E = 300"):
        moe_route(torch.zeros((1, 4, 300)), 2, 8)
    with pytest.raises(TypeError):
        moe_route(torch.zeros((1, 4, 4), dtype=torch.float64), 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MOE_ROUTE_CASES))
def test_moe_route_kernel_matches_plain(cuda_device, case):
    """Decisions (gate_idx, pos, keep, src) equal element for element the
    plain version's on the kernel's own scores; the scores against the plain
    softmax or sigmoid and gate_w at rtol 1e-6; the aux loss at 1e-5 (a
    fixed-order sum against torch's mean)."""
    G, N, E, k, C, router, kind = MOE_ROUTE_CASES[case]
    logits = _moe_logits(G, N, E, kind, cuda_device)
    before = ops.LAUNCHES["moe_route"]
    got = ops.moe_route(logits, k, C, router=router, aux_coef=0.01)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_route"] == before + 1
    torch.testing.assert_close(got.probs, ref.moe_scores_ref(logits, router), rtol=1e-6,
                               atol=1e-7)
    want = ref.moe_decide_ref(got.probs, k, C, router=router, aux_coef=0.01)
    for f in ("gate_idx", "pos", "keep", "src"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.gate_w, want.gate_w, rtol=1e-6, atol=0)
    torch.testing.assert_close(got.aux, want.aux, rtol=1e-5, atol=1e-8)
    if kind == "zeros":
        assert (got.gate_idx == torch.tensor([0, 1], device=cuda_device, dtype=torch.int32)).all()
        assert int((~got.keep).sum()) == G * k * (N - C)
    if kind == "saturated":
        assert bool((got.probs == 1.0).all())
        assert (got.gate_idx == torch.arange(k, device=cuda_device, dtype=torch.int32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MOE_COPY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_moe_dispatch_kernel_matches_plain(cuda_device, shape, dtype):
    """A gather: every bit of the plain version's buffer, zeros included."""
    G, N, E, k, C, d = shape
    r = _moe_routing(G, N, E, k, C, cuda_device)
    x = torch.randn((G, N, d), generator=torch.Generator().manual_seed(33)).to(dtype)
    x = x.to(cuda_device)
    before = ops.LAUNCHES["moe_dispatch"]
    got = ops.moe_dispatch(x, r.src, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_dispatch"] == before + 1
    assert got.shape == (E, G, C, d) and torch.equal(got, ref.moe_dispatch_ref(x, r.src, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", MOE_COPY_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_moe_combine_kernel_matches_plain(cuda_device, shape, dtype):
    """The plain version's order and roundings: float32 at 1e-6, bfloat16
    at 1e-2 (the kernel rounds as the plain version, so both are expected
    to agree bit for bit)."""
    G, N, E, k, C, d = shape
    r = _moe_routing(G, N, E, k, C, cuda_device)
    out = torch.randn((E, G, C, d), generator=torch.Generator().manual_seed(34)).to(dtype)
    out = out.to(cuda_device)
    before = ops.LAUNCHES["moe_combine"]
    got = ops.moe_combine(out, r.gate_idx, r.pos, r.keep, r.gate_w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_combine"] == before + 1
    want = ref.moe_combine_ref(out, r.gate_idx, r.pos, r.keep, r.gate_w)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_moe_lm_on_the_card_matches_the_cpu(cuda_device):
    """Reduced Mixtral in float32: greedy tokens equal, logits within 1e-4,
    each MoE kernel launched once a layer a forward."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.models import lm
    from repro_torch.train.serve import greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_config(get_config("mixtral-8x7b"))
    model = lm.LM(cfg, seed=3, device=cuda_device)
    cpu = lm.LM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (2, 48)))
    ops.reset_launches()
    got = greedy_generate(cfg, model, tokens, 8)
    for name in ("moe_route", "moe_dispatch", "moe_combine"):
        assert ops.LAUNCHES[name] == 8 * cfg.n_layers, name
    assert torch.equal(got.cpu(), greedy_generate(cfg, cpu, tokens, 8))
    with torch.inference_mode():
        g, gx = lm.forward(cfg, model, tokens.to(cuda_device))
        c, cx = lm.forward(cfg, cpu, tokens)
    torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gx["aux"].cpu(), cx["aux"], rtol=1e-5, atol=1e-7)
