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
against the CPU stream, across a reroute.
"""
import dataclasses

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
from repro_torch.fleet.engine import plan_topology
from repro_torch.fleet.topology import optimize_routing
from repro_torch.fleet import policy as tpol
from repro_torch.fleet.spec import pad_tier_tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fsm_scan import fsm_chunk, fsm_scan
from repro_torch.kernels.leg_segment_sum import leg_segment_sum
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.stream_chunk import (TICK_MAX_K, _stream_chunk_launch, stream_chunk,
                                              stream_chunk_routed)
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
    assert ops.LAUNCHES == {"tiered_cost_batched": 1, "fsm_scan": 1,
                            "tiered_cost_scan": 0, "fsm_chunk": 0, "stream_chunk": 0,
                            "stream_chunk_routed": 0, "flash_attention": 0,
                            "flash_attention_sm90": 0, "rmsnorm": 0, "int8_quantize": 0,
                            "int8_dequantize": 0, "tiered_cost": 0, "leg_segment_sum": 0,
                            "oracle_dp": 0}
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
    index and a carry of the wrong type are refused before anything is
    built."""
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
def test_stream_chunk_routed_kernel_matches_plain(cuda_device, case):
    """The routed chunk kernel against stream_chunk_routed_ref on the card,
    on the same packed blocks and carries of a stream's own state, every
    output bit (NaN in the same places): a padded relay routing, a multicast
    tree, NaN demand in pair 0 under padding legs, K = 1 across a month
    start, month starts inside K = 24 chunks, K past the window ring and the
    32-hour tile, endogenous CCI demand, ports of 76 and 165 legs (one and
    two of the port stage's 128-leg tiles; K = 24, 1 and 33), and the
    2048-pair cell's routing with its empty ports and a 105-leg port (K = 24
    and 5)."""
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
    for K in Ks:
        block, _, e = rt._pack(demand[:, t:t + K], cblk(t, t + K))
        dev_block = torch.from_numpy(block).to(cuda_device)
        want, want_fsm = ref.stream_chunk_routed_ref(*rt._chunk_args(dev_block, K, e),
                                                     renew_in_chunks=rt.policy.renew_in_chunks)
        before = ops.LAUNCHES["stream_chunk_routed"]
        got = rt._launch(dev_block, K, e)
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
