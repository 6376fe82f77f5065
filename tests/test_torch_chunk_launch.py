"""The launch plans of ``stream_chunk`` and the month-to-date
``tiered_cost_scan``, and their kernels' schedules, on the CPU.

:func:`repro_torch.kernels.stream_chunk.launch_form` (which form and how
many sub-tiles a chunk of K hours takes) and
:func:`repro_torch.kernels.tiered_cost_scan.segment_plan` /
:func:`~repro_torch.kernels.tiered_cost_scan.segment_slots` (the billing
segments the scan's pre-pass finds in ``reset``, and the grid's segment
slots) are pure functions; here they are checked on edge inputs.

The CUDA kernels have no CPU mode, so the replays below walk their
schedules in numpy, with the same adds in the same order, and are held
against the plain versions (``ref.stream_chunk_ref``,
``ref.tiered_cost_scan_ref``) bit for bit, NaN in the same places:

* ``stream_chunk``'s tick form: one row's K hours end to end, the window
  base picked from the row's own snapshots;
* its chunk form: the block's warp roles (pair warps a sub-tile, the
  calendar, prefix and FSM warps) as coroutines that hand sub-tiles along
  named barriers (``bar.arrive`` by the producer, ``bar.sync`` by the
  consumer) and meet at ``__syncthreads`` once a tile, run in random
  interleavings; every read of shared memory or of an earlier tile's
  snapshot in the packed result must find a value whose write happens
  before it through those barriers; the live instance adds the forecast
  ahead of the pipeline at each tile's top (the pair threads' inputs, a
  ``__syncthreads``, the (row, state) chains of every thread in passes of
  16 states, a ``__syncthreads``, the pair threads' folds and forecasts),
  handed on at the tile's own ``__syncthreads``;
* the scan: the segment plan, one block per (row tile, segment slot), each
  segment's hours staged through the ring of shared-memory tiles (a tile
  must have landed before it is read, and a slot is refilled only once its
  tile is folded), the carry a tile at a time, the fold per (row, hour);
  and a chunk of one segment slot with no plan, its resets staged with the
  demand and applied in the carry;
* the forecaster's scan (``forecaster_scan``): blocks of one chain warp,
  one readout warp a tile behind it and one producer warp meeting at one
  ``__syncthreads`` a step, in random interleavings (two product buffers by
  parity, a ring of ``kAhead + 2`` u tiles; three broken schedules must be
  caught);
* the forecaster's backward pass (``forecaster_scan_bwd``): the forward
  scan's checkpoint of each chain's state at every tile of 64 hours, then
  blocks of ``min(128 // S, 32)`` rows whose u and dy tiles come in reverse
  through a ring of slots (a step must find its tiles there), each step
  recomputing a tile's states from its checkpoint while the adjoint walks
  back through the tile after it, in four-hour groups, the sums in the
  chain; the per-row sums folded over the rows in index order, a staged
  chunk of rows at a time.

Change a kernel's schedule and change its replay with it: the replays read
the kernels' tile constants from the CUDA sources.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.fleet import (FleetRuntime, StreamingForecaster, build_fleet_scenario,
                               build_multicast_scenario, build_relay_scenario,
                               build_topology_scenario, fit_cost_coef, forecast_gated_policy,
                               optimize_routing)
from repro_torch.fleet.engine import routed_cost_series
from repro_torch.fleet.policy import predicted_mode_costs
from repro_torch.kernels import ref
from repro_torch.kernels.forecaster import BWD_TILE, checkpoint_shape
from repro_torch.kernels.forecaster import FAST_STATE
from repro_torch.kernels.stream_chunk import (MAX_SUBS, ROUTED_TILE, SUB_HOURS, TICK_MAX_K,
                                              TICK_MAX_K_LIVE, TICK_MAX_TIERS, launch_form)
from repro_torch.kernels.tiered_cost_scan import (SCAN_ROWS, SCAN_TARGET_BLOCKS,
                                                  segment_plan, segment_slots)
from repro_torch.models.ssm import demand_forecaster_init

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _cu_const(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_tile_constants_match_the_sources():
    assert _cu_const("stream_chunk.cu", "kTickMaxK") == TICK_MAX_K
    assert _cu_const("stream_chunk.cu", "kTickMaxKLive") == TICK_MAX_K_LIVE
    assert _cu_const("stream_chunk.cu", "kTickMaxTiers") == TICK_MAX_TIERS
    assert _cu_const("stream_chunk.cu", "kSub") == SUB_HOURS
    assert _cu_const("stream_chunk.cu", "kMaxSubs") == MAX_SUBS
    assert _cu_const("tiered_cost_scan.cu", "kScanRows") == SCAN_ROWS
    # five named barriers a sub-tile, barrier 0 for __syncthreads: 16 in all
    assert 1 + _cu_const("stream_chunk.cu", "kPhases") * MAX_SUBS <= 16
    # the routed chunk: its hour and leg tiles, a leg a thread, a port's two
    # named barriers beside __syncthreads, the forecaster's states; a block a
    # port (one when there is none), each walking its slice of the pairs'
    # calendars (_routed_calendar)
    routed = (CSRC / "stream_chunk_routed.cu").read_text()
    assert _cu_const("stream_chunk_routed.cu", "kTile") == ROUTED_TILE
    assert "routed_chunk_kernel<G, PL><<<a.M > 0 ? a.M : 1, kThreads, smem, s>>>(a);" in routed
    assert "calendar_slice<G, PL>(a, dyn + slice_offset(st, endo, a.Kt), m, M, lane);" in routed
    assert "const int S = (a.P + nblocks - 1) / nblocks;" in routed
    assert R_THREADS % 32 == 0 and R_THREADS >= R_LEGS   # a thread a leg to stage
    bars = re.search(r"constexpr int kBarCost = (\d+), kBarGate = (\d+);", routed)
    assert bars and 0 < int(bars[1]) != int(bars[2]) < 16
    assert _cu_const("stream_chunk_routed.cu", "kBarThreads") == 2 * 32
    # the live forecaster at any S: the routed chunk's lanes walk a pass of
    # kPassStates states (a lane each), the chunk form's threads passes of
    # kLivePass (a warp's 32 threads two states of 16 rows); the forecaster
    # kernels' compile-time instances end at FAST_STATE, any larger S runs
    # their run-time instances
    assert _cu_const("stream_chunk_routed.cu", "kPassStates") == 32
    assert _cu_const("stream_chunk.cu", "kLivePass") == 16
    for src in ("forecaster_scan.cu", "forecaster_scan_bwd.cu"):
        text = (CSRC / src).read_text()
        assert _cu_const(src, "kFastState") == FAST_STATE
        assert "return launch_any(" in text and "S > kFastState" not in text


# -- launch_form -------------------------------------------------------------

@pytest.mark.parametrize("K,want", [(1, 0), (TICK_MAX_K, 0), (TICK_MAX_K + 1, 1), (8, 1),
                                    (9, 2), (16, 2), (17, 3), (23, 3), (24, 3), (25, 3),
                                    (168, 3)])
def test_launch_form_by_K(K, want):
    assert launch_form(K, 4) == want


@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 24])
def test_launch_form_live_takes_the_tick_form_to_its_own_limit(K):
    """The live instance: "auto" takes the tick form only to TICK_MAX_K_LIVE
    (its chunk form was faster past it on the card), its last tick instance,
    so forcing the tick form past it raises; every other K launches as
    before."""
    assert 1 <= TICK_MAX_K_LIVE <= TICK_MAX_K
    want = 0 if K <= TICK_MAX_K_LIVE else -(-K // SUB_HOURS) if K <= 16 else MAX_SUBS
    assert launch_form(K, 4, live=True) == want
    if K <= TICK_MAX_K_LIVE:
        assert launch_form(K, 4, "tick", live=True) == 0
    else:
        with pytest.raises(ValueError, match=f"at most {TICK_MAX_K_LIVE}"):
            launch_form(K, 4, "tick", live=True)
    assert launch_form(K, TICK_MAX_TIERS + 1, live=True) == min(MAX_SUBS, -(-K // SUB_HOURS))


def test_launch_form_forced_and_refused():
    assert TICK_MAX_K >= 1
    for K in range(1, TICK_MAX_K + 1):
        assert launch_form(K, 4, "tick") == 0
        assert launch_form(K, 4, "chunk") == -(-K // SUB_HOURS)
    assert launch_form(3, TICK_MAX_TIERS + 1) == 1      # tables past the registers
    with pytest.raises(ValueError, match="tick form"):
        launch_form(TICK_MAX_K + 1, 4, "tick")
    with pytest.raises(ValueError, match="tick form"):
        launch_form(1, TICK_MAX_TIERS + 1, "tick")
    with pytest.raises(ValueError, match="form"):
        launch_form(4, 4, "fast")
    with pytest.raises(ValueError):
        launch_form(0, 4)


# -- segment_plan / segment_slots -------------------------------------------

def _plan_np(reset):
    reset = np.asarray(reset)
    K = len(reset)
    starts = [0] + [k for k in range(1, K) if reset[k] != 0]
    return [len(starts)] + starts + [K]


RESETS = {
    "none": np.zeros(100, np.int32),
    "at_0": np.eye(1, 100, 0, dtype=np.int32)[0],
    "at_last": np.eye(1, 100, 99, dtype=np.int32)[0],
    "consecutive": np.isin(np.arange(100), [0, 1, 2, 40, 41, 99]).astype(np.int32),
    "all": np.ones(100, np.int32),
    "monthly": (np.arange(2000) % 730 == 0).astype(np.int32),
    "short_segments": (np.arange(300) % 37 == 5).astype(np.int32),
    "k1_set": np.ones(1, np.int32),
    "k1_clear": np.zeros(1, np.int32),
    "empty": np.zeros(0, np.int32),
    "nonbinary": np.array([0, 7, 0, -1, 0], np.int32),
    "past_a_round": (np.arange(70000) % 3001 == 17).astype(np.int32),
}


@pytest.mark.parametrize("case", sorted(RESETS))
def test_segment_plan(case):
    reset = RESETS[case]
    got = segment_plan(torch.from_numpy(reset))
    assert got.dtype == torch.int32
    assert got.tolist() == _plan_np(reset)


@pytest.mark.parametrize("N,K,want", [(2048, 8760, 16), (2048, 24, 1), (32, 8760, 18),
                                      (1, 1, 1), (1, 0, 1), (33, 730, 2),
                                      (100000, 8760, 1), (64, 512, 1), (64, 513, 2)])
def test_segment_slots(N, K, want):
    got = segment_slots(N, K)
    assert got == want
    assert got == 1 or -(-N // SCAN_ROWS) * got <= SCAN_TARGET_BLOCKS


# -- shared numpy pieces -----------------------------------------------------

def _fold(lo, d, b, r):
    """tier_fold.cuh's fold over rows (b, r: (rows, Kt)): hi = lo + d, then
    one term a tier, added left to right from +0.0."""
    hi = lo + d
    acc = np.zeros_like(lo)
    prev = np.zeros_like(lo)
    for t in range(b.shape[1]):
        seg = np.minimum(hi, b[:, t]) - np.maximum(lo, prev)
        acc = acc + np.where(seg > 0, seg * r[:, t], 0)
        prev = b[:, t]
    return acc


def _same_bits(a, b):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = {torch.float64: torch.int64, torch.float32: torch.int32}.get(a.dtype)
    if as_int is None:
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb) and torch.equal(a.view(as_int).masked_fill(na, 0),
                                                b.view(as_int).masked_fill(nb, 0)))


# -- the scan's schedule -------------------------------------------------------

HOURS = _cu_const("tiered_cost_scan.cu", "kScanHours")
RING = _cu_const("tiered_cost_scan.cu", "kScanRing")


def _scan_replay(cum0, demand, bounds, rates, reset):
    """``tiered_cost_scan_mtd_kernel`` block by block."""
    N, K = demand.shape
    slots = segment_slots(N, K)
    inline = slots == 1                   # no pre-pass: one segment, resets in the carry
    plan = np.array([1, 0, K]) if inline else segment_plan(torch.from_numpy(reset)).numpy()
    S = int(plan[0])
    costs = np.zeros_like(demand)
    cost_writes = np.zeros((N, K), np.int64)
    cum_out = np.zeros_like(cum0)
    cum_writes = np.zeros(N, np.int64)
    for n0 in range(0, N, SCAN_ROWS):
        rows = slice(n0, min(N, n0 + SCAN_ROWS))
        b, r = bounds[rows], rates[rows]
        for y in range(min(slots, S)):
            for s in range(y, S, slots):
                a, ln = int(plan[1 + s]), int(plan[2 + s] - plan[1 + s])
                tiles = -(-ln // HOURS)
                ring = [None] * RING          # (tile, demand, resets) a slot holds
                groups = []                   # committed copies, oldest first
                step = [0]

                def stage(t):
                    slot = t % RING
                    held = ring[slot]
                    assert held is None or held[0] < step[0], \
                        f"tile {t} refills the slot of tile {held[0]}, not yet folded"
                    ring[slot] = (t, None, None)   # in flight: not readable
                    groups.append(t)

                def wait(pending):
                    while len(groups) > pending:
                        t = groups.pop(0)
                        if t * HOURS < ln:
                            cols = slice(a + t * HOURS, a + min(ln, t * HOURS + HOURS))
                            ring[t % RING] = (t, demand[rows, cols], reset[cols])

                fresh = not inline and (s > 0 or (K > 0 and reset[0] != 0))
                cum = np.zeros_like(cum0[rows]) if fresh else cum0[rows].copy()
                stage(0)
                stage(1)
                for t in range(tiles):
                    step[0] = t
                    wait(1)
                    stage(t + 2)
                    held_t, d, rs = ring[t % RING]
                    assert held_t == t and d is not None, f"tile {t} read before it landed"
                    lo = np.empty_like(d)
                    for k in range(d.shape[1]):
                        if inline and rs[k] != 0:
                            cum = np.zeros_like(cum)
                        lo[:, k] = cum
                        cum = cum + d[:, k]
                    for k in range(d.shape[1]):
                        col = a + t * HOURS + k
                        costs[rows, col] = _fold(lo[:, k], d[:, k], b, r)
                        cost_writes[rows, col] += 1
                if s == S - 1:
                    cum_out[rows] = cum
                    cum_writes[rows] += 1
                wait(0)
    assert (cost_writes == 1).all() and (cum_writes == 1).all()
    return costs, cum_out


def _scan_case(case: str, dtype):
    """(cum0, demand, bounds, rates, reset): N rows x K hours of the
    scenarios' tier tables, demand in GB an hour, NaN where asked."""
    N, K, reset = {
        "no_reset": (33, 300, np.zeros(300, np.int32)),
        "monthly": (40, 1500, (np.arange(1500) % 730 == 0).astype(np.int32)),
        "edges": (31, 200, np.isin(np.arange(200), [0, 1, 2, 63, 64, 65, 128, 199])),
        "short_segments": (33, 260, (np.arange(260) % 29 == 3)),
        "one_row": (1, 150, np.isin(np.arange(150), [64, 100])),
        "k1": (33, 1, np.zeros(1, np.int32)),
        "k1_reset": (31, 1, np.ones(1, np.int32)),
        "nan_demand": (33, 200, (np.arange(200) % 70 == 0)),
        "many_segments": (2, 2100, (np.arange(2100) % 60 == 0)),
        "edges_planned": (31, 1100, np.isin(np.arange(1100), [0, 1, 2, 63, 64, 65, 600, 1098,
                                                              1099])),
        "short_planned": (33, 1030, (np.arange(1030) % 29 == 3)),
    }[case]
    rng = np.random.default_rng(5)
    sc = build_fleet_scenario(N, horizon=24, seed=3)
    arrays = sc.fleet.stack(torch.float64, "cpu")
    demand = rng.gamma(2.0, 60.0, (N, K))
    if case == "nan_demand":
        demand[0, 5] = demand[3, 71] = demand[2, 180] = np.nan
        demand[4, 150] = np.inf
    cum0 = rng.uniform(0.0, 3e4, N)
    cast = lambda x: np.ascontiguousarray(np.asarray(x, dtype))
    return (cast(cum0), cast(demand), cast(arrays.tier_bounds.numpy()),
            cast(arrays.tier_rates.numpy()), np.asarray(reset, np.int32))


SCAN_CASES = ["no_reset", "monthly", "edges", "short_segments", "one_row", "k1", "k1_reset",
              "nan_demand", "many_segments", "edges_planned", "short_planned"]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_schedule_bit_equal_to_plain(case, dtype):
    args = _scan_case(case, dtype)
    got = _scan_replay(*args)
    want = ref.tiered_cost_scan_ref(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert _same_bits(torch.from_numpy(g), w), case
    if case == "nan_demand":   # a NaN carry prices the rest of its month +0.0
        assert np.isnan(got[1][2]) and np.isinf(got[1][4])
        assert (got[0][0, 6:70] == 0).all() and (got[0][0, 70:] > 0).any()


def test_scan_replay_catches_a_ring_too_short(monkeypatch):
    """The ring's bookkeeping is live: with two slots, staging two tiles
    ahead refills the slot of the tile being carried."""
    monkeypatch.setattr(__import__(__name__), "RING", 2)
    with pytest.raises(AssertionError, match="not yet folded"):
        _scan_replay(*_scan_case("no_reset", np.float64))


# -- stream_chunk's schedules ------------------------------------------------

OFF, WAITING, ON = 0, 1, 2


def _fsm_step_flat(p, c, req_raw, rel_raw):
    """fsm_step.cuh's fsm_step_flat, which both stream_chunk forms run, over
    rows; ``c`` a dict of int64 arrays."""
    c["up"] = np.where(req_raw, c["up"] + 1, 0)
    c["down"] = np.where(rel_raw, c["down"] + 1, 0)
    req = req_raw & (c["up"] >= p["up"])
    rel = rel_raw & (c["down"] >= p["down"])
    to_wait = (c["state"] == OFF) & req
    to_on = ((c["state"] == WAITING) & (c["t_state"] >= p["D"])) | (to_wait & (p["D"] <= 0))
    past = c["t_state"] >= p["T"]
    check = past & (c["phase"] == 0) if p["renew"] else past
    to_off = (c["state"] == ON) & check & rel
    s = np.where(to_off, OFF, np.where(to_on, ON, np.where(to_wait, WAITING, c["state"])))
    moved = to_wait | to_on | to_off
    c["state"] = s
    c["t_state"] = np.where(moved, 1, c["t_state"] + 1)
    phase = np.where(moved, 0, c["phase"])
    c["phase"] = np.where(phase + 1 == p["T"], 0, phase + 1)
    return s.copy()


def _fsm_step(p, c, req_raw, rel_raw):
    """fsm_step.cuh's fsm_step (the cascade of ``_fsm_cascade``) over rows."""
    c["up"] = np.where(req_raw, c["up"] + 1, 0)
    c["down"] = np.where(rel_raw, c["down"] + 1, 0)
    req = req_raw & (c["up"] >= p["up"])
    rel = rel_raw & (c["down"] >= p["down"])
    for cond, new in ((lambda: (c["state"] == OFF) & req, WAITING),
                      (lambda: (c["state"] == WAITING) & (c["t_state"] >= p["D"]), ON)):
        cond = cond()                     # on the state the step before it left
        c["state"] = np.where(cond, new, c["state"])
        c["t_state"] = np.where(cond, 0, c["t_state"])
        c["phase"] = np.where(cond, 0, c["phase"])
    past = c["t_state"] >= p["T"]
    check = past & (c["phase"] == 0) if p["renew"] else past
    off = (c["state"] == ON) & check & rel
    c["state"] = np.where(off, OFF, c["state"])
    c["t_state"] = np.where(off, 0, c["t_state"])
    c["phase"] = np.where(off, 0, c["phase"])
    s = c["state"].copy()
    c["t_state"] = c["t_state"] + 1
    c["phase"] = np.where(c["phase"] + 1 == p["T"], 0, c["phase"] + 1)
    return s


@pytest.mark.parametrize("renew", [False, True])
def test_fsm_step_flat_equals_the_cascade(renew):
    """fsm_step_flat and fsm_step agree on every carry and trigger pair over
    small counts: states, hours in state 0-6, phases 0-3, hold counters 0-3,
    D 0-3, T_cci 1-4, holds 1-3 (the step's state, carry and return value)."""
    axes = dict(state=[OFF, WAITING, ON], t_state=range(7), phase=range(4), up=range(4),
                down=range(4), req=[False, True], rel=[False, True], D=range(4),
                T=range(1, 5), uh=range(1, 4), dh=range(1, 4))
    grid = np.meshgrid(*(np.asarray(list(v)) for v in axes.values()), indexing="ij")
    g = dict(zip(axes, (x.ravel() for x in grid)))
    keep = g["phase"] < g["T"]              # a carry's phase is t_state % T_cci < T_cci
    g = {k: v[keep] for k, v in g.items()}
    p = {"D": g["D"], "T": g["T"], "up": g["uh"], "down": g["dh"], "renew": renew}
    outs = []
    for step in (_fsm_step, _fsm_step_flat):
        c = {k: g[k].astype(np.int64).copy() for k in ("state", "t_state", "phase", "up", "down")}
        outs.append((step(p, c, g["req"], g["rel"]), c))
    assert len(g["state"]) > 100000
    assert np.array_equal(outs[0][0], outs[1][0])
    for k in outs[0][1]:
        assert np.array_equal(outs[0][1][k], outs[1][1][k]), k


@pytest.mark.parametrize("renew", [False, True])
def test_fsm_step_flat_over_random_runs(renew):
    """Eight hours of fsm_step_flat against eight of fsm_step from random
    carries over random trigger runs (the hold counters carried across)."""
    rng = np.random.default_rng(8)
    rows = 20000
    p = {"D": rng.integers(0, 4, rows), "T": rng.integers(1, 6, rows),
         "up": rng.integers(1, 4, rows), "down": rng.integers(1, 4, rows), "renew": renew}
    t_state = rng.integers(0, 9, rows)
    c0 = {"state": rng.integers(0, 3, rows), "t_state": t_state, "phase": t_state % p["T"],
          "up": rng.integers(0, 5, rows), "down": rng.integers(0, 5, rows)}
    cs = [{k: v.copy() for k, v in c0.items()} for _ in range(2)]
    for _ in range(8):
        req, rel = rng.random(rows) < 0.6, rng.random(rows) < 0.6
        assert np.array_equal(_fsm_step(p, cs[0], req, rel), _fsm_step_flat(p, cs[1], req, rel))
    for k in c0:
        assert np.array_equal(cs[0][k], cs[1][k]), k


def _chunk_np(args, renew, live=None):
    """The chunk's operands as numpy: the block's planes and the per-row ones
    (and the live operands, as tensors)."""
    (block, K, endo, cap, lvpn, lease, cc, b, r, th1, th2, h, D, Tc, uh, dh, cal, fsm, pref,
     t0, hpm) = args
    M = cap.shape[0]
    blk = block.numpy()
    nd = (2 if endo else 1) * K * M
    n = lambda x: x.numpy()
    return {
        "live": live,
        "K": K, "M": M, "t0": t0, "hpm": hpm, "endo": endo,
        "demand": blk[:K * M].reshape(K, M),
        "cci_demand": blk[K * M:nd].reshape(K, M) if endo else None,
        "pre_v": blk[nd:nd + K * M].reshape(K, M), "pre_c": blk[nd + K * M:].reshape(K, M),
        "cap": n(cap), "lvpn": n(lvpn), "lease": n(lease), "cc": n(cc), "b": n(b),
        "r": n(r), "th1": n(th1), "th2": n(th2), "h": n(h).astype(np.int64),
        "p": {"D": n(D).astype(np.int64), "T": n(Tc).astype(np.int64),
              "up": n(uh).astype(np.int64), "down": n(dh).astype(np.int64), "renew": renew},
        "cal": n(cal), "fsm": n(fsm).astype(np.int64), "pref": n(pref),
    }


def _carry(c, rows):
    st, ts, up, dn = (c["fsm"][i, rows] for i in range(4))
    return {"state": st.copy(), "t_state": ts.copy(), "up": up.copy(), "down": dn.copy(),
            "phase": ts % c["p"]["T"][rows]}


def _sub(p, rows):
    return {k: (v[rows] if isinstance(v, np.ndarray) else v) for k, v in p.items()}


def _pack(c, planes, tail, carry, rows_all, h=None):
    out = np.concatenate([planes.reshape(-1, c["M"]), tail])
    fsm = np.stack([carry[k] for k in ("state", "t_state", "up", "down")]).astype(np.int32)
    res = (torch.from_numpy(out), torch.from_numpy(fsm))
    return res if h is None else res + (torch.from_numpy(h),)


def _live_pred(lv, rows, y):
    """The forecast of readouts y: maximum(expm1(y), 0)·scale."""
    e = torch.expm1(torch.from_numpy(np.asarray(y, np.float32)).double()).numpy()
    return np.maximum(e, 0.0) * lv[6].numpy()[rows]


def _live_gates(lv, rows, pred, th1, th2, req, rel):
    """The gates on the predicted mode costs of the forecasts ``pred``."""
    coef, m = lv[7][rows], lv[8].numpy()[rows]
    p_vpn, p_cci = (x[:, 0].numpy() for x in
                    predicted_mode_costs(torch.from_numpy(pred)[:, None], coef, torch.float64))
    with np.errstate(invalid="ignore"):
        req = (p_cci < (th1 - m) * p_vpn) | (req & (p_cci < (th1 + m) * p_vpn))
        rel = (p_cci > (th2 + m) * p_vpn) | (rel & (p_cci > (th2 - m) * p_vpn))
    return req, rel


def _tick_replay(c):
    """``stream_chunk_tick_kernel<K, KT>``: one row's K hours (rows as a
    numpy axis); the kernel runs them in phases across the hours, the same
    adds in the same order on every chain."""
    K, M, t0 = c["K"], c["M"], c["t0"]
    rows = slice(0, M)
    dcum, month = c["cal"][0].copy(), c["cal"][1].copy()
    pv, pc = c["pref"][0].copy(), c["pref"][1].copy()
    fc = _carry(c, rows)
    planes = np.zeros((8, K, M))
    ph = t0 % c["hpm"]
    sv, sc = [], []
    for k in range(K):
        d = np.minimum(c["demand"][k], c["cap"])
        dc = np.minimum(c["cci_demand"][k], c["cap"]) if c["endo"] else d
        if ph == 0:
            month = dcum.copy()
        lo = dcum - month
        dcum = dcum + d
        ph = 0 if ph + 1 == c["hpm"] else ph + 1
        v = c["lvpn"] + _fold(lo, d, c["b"], c["r"])
        cost_c = c["lease"] + c["cc"] * dc
        sv.append(pv)
        sc.append(pc)
        pv, pc = pv + v, pc + cost_c
        lw = np.maximum(0, t0 + k - c["h"]) - t0
        base_v, base_c = c["pre_v"][k].copy(), c["pre_c"][k].copy()
        for j in range(k + 1):
            base_v = np.where(lw == j, sv[j], base_v)
            base_c = np.where(lw == j, sc[j], base_c)
        rv, rc = sv[k] - base_v, sc[k] - base_c
        s = _fsm_step_flat(c["p"], fc, rc < c["th1"] * rv, rc > c["th2"] * rv)
        planes[:, k] = [v, cost_c, rv, rc, sv[k], sc[k], (s == ON).astype(float), s]
    return _pack(c, planes, np.stack([dcum, month, pv, pc]), fc, rows)


class _Sim:
    """Happens-before bookkeeping for one block: each role has a vector
    clock; a write records the writer's epoch, a read must see it."""

    def __init__(self, roles):
        self.vc = {x: {y: 0 for y in roles} for x in roles}
        self.cells = {}

    def write(self, role, key, value):
        self.cells[key] = (role, self.vc[role][role], value)

    def read(self, role, key):
        assert key in self.cells, f"{role} reads {key}, never written"
        writer, epoch, value = self.cells[key]
        assert writer == role or self.vc[role][writer] >= epoch, \
            f"{role} reads {key} written by {writer} without a barrier between"
        return value


LIVE_PASS = _cu_const("stream_chunk.cu", "kLivePass")


def _pipe_block(c, n0, S, rng, early_pref=False, late_pred=False, early_chains=False):
    """``stream_chunk_pipe_kernel<S>`` for the block of rows n0..n0+15, its
    roles run as coroutines in an order ``rng`` picks (in order if None).
    ``early_pref`` breaks the schedule on purpose: the prefix warp hands each
    sub-tile on before it writes the snapshots; (live) ``late_pred`` makes the
    pair threads store their hours' forecasts after the tile's
    ``__syncthreads`` instead of before it, ``early_chains`` makes the chains
    start before the barrier that follows the inputs' stores."""
    K, M, t0 = c["K"], c["M"], c["t0"]
    lv = c["live"]
    R = 16
    tile = SUB_HOURS * S
    rows = slice(n0, min(M, n0 + R))
    nr = rows.stop - rows.start
    roles = [f"pair{j}" for j in range(S)] + ["cal", "pref", "fsm"]
    sim = _Sim(roles)
    out = {}
    n_threads = 32 * (4 * S + 3)
    # the role of thread t: warps 0 .. 4S - 1 the pairs of sub-tile warp // 4,
    # then the calendar, prefix and FSM warps
    role_of = lambda t: f"pair{t // 128}" if t < 128 * S else roles[S + (t - 128 * S) // 32]
    tail = {}
    if lv is not None:   # the forecaster's operands and the block's states
        _, _, a_, oma_, w_, bias_, scale_ = (x.numpy() for x in lv[:7])
        n_states = a_.shape[0]
        h_state = lv[0].numpy()[rows].copy()
        tail["h"] = h_state

    def live_top(me, k0, hrs=(), loaded=None):
        """The live prologue of a tile for role ``me`` (a pair role holds
        ``hrs``): the inputs' stores, the barrier, the role's chains of each
        pass, the barrier, the fold of its hours' terms, the forecasts.
        Returns the forecast carried into the tile (its hour 0's) and each of
        its hours' forecast."""
        ln = min(tile, K - k0)
        carried = None
        if 0 in hrs:
            carried = (lv[1].numpy()[rows] if k0 == 0 else
                       np.array([sim.read(me, ("pred", tile - 1, i)) for i in range(nr)]))
        us = {}
        for k in hrs:
            d = np.minimum(loaded[k][0], c["cap"][rows])
            with np.errstate(invalid="ignore"):
                us[k] = torch.log1p(torch.from_numpy((d / scale_[rows]).astype(np.float32))
                                    ).numpy()
            for i in range(nr):
                sim.write(me, ("u", k, i), us[k][i])
        if not early_chains:
            yield ("sync0",)
        acc = {}
        for s0 in range(0, n_states, LIVE_PASS):
            n_pass = min(LIVE_PASS, n_states - s0)
            for cc in range(R * n_pass):
                cr, s = cc % R, s0 + cc // R
                if cr >= nr or role_of(cc % n_threads) != me:
                    continue
                if k0 > 0:
                    sim.read(me, ("h", s, cr))
                h = np.float32(h_state[cr, s])
                for k in range(ln):
                    u = np.float32(sim.read(me, ("u", k, cr)))
                    h = a_[s] * h + oma_[s] * u
                    sim.write(me, ("term", s - s0, k, cr), (h - u) * w_[s])
                h_state[cr, s] = h
                sim.write(me, ("h", s, cr), h)
            if early_chains and s0 == 0:
                yield ("sync0",)
            yield ("sync0",)
            for k in hrs:
                for q in range(n_pass):
                    t = np.array([sim.read(me, ("term", q, k, i)) for i in range(nr)],
                                 np.float32)
                    acc[k] = t if s0 + q == 0 else acc[k] + t
            if s0 + LIVE_PASS < n_states:
                yield ("sync0",)
        preds = {}
        for k in hrs:
            preds[k] = _live_pred(lv, rows, (us[k] + acc[k]) + bias_)
            out[8, k0 + k] = preds[k]
            if not late_pred:
                for i in range(nr):
                    sim.write(me, ("pred", k, i), preds[k][i])
        return carried, preds

    def pair(j):
        me = f"pair{j}"
        for k0 in range(0, K, tile):
            hrs = [k for k in range(SUB_HOURS * j, SUB_HOURS * (j + 1)) if k < K - k0]
            loaded = {k: (c["demand"][k0 + k, rows],
                          c["cci_demand"][k0 + k, rows] if c["endo"] else None,
                          c["pre_v"][k0 + k, rows].copy(), c["pre_c"][k0 + k, rows].copy())
                      for k in hrs}
            if lv is not None:
                carried, preds = yield from live_top(me, k0, hrs, loaded)
            yield ("sync0",)
            if lv is not None and late_pred:
                for k in hrs:
                    for i in range(nr):
                        sim.write(me, ("pred", k, i), preds[k][i])
            base = {}
            for k in hrs:
                lw = np.maximum(0, t0 + k0 + k - c["h"][rows]) - t0
                bv, bc = loaded[k][2], loaded[k][3]
                for i in np.flatnonzero((lw >= 0) & (lw < k0)):   # an earlier tile's
                    bv[i] = sim.read(me, ("snap_v", int(lw[i]), i))
                    bc[i] = sim.read(me, ("snap_c", int(lw[i]), i))
                base[k] = (lw, bv, bc)
            yield ("wait", j, "lo")
            for k in hrs:
                dv, cv, _, _ = loaded[k]
                d = np.minimum(dv, c["cap"][rows])
                dc = np.minimum(cv, c["cap"][rows]) if c["endo"] else d
                lo = np.array([sim.read(me, ("lo", k, i)) for i in range(nr)])
                v = c["lvpn"][rows] + _fold(lo, d, c["b"][rows], c["r"][rows])
                cost_c = c["lease"][rows] + c["cc"][rows] * dc
                for i in range(nr):
                    sim.write(me, ("vpn", k, i), v[i])
                    sim.write(me, ("cci", k, i), cost_c[i])
                out[0, k0 + k], out[1, k0 + k] = v, cost_c
            yield ("arrive", j, "fold")
            gates = {}
            if lv is not None:   # the forecast carried into each hour, for its gate costs
                for k in hrs:
                    gates[k] = carried if k == 0 else np.array(
                        [sim.read(me, ("pred", k - 1, i)) for i in range(nr)])
            yield ("wait", j, "pref")
            trig = {}
            for k in hrs:
                lw, bv, bc = base[k]
                sv = np.array([sim.read(me, ("sv", k, i)) for i in range(nr)])
                sc = np.array([sim.read(me, ("sc", k, i)) for i in range(nr)])
                in_tile = lw >= k0
                jv = np.array([sim.read(me, ("sv", int(lw[i] - k0), i)) if in_tile[i]
                               else bv[i] for i in range(nr)])
                jc = np.array([sim.read(me, ("sc", int(lw[i] - k0), i)) if in_tile[i]
                               else bc[i] for i in range(nr)])
                rv, rc = sv - jv, sc - jc
                req, rel = rc < c["th1"][rows] * rv, rc > c["th2"][rows] * rv
                if lv is not None:
                    req, rel = _live_gates(lv, rows, gates[k], c["th1"][rows], c["th2"][rows],
                                           req, rel)
                for i in range(nr):
                    sim.write(me, ("trig", k, i), (bool(req[i]), bool(rel[i])))
                    sim.write(me, ("snap_v", k0 + k, i), sv[i])
                    sim.write(me, ("snap_c", k0 + k, i), sc[i])
                out[2, k0 + k], out[3, k0 + k] = rv, rc
                out[4, k0 + k], out[5, k0 + k] = sv, sc
            yield ("arrive", j, "trig")
            yield ("wait", j, "state")
            for k in hrs:
                s = np.array([sim.read(me, ("state", k, i)) for i in range(nr)])
                out[6, k0 + k], out[7, k0 + k] = (s == ON).astype(float), s.astype(float)

    def calendar():
        dcum, month = c["cal"][0, rows].copy(), c["cal"][1, rows].copy()
        ph = t0 % c["hpm"]
        for k0 in range(0, K, tile):
            dv = [c["demand"][k0 + k, rows] for k in range(min(tile, K - k0))]
            if lv is not None:
                yield from live_top("cal", k0)
            yield ("sync0",)
            for j in range(S):
                for k in range(SUB_HOURS * j, SUB_HOURS * (j + 1)):
                    if k < len(dv):
                        if ph == 0:
                            month = dcum.copy()
                        for i in range(nr):
                            sim.write("cal", ("lo", k, i), (dcum - month)[i])
                        dcum = dcum + np.minimum(dv[k], c["cap"][rows])
                        ph = 0 if ph + 1 == c["hpm"] else ph + 1
                yield ("arrive", j, "lo")
        tail["cal"] = (dcum, month)

    def prefixes(me="pref"):
        pv, pc = c["pref"][0, rows].copy(), c["pref"][1, rows].copy()
        for k0 in range(0, K, tile):
            ln = min(tile, K - k0)
            if lv is not None:
                yield from live_top(me, k0)
            yield ("sync0",)
            for j in range(S):
                yield ("wait", j, "fold")
                if early_pref:
                    yield ("arrive", j, "pref")
                for k in range(SUB_HOURS * j, min(SUB_HOURS * (j + 1), ln)):
                    for i in range(nr):
                        sim.write("pref", ("sv", k, i), pv[i])
                        sim.write("pref", ("sc", k, i), pc[i])
                    pv = pv + np.array([sim.read("pref", ("vpn", k, i)) for i in range(nr)])
                    pc = pc + np.array([sim.read("pref", ("cci", k, i)) for i in range(nr)])
                if not early_pref:
                    yield ("arrive", j, "pref")
        tail["pref"] = (pv, pc)

    def fsm_warp(me="fsm"):
        fc = _carry(c, rows)
        p = _sub(c["p"], rows)
        for k0 in range(0, K, tile):
            ln = min(tile, K - k0)
            if lv is not None:
                yield from live_top(me, k0)
            yield ("sync0",)
            for j in range(S):
                yield ("wait", j, "trig")
                for k in range(SUB_HOURS * j, min(SUB_HOURS * (j + 1), ln)):
                    t = [sim.read("fsm", ("trig", k, i)) for i in range(nr)]
                    s = _fsm_step_flat(p, fc, np.array([x[0] for x in t]),
                                       np.array([x[1] for x in t]))
                    for i in range(nr):
                        sim.write("fsm", ("state", k, i), int(s[i]))
                yield ("arrive", j, "state")
        tail["fsm"] = fc

    gens = {f"pair{j}": pair(j) for j in range(S)}
    gens.update({"cal": calendar(), "pref": prefixes(), "fsm": fsm_warp()})
    producer = {"lo": "cal", "fold": None, "pref": "pref", "trig": None, "state": "fsm"}
    chain_of = {"lo": "cal", "fold": "pref", "pref": "pref", "trig": "fsm", "state": "fsm"}
    bars = {}        # (sub, phase) -> {role: clock at arrival}
    sync0 = {}       # role -> clock at arrival
    blocked = {}     # role -> what it waits on
    live = list(gens)

    def complete(key):
        parties = bars.get(key, {})
        return len(parties) == 2

    def step(role):
        try:
            op = next(gens[role])
        except StopIteration:
            live.remove(role)
            return
        if op[0] == "sync0":
            sync0[role] = dict(sim.vc[role])
            blocked[role] = ("sync0",)
        else:
            _, j, phase = op
            assert role in (f"pair{j}", chain_of[phase]), (role, op)
            key = (j, phase)
            parties = bars.setdefault(key, {})
            assert role not in parties, f"{role} at {key} twice before it completed"
            parties[role] = dict(sim.vc[role])
            if op[0] == "wait":
                blocked[role] = ("wait", key)
        sim.vc[role][role] += 1

    while live:
        runnable = []
        for role in live:
            why = blocked.get(role)
            if why is None:
                runnable.append(role)
            elif why[0] == "sync0" and len(sync0) == len(live):
                runnable.append(role)
            elif why[0] == "wait" and complete(why[1]):
                runnable.append(role)
        assert runnable, f"deadlock: {blocked}"
        role = runnable[0] if rng is None else runnable[rng.integers(len(runnable))]
        why = blocked.pop(role, None)
        if why is not None:
            if why[0] == "sync0":
                joined = {}
                for clock in sync0.values():
                    for x, e in clock.items():
                        joined[x] = max(joined.get(x, 0), e)
                for x in sync0:   # everyone leaves the barrier together
                    sim.vc[x] = {y: max(sim.vc[x][y], joined[y]) for y in roles}
                    blocked.pop(x, None)
                sync0.clear()
            else:
                key = why[1]
                for clock in bars[key].values():
                    sim.vc[role] = {y: max(sim.vc[role][y], clock[y]) for y in roles}
                del bars[key]
        step(role)
    assert not bars, f"barriers left open: {list(bars)}"
    return out, tail, rows


def _pipe_replay(c, S, rng, **faults):
    K, M = c["K"], c["M"]
    lv = c["live"]
    planes = np.full((8 if lv is None else 9, K, M), np.nan)
    written = np.zeros((K, M), bool)
    tail = np.zeros((4, M))
    carry = {k: np.zeros(M, np.int64) for k in ("state", "t_state", "up", "down", "phase")}
    h = None if lv is None else np.zeros(tuple(lv[0].shape), np.float32)
    for n0 in range(0, M, 16):
        out, t, rows = _pipe_block(c, n0, S, rng, **faults)
        for (plane, k), v in out.items():
            planes[plane, k, rows] = v
            written[k, rows] |= plane == 7
        tail[0, rows], tail[1, rows] = t["cal"]
        tail[2, rows], tail[3, rows] = t["pref"]
        for k in carry:
            carry[k][rows] = t["fsm"][k]
        if lv is not None:
            h[rows] = t["h"]
    assert written.all()
    return _pack(c, planes, tail, carry, slice(0, M), h)


def _runtime(case: str):
    """A CPU runtime streamed to the case's hour, its demand and CCI demand,
    and the chunk lengths: 37 rows (not a multiple of the 16-row block),
    windows of 1 to 30 hours so that bases fall inside a chunk and in an
    earlier tile of it, and six rows with no provisioning delay."""
    sc = build_fleet_scenario(37, horizon=900, seed=1)
    arrays = sc.fleet.stack(torch.float64, "cpu")
    h = torch.tensor(np.random.default_rng(2).integers(1, 31, 37), dtype=torch.int32)
    D = arrays.toggle.D.clone()
    D[:6] = 0                                # provisioned in the hour it is requested
    arrays = arrays._replace(toggle=arrays.toggle._replace(h=h, D=D))
    demand, cci = sc.demand.copy(), None
    if case == "endogenous":
        cci = demand * 1.5
    if case == "nonfinite":
        demand[5, 712], demand[6, 718], demand[9, 740] = np.nan, np.inf, np.nan
    rt = FleetRuntime(arrays, device="cpu")
    t = 0
    while t < 700:
        rt.step_many(demand[:, t:t + 24],
                     cci_demand_block=None if cci is None else cci[:, t:t + 24])
        t += 24
    return rt, demand, cci, t


def _chunk_args(rt, demand, cci, t, K):
    block, _, endo = rt._pack(demand[:, t:t + K], None if cci is None else cci[:, t:t + K])
    return rt._chunk_args(torch.from_numpy(block), K, endo), endo


PIPE_KS = [1, 2, 5, 8, 9, 16, 17, 23, 24, 25, 31, 50]


@pytest.mark.parametrize("case", ["plain", "endogenous", "nonfinite"])
@pytest.mark.parametrize("K", range(1, TICK_MAX_K + 1))
def test_tick_form_schedule_bit_equal_to_plain(K, case):
    rt, demand, cci, t = _runtime(case)
    args, endo = _chunk_args(rt, demand, cci, t, K)
    renew = rt.policy.renew_in_chunks
    got = _tick_replay(_chunk_np(args, renew))
    want = ref.stream_chunk_ref(*args, renew_in_chunks=renew)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
@pytest.mark.parametrize("K", PIPE_KS)
def test_chunk_form_schedule_bit_equal_to_plain(K, order):
    """Every K runs the sub-tile count launch_form gives it (three past 16
    hours, several tiles past 24), in order and in a random interleaving."""
    rt, demand, cci, t = _runtime("nonfinite" if K in (24, 31) else "plain")
    args, endo = _chunk_args(rt, demand, cci, t, K)
    renew = rt.policy.renew_in_chunks
    S = launch_form(K, args[7].shape[1], "chunk")
    rng = None if order == "in_order" else np.random.default_rng(K)
    got = _pipe_replay(_chunk_np(args, renew), S, rng)
    want = ref.stream_chunk_ref(*args, renew_in_chunks=renew)
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


def test_chunk_form_schedule_endogenous_and_chained():
    """Three chained chunks with CCI demand (K = 24, 7, 30), each from the
    last one's carries, through the chunk form's replay."""
    rt, demand, cci, t = _runtime("endogenous")
    renew = rt.policy.renew_in_chunks
    for K in (24, 7, 30):
        args, endo = _chunk_args(rt, demand, cci, t, K)
        assert endo
        got = _pipe_replay(_chunk_np(args, renew), launch_form(K, 4, "chunk"),
                           np.random.default_rng(K))
        want = ref.stream_chunk_ref(*args, renew_in_chunks=renew)
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
        rt._launch(torch.from_numpy(rt._pack(demand[:, t:t + K], cci[:, t:t + K])[0]), K, True)
        rt._commit(want[0].numpy(), K)
        t += K


def _live_runtime(S: int = 5):
    """_runtime("plain")'s fleet streamed in live mode to hour 700: a
    forecast-gated policy with its coefficients fitted on a 300-hour
    history's series, margins 0, 0.05 and 1e30 by row, and an S-state
    forecaster (a seeded readout) warmed through the clipped history; NaN
    demand in row 3 at hour 705."""
    sc = build_fleet_scenario(37, horizon=900, history_hours=300, seed=1)
    arrays = sc.fleet.stack(torch.float64, "cpu")
    h = torch.tensor(np.random.default_rng(2).integers(1, 31, 37), dtype=torch.int32)
    D = arrays.toggle.D.clone()
    D[:6] = 0
    arrays = arrays._replace(toggle=arrays.toggle._replace(h=h, D=D))
    s = routed_cost_series(arrays, sc.history, hours_per_month=730, device="cpu")
    pol = forecast_gated_policy(arrays.toggle, np.zeros(37), cost_coef=fit_cost_coef(
        s.row_demand, s.vpn, s.cci), margin=np.resize([0.0, 0.05, 1e30], 37))
    rng = np.random.default_rng(3)
    params = dict(demand_forecaster_init(None, S, device="cpu"),
                  w=torch.tensor(0.3 * rng.standard_normal(S), dtype=torch.float32),
                  bias=torch.tensor(0.05, dtype=torch.float32))
    cap = arrays.capacity.numpy()[:, None]
    fc = StreamingForecaster.from_history(params, np.minimum(sc.history, cap), device="cpu")
    rt = FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu")
    demand = sc.demand.copy()
    demand[3, 705] = np.nan
    for t in range(0, 700, 24):
        rt.step_many(demand[:, t:t + 24])
    return rt, demand, 696


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
@pytest.mark.parametrize("K", [1, 8, 9, 17, 24, 25])
def test_chunk_form_live_schedule_bit_equal_to_plain(K, order):
    """The live instance's chunk form: the forecaster lanes' readouts reach
    the pair threads through the lo barrier (and a tile's slot 0 through the
    tile's __syncthreads); every output bit, the forecasts and the state
    after the chunk equal stream_chunk_ref with the same live operands."""
    rt, demand, t = _live_runtime()
    args, endo = _chunk_args(rt, demand, None, t, K)
    st = rt._state
    live = (st.ssm_h, st.pred_live, *rt._live)
    renew = rt.policy.renew_in_chunks
    rng = None if order == "in_order" else np.random.default_rng(K)
    got = _pipe_replay(_chunk_np(args, renew, live), launch_form(K, 4, "chunk", True), rng)
    want = ref.stream_chunk_ref(*args, renew_in_chunks=renew, live=live)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("K", [9, 24, 25])
@pytest.mark.parametrize("S", [LIVE_PASS + 1, 2 * LIVE_PASS + 1])
def test_chunk_form_live_schedule_over_passes(S, K):
    """More states than a pass holds (17 and 33: two and three passes, the
    running sums carried across them in the pair threads), shuffled: every
    output bit, the forecasts and the state equal stream_chunk_ref."""
    rt, demand, t = _live_runtime(S)
    args, endo = _chunk_args(rt, demand, None, t, K)
    st = rt._state
    live = (st.ssm_h, st.pred_live, *rt._live)
    assert st.ssm_h.shape[1] == S
    renew = rt.policy.renew_in_chunks
    got = _pipe_replay(_chunk_np(args, renew, live), launch_form(K, 4, "chunk", True),
                       np.random.default_rng(S + K))
    want = ref.stream_chunk_ref(*args, renew_in_chunks=renew, live=live)
    assert all(_same_bits(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
def test_chunk_form_live_replay_catches_late_readouts(order):
    """Pair threads that store their hours' forecasts after the tile's
    __syncthreads (not before it) are caught: the next sub-tile's first hour
    reads its carried forecast without a barrier between."""
    rt, demand, t = _live_runtime()
    args, _ = _chunk_args(rt, demand, None, t, 24)
    st = rt._state
    c = _chunk_np(args, rt.policy.renew_in_chunks, (st.ssm_h, st.pred_live, *rt._live))
    rng = None if order == "in_order" else np.random.default_rng(0)
    with pytest.raises(AssertionError, match="never written|without a barrier"):
        _pipe_replay(c, 3, rng, late_pred=True)


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
def test_chunk_form_live_replay_catches_chains_before_the_inputs(order):
    """Chains that start before the barrier behind the pair threads' input
    stores are caught: a chain reads another role's input unordered."""
    rt, demand, t = _live_runtime()
    args, _ = _chunk_args(rt, demand, None, t, 24)
    st = rt._state
    c = _chunk_np(args, rt.policy.renew_in_chunks, (st.ssm_h, st.pred_live, *rt._live))
    rng = None if order == "in_order" else np.random.default_rng(1)
    with pytest.raises(AssertionError, match="never written|without a barrier"):
        _pipe_replay(c, 3, rng, early_chains=True)


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
def test_chunk_form_replay_catches_a_missing_barrier(order):
    """The replay's bookkeeping is live: a prefix warp that hands a sub-tile
    to the pairs before it has written its snapshots is caught."""
    rt, demand, cci, t = _runtime("plain")
    args, _ = _chunk_args(rt, demand, cci, t, 24)
    c = _chunk_np(args, rt.policy.renew_in_chunks)
    rng = None if order == "in_order" else np.random.default_rng(0)
    with pytest.raises(AssertionError, match="never written|without a barrier"):
        _pipe_replay(c, 3, rng, early_pref=True)


# -- stream_chunk_routed's schedule --------------------------------------------

R_TILE = _cu_const("stream_chunk_routed.cu", "kTile")
R_PASS = _cu_const("stream_chunk_routed.cu", "kPassStates")
R_THREADS = _cu_const("stream_chunk_routed.cu", "kThreads")
R_LEGS = _cu_const("stream_chunk_routed.cu", "kLegTile")
R_WARPS = R_THREADS // 32
R_FAULTS = ("stage_sync", "cost_arrive", "tables")


def _fold_minmax(lo, d, b, r):
    """tier_fold.cuh's fold_staged4 over rows: fmin/fmax terms (the
    padding tiers add nothing) added left to right from +0.0, and +0.0
    where hi = lo + d is NaN."""
    hi = lo + d
    acc = np.zeros_like(lo)
    prev = np.zeros_like(lo)
    with np.errstate(invalid="ignore"):
        for t in range(b.shape[1]):
            seg = np.fmin(hi, b[:, t]) - np.fmax(lo, prev)
            acc = acc + np.where(seg > 0, seg * r[:, t], 0)
            prev = b[:, t]
    return np.where(np.isnan(hi), 0.0, acc)


def _min_sel(a, b):
    """tier_fold.cuh's min_sel: NaN if either operand is (a first), else the
    smaller, a on a tie."""
    with np.errstate(invalid="ignore"):
        return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.where(b < a, b, a)))


class _Cells:
    """Happens-before bookkeeping for one block's warps, cell by cell: each
    warp has a vector clock; a write records the writer and its epoch, and a
    read must see it, its own warp's write or another's through a barrier."""

    def __init__(self, n):
        self.vc = np.zeros((n, n), np.int64)
        self.meta = {}

    def write(self, w, name, idx, shape):
        if name not in self.meta:
            self.meta[name] = (np.full(shape, -1), np.zeros(shape, np.int64))
        writer, epoch = self.meta[name]
        writer[idx], epoch[idx] = w, self.vc[w, w]

    def read(self, w, name, idx):
        assert name in self.meta, f"warp {w} reads {name}, never written"
        writer, epoch = self.meta[name]
        wr, ep = np.broadcast_arrays(writer[idx], epoch[idx])
        assert (wr >= 0).all(), f"warp {w} reads {name}, never written"
        seen = (wr == w) | (self.vc[w][np.maximum(wr, 0)] >= ep)
        assert seen.all(), (f"warp {w} reads {name} written by another warp without a "
                            f"barrier between")


def _run_block(cells, gens, rng):
    """Run a block's warps, generators that yield ("sync",) (__syncthreads),
    ("arrive", bar) and ("wait", bar) (a named barrier's bar.arrive and
    bar.sync), in an order ``rng`` picks (in order if None)."""
    live, blocked, at_sync, arrived = dict(gens), {}, {}, {}
    while live:
        runnable = [w for w in live if w not in blocked
                    or (blocked[w][0] == "sync" and len(at_sync) == len(live))
                    or (blocked[w][0] == "wait" and blocked[w][1] in arrived)]
        assert runnable, f"deadlock: {blocked}"
        w = runnable[0] if rng is None else runnable[rng.integers(len(runnable))]
        op = blocked.pop(w, None)
        if op is not None and op[0] == "sync":         # everyone leaves the barrier together
            joined = np.max(list(at_sync.values()), axis=0)   # the clocks they arrived with
            for x in at_sync:
                cells.vc[x] = np.maximum(cells.vc[x], joined)
                blocked.pop(x, None)
            at_sync.clear()
        elif op is not None:
            cells.vc[w] = np.maximum(cells.vc[w], arrived.pop(op[1]))
        try:
            op = next(live[w])
        except StopIteration:
            del live[w]
            continue
        if op[0] == "sync":
            at_sync[w] = cells.vc[w].copy()
            blocked[w] = op
        elif op[0] == "arrive":
            assert op[1] not in arrived, f"{op[1]} arrived twice"
            arrived[op[1]] = cells.vc[w].copy()
        else:
            blocked[w] = op
        cells.vc[w, w] += 1
    assert not arrived, f"barriers left open: {list(arrived)}"


def _routed_np(args, renew, gate=None, live=None):
    """The routed chunk's operands as numpy (the live ones as tensors)."""
    (block, K, endo, pcap, lvpn, b, r, lease, cc, portcap, th1, th2, h, D, Tc, uh, dh,
     routing, cal, fsm, pref, t0, hpm) = args
    P, M = pcap.shape[0], lease.shape[0]
    blk = block.numpy()
    nd = (2 if endo else 1) * K * P
    n = lambda x: x.numpy()
    idx = routing.index
    return {
        "K": K, "P": P, "M": M, "E": routing.n_legs, "t0": t0, "hpm": hpm, "endo": endo,
        "demand": blk[:K * P].reshape(P, K).T,          # pair-major in the block
        "cci_demand": blk[K * P:nd].reshape(P, K).T if endo else None,
        "pre_v": blk[nd:nd + K * M].reshape(K, M), "pre_c": blk[nd + K * M:].reshape(K, M),
        "pcap": n(pcap), "lvpn": n(lvpn), "b": n(b), "r": n(r), "lease": n(lease), "cc": n(cc),
        "portcap": n(portcap), "th1": n(th1), "th2": n(th2), "h": n(h).astype(np.int64),
        "p": {"D": n(D).astype(np.int64), "T": n(Tc).astype(np.int64),
              "up": n(uh).astype(np.int64), "down": n(dh).astype(np.int64), "renew": renew},
        "lp": n(idx.leg_pair_pm).astype(np.int64), "vw": n(idx.vpn_w_pm),
        "aw": n(idx.attach_w_pm), "start": n(idx.start).astype(np.int64),
        "cal": n(cal), "fsm": n(fsm).astype(np.int64), "pref": n(pref),
        "gate": gate, "live": live,
    }


def _routed_calendar(c):
    """The calendars of the blocks' slices of the pairs (block b of max(M,
    1): pairs [b S, (b + 1) S), S = ceil(P / blocks)), a lane a pair over
    the whole chunk. Returns the carry and how many times each pair's was
    written."""
    P = c["P"]
    nblocks = max(c["M"], 1)
    S = -(-P // nblocks)
    out = np.zeros((2, P))
    writes = np.zeros(P, np.int64)
    for b in range(nblocks):
        n = np.arange(b * S, min(P, (b + 1) * S))
        dcum, month = c["cal"][0, n].copy(), c["cal"][1, n].copy()
        ph = c["t0"] % c["hpm"]
        for k in range(c["K"]):
            d = _min_sel(c["demand"][k, n], c["pcap"][n])
            if ph == 0:
                month = dcum.copy()
            dcum = dcum + d
            ph = 0 if ph + 1 == c["hpm"] else ph + 1
        out[0, n], out[1, n] = dcum, month
        writes[n] += 1
    return out, writes


def _routed_port(c, m, leg_cal, rng, fault=None):
    """``routed_chunk_kernel`` for port m: its warps as coroutines in
    an order ``rng`` picks, every shared-memory read checked to follow its
    write through the block's barriers. ``fault`` plants a fault: no
    __syncthreads between the legs' calendars and the tier fold
    ("stage_sync"), warp 1 arriving on the cost barrier before it writes
    the CCI plane ("cost_arrive"), a leg's tier rows staged from the next
    leg's pair ("tables"). Returns the port's planes, prefixes, FSM carry
    and forecaster state."""
    K, t0, hpm, endo = c["K"], c["t0"], c["hpm"], c["endo"]
    gate, lv = c["gate"], c["live"]
    e0, e1 = int(c["start"][m]), int(c["start"][m + 1])
    Kt = c["b"].shape[1]
    LT = R_LEGS
    cells = _Cells(R_WARPS)
    sh = (LT, R_TILE)
    Dp, LOp, Cp = np.zeros(sh), np.zeros(sh), np.zeros(sh)
    tb, tr = np.zeros((LT, Kt)), np.zeros((LT, Kt))
    lvpn, wv, wa = np.zeros(LT), np.zeros(LT), np.zeros(LT)
    sm = {k: np.zeros(R_TILE) for k in ("v", "c", "sv", "sc", "gv", "gc")}
    planes = np.full((9 if lv is not None else 8, K), np.nan)
    res = {}

    lp = np.zeros(LT, np.int64)
    pcap = np.zeros(LT)
    carry = {}

    def stage(w, s0, js, k0):
        """Threads js: their legs' descriptors, and their pairs' scalars."""
        pos = s0 + js
        lp[js] = c["lp"][pos]
        wv[js], wa[js] = c["vw"][pos], c["aw"][pos]
        for name in ("lp", "wv", "wa"):
            cells.write(w, name, js, (LT,))
        pr = lp[js]
        if k0 == 0:
            carry[w] = (c["cal"][0, pr].copy(), c["cal"][1, pr].copy())
        else:                                  # this thread's own store
            carry[w] = (leg_cal[0, pos].copy(), leg_cal[1, pos].copy())
        lvpn[js], pcap[js] = c["lvpn"][pr], c["pcap"][pr]
        for name in ("lvpn", "pcap"):          # written before the gather's barrier
            cells.write(w, name, js, (LT,))

    def gather(w, tids, nl, k0, ln):
        """Every thread: (leg, hour) demand copies and (leg, tier) table
        copies into shared memory."""
        o = np.concatenate([np.arange(t, nl * ln, R_THREADS) for t in tids])
        ls, ks = o // ln, o % ln
        if len(o):
            cells.read(w, "lp", ls)
            Dp[ls, ks] = c["demand"][k0 + ks, lp[ls]]
            cells.write(w, "D", (ls, ks), sh)
            if endo:
                Cp[ls, ks] = c["cci_demand"][k0 + ks, lp[ls]]
                cells.write(w, "C", (ls, ks), sh)
        o = np.concatenate([np.arange(t, nl, R_THREADS) for t in tids])
        if len(o):                             # a table row a leg (its tiers' copies)
            cells.read(w, "lp", o)
            pt = lp[(o + 1) % nl] if fault == "tables" else lp[o]
            tb[o], tr[o] = c["b"][pt], c["r"][pt]
            cells.write(w, "tab", o, (LT,))

    def clip(w, tids, nl, ln):
        """Every thread, a (leg, hour) at a time: the demand planes clipped
        at the pairs' capacities."""
        o = np.concatenate([np.arange(t, nl * ln, R_THREADS) for t in tids])
        ls, ks = o // ln, o % ln
        if len(o):
            cells.read(w, "pcap", ls)
            for name, plane in (("D", Dp),) + ((("C", Cp),) if endo else ()):
                cells.read(w, name, (ls, ks))
                plane[ls, ks] = _min_sel(plane[ls, ks], pcap[ls])
                cells.write(w, name, (ls, ks), sh)

    def calendar(w, s0, js, k0, ln):
        """Threads js: their pairs' calendars over the hour tile."""
        dcum, month = carry.pop(w)
        rows = (js[:, None], np.arange(ln)[None, :])
        cells.read(w, "D", rows)
        ph = (t0 + k0) % hpm
        for kk in range(ln):
            d = Dp[js, kk]
            if ph == 0:
                month = dcum.copy()
            LOp[js, kk] = dcum - month
            dcum = dcum + d
            ph = 0 if ph + 1 == hpm else ph + 1
        if k0 + ln < K:
            leg_cal[0, s0 + js], leg_cal[1, s0 + js] = dcum, month
        cells.write(w, "LO", rows, sh)

    def warp(w):
        tids = np.arange(32 * w, 32 * w + 32)
        if w == 0:
            pv, pc = c["pref"][0, m], c["pref"][1, m]
            fc = {"state": c["fsm"][0, m:m + 1].copy(), "t_state": c["fsm"][1, m:m + 1].copy(),
                  "up": c["fsm"][2, m:m + 1].copy(), "down": c["fsm"][3, m:m + 1].copy()}
            p = {k: (v[m:m + 1] if isinstance(v, np.ndarray) else v) for k, v in c["p"].items()}
            fc["phase"] = fc["t_state"] % p["T"]
        if w == 1 and lv is not None:
            hs = lv[0].numpy()[m].copy()
            pred_c = float(lv[1].numpy()[m])
            a_, oma_, w_ = (x.numpy() for x in lv[2:5])
            bias, scale = np.float32(lv[5].numpy()), lv[6].numpy()[m]
        for k0 in range(0, K, R_TILE):
            ln = min(R_TILE, K - k0)
            hrs = np.arange(ln)
            k = k0 + hrs
            if k0 > 0:
                yield ("sync",)
            if w == 0:
                lw = np.maximum(0, t0 + k - c["h"][m])
                bv, bc = np.zeros(ln), np.zeros(ln)
                old = lw < t0
                bv[old], bc[old] = c["pre_v"][k[old], m], c["pre_c"][k[old], m]
                snap = ~old & (lw < t0 + k0)            # an earlier tile's snapshot
                if snap.any():
                    cells.read(0, "snap", lw[snap] - t0)
                    bv[snap], bc[snap] = planes[4, lw[snap] - t0], planes[5, lw[snap] - t0]
            acc, acc_d = np.zeros(ln), np.zeros(ln)
            for s0 in range(e0, e1, R_LEGS):
                nl = min(R_LEGS, e1 - s0)
                if s0 > e0:
                    yield ("sync",)
                js = tids[tids < nl]                 # warps 0.. stage a leg a thread
                if len(js):
                    stage(w, s0, js, k0)
                yield ("sync",)
                gather(w, tids, nl, k0, ln)
                yield ("sync",)
                clip(w, tids, nl, ln)
                yield ("sync",)
                if len(js):
                    calendar(w, s0, js, k0, ln)
                if fault != "stage_sync":
                    yield ("sync",)
                # one (leg, hour) a thread at a time: the fold, then the
                # legs' products in place
                o = np.concatenate([np.arange(t, nl * ln, R_THREADS) for t in tids])
                ls, ks = o // ln, o % ln
                if len(o):
                    for name in ("LO", "D") + (("C",) if endo else ()):
                        cells.read(w, name, (ls, ks))
                    for name in ("tab", "lvpn", "wv", "wa"):
                        cells.read(w, name, ls)
                    v = lvpn[ls] + _fold_minmax(LOp[ls, ks], Dp[ls, ks], tb[ls], tr[ls])
                    LOp[ls, ks] = v * wv[ls]
                    if endo:
                        Cp[ls, ks] = Cp[ls, ks] * wa[ls]
                        if lv is not None:
                            Dp[ls, ks] = Dp[ls, ks] * wa[ls]
                    else:
                        Dp[ls, ks] = Dp[ls, ks] * wa[ls]
                    for name in ("LO", "D") + (("C",) if endo else ()):
                        cells.write(w, name, (ls, ks), sh)
                yield ("sync",)
                if w in (0, 1):
                    plane, name = ((LOp, "LO") if w == 0 else (Cp, "C") if endo else (Dp, "D"))
                    cells.read(w, name, (slice(0, nl), slice(0, ln)))
                    if w == 1 and lv is not None and endo:
                        cells.read(w, "D", (slice(0, nl), slice(0, ln)))
                    for l in range(nl):
                        acc = acc + plane[l, :ln]
                        if w == 1 and lv is not None and endo:
                            acc_d = acc_d + Dp[l, :ln]
            if w == 1:
                bill = _min_sel(acc, c["portcap"][m])
                cost = c["lease"][m] + c["cc"][m] * bill
                if fault == "cost_arrive":
                    yield ("arrive", ("cost", k0))
                sm["c"][:ln] = cost
                cells.write(1, "c", hrs, (R_TILE,))
                planes[1, k] = cost
                if fault != "cost_arrive":
                    yield ("arrive", ("cost", k0))
                if lv is not None:
                    drow = _min_sel(acc_d, c["portcap"][m]) if endo else bill
                    with np.errstate(invalid="ignore"):
                        u = torch.log1p(torch.from_numpy((drow / scale).astype(np.float32))).numpy()
                    terms = np.zeros((len(hs), ln), np.float32)
                    for j in range(ln):                  # lane s % 32, pass s // 32
                        hs[:] = a_ * hs + oma_ * u[j]
                        terms[:, j] = (hs - u[j]) * w_
                    acc_y = terms[0].copy()
                    for s in range(1, len(hs)):
                        acc_y = acc_y + terms[s]
                    y = (u + acc_y) + bias
                    e = torch.expm1(torch.from_numpy(y).double()).numpy()
                    pred = np.maximum(e, 0.0) * scale
                    planes[8, k] = pred
                    before = np.concatenate([[pred_c], pred[:-1]])
                    coef = lv[7][m:m + 1]
                    gv, gc = (x[0].numpy() for x in
                              predicted_mode_costs(torch.from_numpy(before)[None], coef,
                                                   torch.float64))
                    sm["gv"][:ln], sm["gc"][:ln] = gv, gc
                    cells.write(1, "g", hrs, (R_TILE,))
                    pred_c = pred[-1]
                    yield ("arrive", ("gate", k0))
            elif w == 0:
                sm["v"][:ln] = acc
                cells.write(0, "v", hrs, (R_TILE,))
                planes[0, k] = acc
                yield ("wait", ("cost", k0))
                cells.read(0, "v", hrs)
                cells.read(0, "c", hrs)
                for j in range(ln):                      # lane 0: the cost prefixes
                    sm["sv"][j], sm["sc"][j] = pv, pc
                    pv, pc = pv + sm["v"][j], pc + sm["c"][j]
                in_tile = lw >= t0 + k0
                jb = np.where(in_tile, lw - t0 - k0, 0)
                sv, sc = sm["sv"][:ln].copy(), sm["sc"][:ln].copy()
                rv = sv - np.where(in_tile, sm["sv"][jb], bv)
                rc = sc - np.where(in_tile, sm["sc"][jb], bc)
                with np.errstate(invalid="ignore"):
                    req, rel = rc < c["th1"][m] * rv, rc > c["th2"][m] * rv
                if gate is not None:
                    rows = np.minimum(t0 + k, int(gate[3]) - 1)
                    req, rel = _gate_np(c, m, gate[2].numpy()[m], gate[0].numpy()[rows, m],
                                        gate[1].numpy()[rows, m], req, rel)
                if lv is not None:
                    yield ("wait", ("gate", k0))
                    cells.read(0, "g", hrs)
                    req, rel = _gate_np(c, m, lv[8].numpy()[m], sm["gv"][:ln], sm["gc"][:ln],
                                        req, rel)
                for j in range(ln):                      # lane 0: the FSM
                    s = _fsm_step_flat(p, fc, req[j:j + 1], rel[j:j + 1])[0]
                    planes[6, k0 + j], planes[7, k0 + j] = float(s == ON), float(s)
                planes[2, k], planes[3, k], planes[4, k], planes[5, k] = rv, rc, sv, sc
                cells.write(0, "snap", k, (K,))
        if w == 0:
            res["pref"], res["fsm"] = (pv, pc), fc
        if w == 1 and lv is not None:
            res["h"] = hs

    _run_block(cells, {w: warp(w) for w in range(R_WARPS)}, rng)
    return planes, res


def _gate_np(c, m, margin, p_vpn, p_cci, req, rel):
    """fsm_step.cuh's fsm_gate and fsm_gated_triggers for port m."""
    t1, t2 = c["th1"][m], c["th2"][m]
    with np.errstate(invalid="ignore"):
        req = (p_cci < (t1 - margin) * p_vpn) | (req & (p_cci < (t1 + margin) * p_vpn))
        rel = (p_cci > (t2 + margin) * p_vpn) | (rel & (p_cci > (t2 - margin) * p_vpn))
    return req, rel


def _routed_replay(c, rng, fault=None):
    """The whole launch: the port blocks, then the calendar blocks; packed
    as the wrapper returns it. Checks that every pair's calendar carry is
    written exactly once."""
    K, P, M = c["K"], c["P"], c["M"]
    lv = c["live"]
    leg_cal = np.full((2, c["E"]), np.nan)
    planes = np.zeros((9 if lv is not None else 8, K, M))
    pref = np.zeros((2, M))
    carry = np.zeros((4, M), np.int32)
    h = None if lv is None else np.zeros(tuple(lv[0].shape), np.float32)
    for m in range(M):
        pl, res = _routed_port(c, m, leg_cal, rng, fault)
        planes[:, :, m] = pl
        pref[:, m] = res["pref"]
        carry[:, m] = [res["fsm"][k][0] for k in ("state", "t_state", "up", "down")]
        if lv is not None:
            h[m] = res["h"]
    cal_out, writes = _routed_calendar(c)
    assert (writes == 1).all()
    flat = np.concatenate([planes.reshape(-1), cal_out.reshape(-1), pref.reshape(-1)])
    out = (torch.from_numpy(flat), torch.from_numpy(carry))
    return out if h is None else out + (torch.from_numpy(h),)


def _routed_scenario(name, pad, hpm):
    """(scenario, spec with ``hpm`` hours a month, routing padded by ``pad``
    legs) of the replay's cases."""
    sc = {"relay": lambda: build_relay_scenario(horizon=200, seed=0),
          "multicast": lambda: build_multicast_scenario(n_leaves=3, horizon=200, seed=0),
          # 64 pairs on 32 ports, 19 of them without legs
          "topology": lambda: build_topology_scenario(64, n_facilities=8, ports_per_facility=4,
                                                      horizon=900, seed=0),
          # 200 or 400 pairs on 4 ports: the hottest port holds 76 or 165 legs
          "hot-port": lambda: build_topology_scenario(200, n_facilities=2, ports_per_facility=2,
                                                      horizon=200, seed=0),
          "hotter-port": lambda: build_topology_scenario(400, n_facilities=2,
                                                         ports_per_facility=2, horizon=200,
                                                         seed=0)}[name]()
    topo = dataclasses.replace(sc.topo, hours_per_month=hpm)
    r = optimize_routing(topo, sc.demand)
    return sc, topo, r.pad_to(r.n_legs + pad)


def _routed_policy(topo, r, mode, seed):
    """A per-port forecast-gated policy (margins 0, 0.05, 0.15 and 1e30 by
    port; NaN predictions of port 3 from hour 60) and, live, a four-state
    forecaster warmed through a seeded port history; (None, None) reactive."""
    if mode == "reactive":
        return None, None
    M = topo.n_ports
    rng = np.random.default_rng(seed)
    pred = np.repeat(rng.uniform(0.0, 3000.0, (M, 60)), 24, axis=1)[:, :1200]
    pred = pred * rng.uniform(0.8, 1.2, pred.shape)
    pred[3 % M, 60:] = np.nan
    a_v, b_v = np.log(rng.uniform(5.0, 50.0, M)), rng.uniform(0.1, 0.5, M)
    coef = np.stack([a_v, b_v, a_v + rng.normal(0, 0.2, M), b_v + rng.normal(0, 0.05, M)], 1)
    T_pred = 600 if mode == "replay" else 2
    pol = forecast_gated_policy(topo.stack(r, torch.float64, "cpu").toggle, pred[:, :T_pred],
                                margin=np.resize([0.0, 0.05, 0.15, 1e30], M), cost_coef=coef)
    if mode == "replay":
        return pol, None
    S = R_PASS + 8 if mode == "live-two-passes" else 4
    params = dict(demand_forecaster_init(None, S, device="cpu"),
                  w=torch.tensor(0.3 * rng.standard_normal(S), dtype=torch.float32),
                  bias=torch.tensor(0.05, dtype=torch.float32))
    hist = rng.uniform(0.0, 800.0, (M, 96)) * rng.uniform(0, 1, (M, 1))
    return pol, StreamingForecaster.from_history(params, hist, device="cpu")


ROUTED_CASES = {  # scenario, pad, month, first hour, Ks, endogenous, NaN pair-0 hours, mode
    "relay-padded": ("relay", 3, 730, 48, [24, 24], False, (), "reactive"),
    "multicast-k1": ("multicast", 0, 730, 24, [24, 1], False, (), "reactive"),
    "nan-pair0-padded": ("topology", 4, 730, 48, [24, 5], False, (40, 51, 58), "reactive"),
    "month-start-mid-chunk": ("topology", 0, 730, 720, [24, 1], False, (), "reactive"),
    "k33-k360-endogenous": ("topology", 0, 730, 480, [33, 360], True, (), "reactive"),
    "hot-76-legs": ("hot-port", 0, 730, 48, [24, 1, 33], False, (), "reactive"),
    "hot-165-legs": ("hotter-port", 0, 730, 48, [24, 1, 33], False, (), "reactive"),
    "gated-nan-pair0": ("topology", 4, 730, 48, [24, 1], False, (40, 51), "replay"),
    "gated-past-T_pred-endogenous": ("topology", 0, 730, 576, [33], True, (), "replay"),
    "gated-hot-165-legs": ("hotter-port", 0, 730, 48, [33], False, (), "replay"),
    "live-month-start": ("topology", 0, 730, 720, [24, 1], False, (), "live"),
    "live-endogenous-nan": ("topology", 4, 730, 48, [24, 33], True, (50, 60), "live"),
    "live-hot-165-legs": ("hotter-port", 0, 730, 48, [24, 5], False, (), "live"),
    "live-40-states": ("topology", 0, 730, 48, [24, 33], True, (), "live-two-passes"),
}


def _routed_runtime(case):
    """The case's CPU runtime streamed to its first hour, and its demand
    and CCI demand."""
    name, pad, hpm, t_first, _, endo, nan_hours, mode = ROUTED_CASES[case]
    sc, topo, r = _routed_scenario(name, pad, hpm)
    pol, fc = _routed_policy(topo, r, mode, len(case))
    rt = FleetRuntime(topo, routing=r, policy=pol, forecaster=fc, device="cpu")
    demand = sc.demand.copy()
    demand[0, list(nan_hours)] = np.nan
    cci = demand * 1.5 if endo else None
    t = 0
    while t < t_first:
        k = min(24, t_first - t)
        rt.step_many(demand[:, t:t + k], cci_demand_block=None if cci is None else cci[:, t:t + k])
        t += k
    return rt, demand, cci, t


def _routed_chunks(case, fault=None):
    """Each of the case's chunks through the replay, in a random
    interleaving, beside the plain version: yields (got, want)."""
    rt, demand, cci, t = _routed_runtime(case)
    rng = np.random.default_rng(len(case))
    for K in ROUTED_CASES[case][4]:
        cblk = None if cci is None else cci[:, t:t + K]
        block, _, endo = rt._pack(demand[:, t:t + K], cblk)
        args = rt._chunk_args(torch.from_numpy(block), K, endo)
        st = rt._state
        live = None if rt._live is None else (st.ssm_h, st.pred_live, *rt._live)
        kw = dict(renew_in_chunks=rt.policy.renew_in_chunks, gate=rt._gate, live=live)
        want = ref.stream_chunk_routed_ref(*args, **kw)
        got = _routed_replay(_routed_np(args, kw["renew_in_chunks"], rt._gate, live), rng, fault)
        yield got, want
        rt.step_many(demand[:, t:t + K], cci_demand_block=cblk)
        t += K


@pytest.mark.parametrize("case", sorted(ROUTED_CASES))
def test_routed_chunk_schedule_bit_equal_to_plain(case):
    """stream_chunk_routed's one launch, replayed: the port blocks' warps
    (legs staged and priced a thread a leg, the tier fold over every
    thread, the leg sums, the port half handed from warp 1 to warp 0 on
    named barriers) in random interleavings, and the calendar blocks, each
    pair's carry written once; every output bit, the FSM carry and the
    forecaster's state equal stream_chunk_routed_ref's: reactive, gated and
    live, padding legs under a NaN in pair 0, ports with no legs, 76- and
    165-leg ports, K = 1, 5, 24, 33 and 360, a month start inside a chunk,
    endogenous CCI demand."""
    for got, want in _routed_chunks(case):
        assert len(got) == len(want)
        assert all(_same_bits(g, w) for g, w in zip(got, want))


def test_routed_replay_cases_cover_the_edges():
    """The cases hold what the replay is asked to cover: a port without
    legs, a port past one leg tile, a port of 76 legs, padding legs on pair
    0, and chunks past one hour tile."""
    legs = {}
    for case in ("nan-pair0-padded", "hot-76-legs", "hot-165-legs"):
        rt = _routed_runtime(case)[0]
        idx = rt.arrays.routing.index
        legs[case] = np.diff(idx.start.numpy())
    assert legs["nan-pair0-padded"].min() == 0
    assert legs["hot-76-legs"].max() == 76
    assert legs["hot-165-legs"].max() == 165 > R_LEGS
    op = _routed_runtime("nan-pair0-padded")[0].arrays.routing
    assert (op.attach_w.numpy() == 0).sum() == 4 and op.leg_pair.numpy()[-1] == 0
    assert max(max(v[4]) for v in ROUTED_CASES.values()) > R_TILE
    fc = _routed_runtime("live-40-states")[0]._live
    assert fc[0].shape[0] > R_PASS                   # the forecaster takes two passes


@pytest.mark.parametrize("fault", ["stage_sync", "cost_arrive"])
def test_routed_replay_catches_a_missing_barrier(fault):
    """The replay's bookkeeping is live: with no __syncthreads between the
    legs' calendars and the tier fold, or warp 1 arriving on the cost
    barrier before it writes the CCI plane, a read is caught."""
    with pytest.raises(AssertionError, match="never written|without a barrier"):
        for _ in _routed_chunks("relay-padded", fault):
            pass


def test_routed_replay_catches_another_pairs_tier_rows():
    """A leg priced from the next leg's pair's tier rows changes bits: the
    replay then differs from the plain version."""
    got, want = next(_routed_chunks("nan-pair0-padded", "tables"))
    assert not _same_bits(got[0], want[0])


# -- the forecaster's backward pass -------------------------------------------------

def _cu_ring(source: str) -> int:
    """The ring depth, ``kRing = kAhead + 2`` (two tiles in use)."""
    assert "constexpr int kRing = kAhead + 2;" in (CSRC / source).read_text()
    return _cu_const(source, "kAhead") + 2


F_CHAINS = _cu_const("forecaster_scan.cu", "kChainThreads")
F_READERS = _cu_const("forecaster_scan.cu", "kReadThreads")
F_TILE = _cu_const("forecaster_scan.cu", "kTile")
F_AHEAD = _cu_const("forecaster_scan.cu", "kAhead")
F_FAULTS = ("one_buffer", "short_ring", "same_step")


def _fwd_replay(u, a, oma, w, bias, h0, rng, *, write_y=True, fault=None, ckpt_at_end=False):
    """``forecaster_scan_kernel<S, WRITE_Y>`` (S <= FAST_STATE) in numpy
    float32: blocks of ``R = kChainThreads // S`` rows, each run as its warp
    roles in an order ``rng`` picks (in order if None) that meet at the one
    ``__syncthreads`` of each step j: the chain warps walk tile j from its
    ring slot (storing each chain's state at the tile's start, the
    checkpoint) and store each hour's product ``(h_s - u) w_s`` into the
    buffer of tile j's parity; the readout warps fold tile j - 1 from the
    other buffer and its slot, each (row, hour)'s S products left from state
    0; the producer warp stages tile ``j + kAhead`` of u into its slot after
    the barrier and waits for tile j + 1 before the next. Every read must follow its
    write through a barrier (``_Cells``) and find the tile it expects in the
    slot or buffer. ``fault`` breaks the schedule on purpose: ``one_buffer``
    (one state buffer), ``short_ring`` (a ring of ``kAhead + 1`` slots),
    ``same_step`` (the readout folds the tile the chains walk in the same
    step); ``ckpt_at_end`` stores each checkpoint after its tile. Returns
    ``(y or None, h, ckpt)``."""
    N, T = u.shape
    S = a.shape[0]
    assert 1 <= S <= FAST_STATE
    R = F_CHAINS // S
    ahead = F_AHEAD
    ring = ahead + (1 if fault == "short_ring" else 2)
    n_tiles = -(-T // F_TILE)
    n_steps = n_tiles + 1 if write_y else n_tiles
    y = np.full((N, T), np.nan, np.float32) if write_y else None
    h_out = np.zeros((N, S), np.float32)
    ckpt = np.zeros((n_tiles, N, S), np.float32)
    assert R * S <= F_CHAINS and F_READERS == F_CHAINS
    for n0 in range(0, N, R):
        nr = min(R, N - n0)
        rows = slice(n0, n0 + nr)
        cells = _Cells(3)                     # 0 the chain warps, 1 the readout, 2 the producer
        P = 2                                 # the warp that stages u
        U = np.zeros((ring, R, F_TILE), np.float32)
        u_tile = np.full(ring, -1)
        H = np.zeros((2, R, S, F_TILE), np.float32)
        h_tile = np.full(2, -1)

        def stage(j):
            if j * F_TILE >= T:
                return
            slot, t0 = j % ring, j * F_TILE
            ln = min(F_TILE, T - t0)
            U[slot, :nr, :ln] = u[rows, t0:t0 + ln]
            u_tile[slot] = j
            cells.write(P, "U", (slot, slice(0, nr), slice(0, ln)), U.shape)

        def chains():
            h = h0[rows].copy()
            for j in range(n_steps):
                yield ("sync",)
                if j >= n_tiles:
                    continue
                slot, t0 = j % ring, j * F_TILE
                ln = min(F_TILE, T - t0)
                cells.read(0, "U", (slot, slice(0, nr), slice(0, ln)))
                assert u_tile[slot] == j, "the chains read a u tile the ring no longer holds"
                if not ckpt_at_end:
                    ckpt[j, rows] = h
                buf = 0 if fault == "one_buffer" else j & 1
                for i in range(ln):
                    uv = U[slot, :nr, i, None]
                    h = a * h + oma * uv
                    H[buf, :nr, :, i] = (h - uv) * w
                h_tile[buf] = j
                if ckpt_at_end:
                    ckpt[j, rows] = h
                if write_y:
                    cells.write(0, "H", (buf, slice(0, nr), slice(None), slice(0, ln)), H.shape)
            h_out[rows] = h

        def producer():
            for j in range(ahead):
                stage(j)
            for j in range(n_steps):
                yield ("sync",)
                stage(j + ahead)

        def readout():
            for j in range(n_steps):
                yield ("sync",)
                jr = j if fault == "same_step" else j - 1
                if not 0 <= jr < n_tiles:
                    continue
                slot, buf, t0 = jr % ring, 0 if fault == "one_buffer" else jr & 1, jr * F_TILE
                ln = min(F_TILE, T - t0)
                cells.read(1, "H", (buf, slice(0, nr), slice(None), slice(0, ln)))
                assert h_tile[buf] == jr, "the readout reads the states of another tile"
                cells.read(1, "U", (slot, slice(0, nr), slice(0, ln)))
                assert u_tile[slot] == jr, "the readout reads a u tile the ring no longer holds"
                uv, hh = U[slot, :nr, :ln], H[buf, :nr, :, :ln]
                acc = hh[:, 0]
                for k in range(1, S):
                    acc = acc + hh[:, k]
                y[rows, t0:t0 + ln] = (uv + acc) + bias

        warps = {0: chains(), 2: producer()}
        if write_y:
            warps[1] = readout()
        _run_block(cells, warps, rng)
    return y, h_out, ckpt


def _fwd_checkpoints(u, a, oma, h0, *, ckpt_at_end=False):
    """The checkpoints :func:`_fwd_replay` stores, from its state-only
    instance."""
    zeros = np.zeros(a.shape, np.float32)
    return _fwd_replay(u, a, oma, zeros, np.float32(0), h0, None, write_y=False,
                       ckpt_at_end=ckpt_at_end)[2]


def _bwd_replay(u, dy, a, oma, w, h0, *, ckpt_at_end=False, state_buffers=2):
    """``forecaster_scan_bwd``'s schedule in numpy float32, from the
    checkpoints :func:`_fwd_checkpoints` replays. Each block of R = min(128
    // S, 32) rows (its chains vectorised over (rows, states): the same
    operation on every chain) runs steps k = 0 .. n_tiles: the producer's
    ring of each tile's u, dy and checkpoints, staged in reverse kAhead
    tiles ahead (each slot labelled with its tile; a step must find its two
    tiles in their slots, and the stage of step k goes in before the step
    reads them, as the producer's copies may land while the step runs); the
    partial last tile's walks an hour at a time, first; then the recompute
    of tile n_tiles - 1 - k into the state buffer of its parity and the
    adjoint back through tile n_tiles - k from the other, in four-hour
    groups, each group's state operands loaded before the group's store.
    Then the (3S + 1, ld) per-row sums folded over the rows in index order
    from -0.0, in chunks of kFoldRows rows staged through a ring of
    kFoldRing slots. ``state_buffers=1`` shares one state buffer between the
    two tiles of a step (a broken schedule)."""
    src = "forecaster_scan_bwd.cu"
    kTile = _cu_const(src, "kTile")
    kThreads, kMaxRows = _cu_const(src, "kThreads"), _cu_const(src, "kMaxRows")
    kAhead, kRing = _cu_const(src, "kAhead"), _cu_ring(src)
    kFoldRows, kFoldRing = _cu_const(src, "kFoldRows"), _cu_const(src, "kFoldRing")
    N, T = u.shape
    S = a.shape[0]
    R = min(kThreads // S, kMaxRows)
    G = kTile // 4
    ckpt = _fwd_checkpoints(u, a, oma, h0, ckpt_at_end=ckpt_at_end)
    n_tiles = ckpt.shape[0]
    ld = -(-N // 4) * 4
    part = np.full((3 * S + 1, ld), np.nan, np.float32)    # rows past N: never written
    for n0 in range(0, N, R):
        rows = slice(n0, min(n0 + R, N))
        U, DY = u[rows], dy[rows]
        nr = U.shape[0]
        ring = [None] * kRing

        def stage(m):
            t = n_tiles - 1 - m
            if t >= 0:
                tile = slice(t * kTile, (t + 1) * kTile)
                ring[m % kRing] = (t, U[:, tile], DY[:, tile], ckpt[t, rows])

        for m in range(kAhead):
            stage(m)
        hbuf = [np.full((nr, S, kTile), np.nan, np.float32) for _ in range(state_buffers)]
        z = np.zeros((nr, S), np.float32)
        lam, dA, dB, dW = z.copy(), z.copy(), z.copy(), z.copy()
        dBias = np.zeros(nr, np.float32)

        def adjoint(g_, uv, ht, hp):
            nonlocal lam, dA, dB, dW, dBias
            lam = g_[:, None] * w + a * lam
            dA = dA + lam * hp
            dB = dB + lam * uv[:, None]
            dW = dW + g_[:, None] * (ht - uv[:, None])
            dBias = dBias + g_

        for k in range(n_tiles + 1):
            stage(k + kAhead)
            ja, jr = n_tiles - k, n_tiles - 1 - k
            adj, rec = k >= 1, jr >= 0
            if adj:
                ta, Ua, Da, hc = ring[(k - 1) % kRing]
                assert ta == ja, f"step {k} found tile {ta} for its adjoint, not {ja}"
                Ha, len_a = hbuf[ja % state_buffers], Ua.shape[1]
            if rec:
                tr, Ur, _, hr = ring[k % kRing]
                assert tr == jr, f"step {k} found tile {tr} for its recompute, not {jr}"
                Hr, len_r = hbuf[jr % state_buffers], Ur.shape[1]
            full_a, full_r = adj and len_a == kTile, rec and len_r == kTile
            if adj and not full_a:                          # the partial last tile
                for i in range(len_a - 1, -1, -1):
                    adjoint(Da[:, i], Ua[:, i], Ha[..., i], Ha[..., i - 1] if i > 0 else hc)
            if rec and not full_r:
                for i in range(len_r):
                    hr = a * hr + oma * Ur[:, i, None]
                    Hr[..., i] = hr
            nxt = Ha[..., 4 * G - 4:].copy() if full_a else None
            for g in range(G - 1, -1, -1) if full_a or full_r else ():
                q = G - 1 - g
                hv = nxt
                if full_a:                                  # loaded before the store
                    nxt = Ha[..., 4 * g - 4:4 * g].copy() if g > 0 else None
                    hm = nxt[..., 3] if g > 0 else hc
                    for i in range(3, -1, -1):
                        t = 4 * g + i
                        adjoint(Da[:, t], Ua[:, t], hv[..., i], hv[..., i - 1] if i > 0 else hm)
                if full_r:
                    for i in range(4):
                        hr = a * hr + oma * Ur[:, 4 * q + i, None]
                        Hr[..., 4 * q + i] = hr
        part[:S, rows] = dA.T
        part[S:2 * S, rows] = dB.T
        part[2 * S:3 * S, rows] = dW.T
        part[3 * S, rows] = dBias
    # the row fold
    n_chunks = -(-N // kFoldRows)
    fring = [None] * kFoldRing

    def fstage(c):
        if c < n_chunks:
            fring[c % kFoldRing] = (c, part[:, c * kFoldRows:min(ld, (c + 1) * kFoldRows)].copy())

    for c in range(kFoldRing - 1):
        fstage(c)
    acc = np.full(3 * S + 1, -0.0, np.float32)
    for c in range(n_chunks):
        fstage(c + kFoldRing - 1)
        tc, chunk = fring[c % kFoldRing]
        assert tc == c, f"the fold found chunk {tc}, not {c}"
        for i in range(min(kFoldRows, N - c * kFoldRows)):
            acc = acc + chunk[:, i]
    return acc[:S], acc[S:2 * S], acc[2 * S:3 * S], acc[3 * S]


def _bwd_case(N, T, S, seed, nan=True):
    rng = np.random.default_rng(seed)
    u = rng.normal(0.6, 0.5, (N, T)).astype(np.float32)
    if nan and N > 1 and T > 3:
        u[1, T // 2] = np.nan
    a = torch.sigmoid(torch.from_numpy(rng.normal(1.0, 2.0, S).astype(np.float32))).numpy()
    oma = (torch.ones(()) - torch.from_numpy(a)).numpy()
    w = rng.normal(0, 0.2, S).astype(np.float32)
    h0 = rng.normal(0.4, 0.3, (N, S)).astype(np.float32)
    dy = rng.normal(0, 1e-3, (N, T)).astype(np.float32)
    return u, dy, a, oma, w, h0


@pytest.mark.parametrize("order", ["in_order", "shuffled"])
@pytest.mark.parametrize("S", [1, 3, 8, 16])
@pytest.mark.parametrize("shape", [(1, 1), (17, 63), (17, 64), (40, 65), (9, 330)],
                         ids=lambda s: "x".join(map(str, s)))
def test_forward_schedule_bit_equal_to_plain(shape, S, order):
    """The redesigned ``forecaster_scan``'s schedule (chains a tile ahead of
    the readout, two state buffers, the producer's ring), replayed: y, the
    last state and the checkpoints equal ``ref.forecaster_scan_ref`` in every
    bit (a NaN hour in row 1), and so does the state-only instance."""
    N, T = shape
    u, _, a, oma, w, h0 = _bwd_case(N, T, S, 7 * N + T + S)
    bias = np.float32(0.03)
    rng = None if order == "in_order" else np.random.default_rng(N + T + S)
    with np.errstate(invalid="ignore"):
        y, h, ck = _fwd_replay(u, a, oma, w, bias, h0, rng)
        _, h_only, ck_only = _fwd_replay(u, a, oma, w, bias, h0, rng, write_y=False)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    want_ck = torch.empty(checkpoint_shape(N, T, S))
    wy, wh = ref.forecaster_scan_ref(t(u), t(a), t(oma), t(w), t(bias), t(h0), ckpt=want_ck)
    assert _same_bits(t(y), wy) and _same_bits(t(h), wh) and _same_bits(t(ck), want_ck)
    assert _same_bits(t(h_only), wh) and _same_bits(t(ck_only), want_ck)


@pytest.mark.parametrize("fault", F_FAULTS)
def test_forward_replay_catches_a_late_hand_off(fault):
    """The replay is live: one state buffer (the chains overwrite the tile
    the readout folds), a ring one slot short (the producer refills the slot
    the readout reads) or a readout of the tile the chains walk in the same
    step is caught in a random interleaving."""
    u, _, a, oma, w, h0 = _bwd_case(16, 64 * 9, 8, 3, nan=False)
    with pytest.raises(AssertionError, match="without a barrier|never written|another tile|"
                                             "no longer holds"):
        _fwd_replay(u, a, oma, w, np.float32(0.0), h0, np.random.default_rng(5), fault=fault)


def test_backward_tile_matches_the_source():
    """The forward's checkpoints and the backward's tiles: one length."""
    assert _cu_const("forecaster_scan_bwd.cu", "kTile") == BWD_TILE
    assert _cu_const("forecaster_scan.cu", "kTile") == BWD_TILE


@pytest.mark.parametrize("S", [1, 3, 8, 16])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (17, 63), (17, 64), (40, 65), (9, 130)],
                         ids=lambda s: "x".join(map(str, s)))
def test_backward_schedule_bit_equal_to_plain(shape, S):
    """The replayed schedule equals ``ref.forecaster_scan_bwd_ref`` in every
    bit of the four gradients (a NaN hour in row 1 makes every sum NaN)."""
    N, T = shape
    case = _bwd_case(N, T, S, N * T + S)
    with np.errstate(invalid="ignore"):
        got = _bwd_replay(*case)
    want = ref.forecaster_scan_bwd_ref(*(torch.from_numpy(np.ascontiguousarray(x))
                                         for x in case))
    for g, wv in zip(got, want):
        assert _same_bits(torch.from_numpy(np.asarray(g, np.float32)).reshape(wv.shape), wv)


def test_backward_replay_catches_a_wrong_checkpoint():
    """The replay is live: checkpoints stored after their tile instead of
    before it give other gradients than the plain version."""
    case = _bwd_case(5, 130, 8, 1, nan=False)
    assert all(_same_bits(torch.from_numpy(np.asarray(g)).reshape(wv.shape), wv) for g, wv in
               zip(_bwd_replay(*case), ref.forecaster_scan_bwd_ref(
                   *(torch.from_numpy(np.ascontiguousarray(x)) for x in case))))
    got = _bwd_replay(*case, ckpt_at_end=True)
    want = ref.forecaster_scan_bwd_ref(*(torch.from_numpy(np.ascontiguousarray(x))
                                         for x in case))
    assert not _same_bits(torch.from_numpy(got[0]), want[0])


def test_backward_replay_catches_a_shared_state_buffer():
    """The replay is live: a recompute that writes its tile's states into
    the buffer the adjoint is reading gives other gradients."""
    case = _bwd_case(5, 200, 8, 2, nan=False)
    want = ref.forecaster_scan_bwd_ref(*(torch.from_numpy(np.ascontiguousarray(x))
                                         for x in case))
    got = _bwd_replay(*case, state_buffers=1)
    assert not _same_bits(torch.from_numpy(got[0]), want[0])


def test_forward_checkpoints_replay_equals_plain():
    """The forward's checkpoint store (replayed) equals the plain scan's
    checkpoint output bit for bit, and the plain scan's ``y`` and ``h`` are
    those of the call without it."""
    u, _, a, oma, w, h0 = _bwd_case(40, 200, 8, 3)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (u, a, oma, w)]
    bias, h0_t = torch.tensor(0.01, dtype=torch.float32), torch.from_numpy(h0)
    ckpt = torch.full((4, 40, 8), np.nan, dtype=torch.float32)
    y, h = ref.forecaster_scan_ref(*args, bias, h0_t, ckpt=ckpt)
    y0, h_0 = ref.forecaster_scan_ref(*args, bias, h0_t)
    assert _same_bits(y, y0) and _same_bits(h, h_0)
    with np.errstate(invalid="ignore"):
        assert _same_bits(ckpt, torch.from_numpy(_fwd_checkpoints(u, a, oma, h0)))


def test_plain_backward_takes_checkpoints_or_h0():
    """The plain backward from the plain forward's checkpoints equals it
    from that forward's h0 in every bit, and refuses both at once."""
    u, dy, a, oma, w, h0 = (torch.from_numpy(np.ascontiguousarray(x))
                            for x in _bwd_case(9, 130, 8, 4))
    ckpt = torch.empty(checkpoint_shape(9, 130, 8))
    ref.forecaster_scan_ref(u, a, oma, w, torch.tensor(0.0), h0, write_y=False, ckpt=ckpt)
    got = ref.forecaster_scan_bwd_ref(u, dy, a, oma, w, ckpt=ckpt)
    want = ref.forecaster_scan_bwd_ref(u, dy, a, oma, w, h0)
    assert all(_same_bits(g, wv) for g, wv in zip(got, want))
    with pytest.raises(ValueError, match="not both"):
        ref.forecaster_scan_bwd_ref(u, dy, a, oma, w, h0, ckpt=ckpt)


# -- fsm_scan's gated instance: the gate warps' masks and the FSM warp's combine --

F_ROWS, F_TILE = _cu_const("fsm_scan.cu", "kRows"), _cu_const("fsm_scan.cu", "kTile")
F_GATE_WARPS = _cu_const("fsm_scan.cu", "kGateWarps")
F_UNITS = 2 * F_ROWS // F_GATE_WARPS             # half-rows a gate warp takes a tile


def _cu_double(source: str, name: str) -> float:
    m = re.search(rf"constexpr double {name} = ([^;]+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return float.fromhex(m[1]) if "p" in m[1] else float(m[1])


SCREEN_REL, SCREEN_LP, SCREEN_ARG, SCREEN_EDGE = (
    _cu_double("fsm_scan.cu", k) for k in ("kScreenRel", "kScreenLp", "kScreenArg", "kScreenEdge"))


def _f32_out(x, up: bool):
    """float32 of float64 ``x`` rounded up (down): __double2float_ru (_rd)."""
    f = np.float32(x)
    if np.isfinite(f) and (f < x if up else f > x):
        f = np.nextafter(f, np.float32(np.inf if up else -np.inf))
    return f


def _gate_row_np(coef, th1, th2, m):
    """fsm_scan.cu's gate_row for one row: the screen's float32 c0, c1, lp
    range and bounds lo, hi."""
    lo, hi = 0.0, SCREEN_LP
    for k in (0, 2):
        a, b = coef[k], coef[k + 1]
        if not (np.isfinite(a) and np.isfinite(b)):
            hi = -1.0
        elif b == 0.0:
            hi = hi if abs(a) <= SCREEN_ARG else -1.0
        else:
            e1, e2 = (-SCREEN_ARG - a) / b, (SCREEN_ARG - a) / b
            lo, hi = max(lo, min(e1, e2) + SCREEN_EDGE), min(hi, max(e1, e2) - SCREEN_EDGE)
    c0, c1 = coef[2] - coef[0], coef[3] - coef[1]
    e = (abs(c1) * 2.0 ** -19 * (1 + SCREEN_LP) + 2.0 ** -21 * (abs(c0) + abs(c1) * SCREEN_LP)
         + SCREEN_REL * (1 + abs(coef[0]) + abs(coef[2])
                         + 2 * (abs(coef[1]) + abs(coef[3])) * SCREEN_LP))
    lows, highs = [], []
    for t in (th1 - m, th1 + m, th2 + m, th2 - m):
        with np.errstate(divide="ignore"):
            lt = np.log(t) if t > 0 else (-np.inf if t <= 0 else t)
        tol = e + (SCREEN_REL * abs(lt) if np.isfinite(lt) else 0.0)
        lows.append(_f32_out(lt - tol, False))
        highs.append(_f32_out(lt + tol, True))
    return dict(c0=np.float32(c0), c1=np.float32(c1), lp_lo=_f32_out(lo, True),
                lp_hi=_f32_out(hi, False), lo=lows, hi=highs)


def _gate_screen_np(g, pred):
    """fsm_scan.cu's gate_screen over a half-row's 32 lanes: (sure, bits
    (32, 4)). lp comes from numpy's float32 log2, which is within the bound
    the card's hardware log2 is taken at."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        y = pred.astype(np.float32) + np.float32(1)
        lp = np.log2(y) * np.float32(0.693147180559945)
        d = (g["c1"].astype(np.float64) * lp.astype(np.float64) + g["c0"]).astype(np.float32)
        sure = (lp >= g["lp_lo"]) & (lp <= g["lp_hi"])
        bits = np.zeros((32, 4), bool)
        for q in range(4):
            below, above = d < g["lo"][q], d > g["hi"][q]
            sure &= below | above
            bits[:, q] = below if q < 2 else above
    nan = np.isnan(pred)
    bits[nan] = False
    return sure | nan, bits


def _exact_bits(p_vpn, p_cci, g_th):
    """fsm_step.cuh's fsm_gate_bits on the plain version's predicted costs."""
    t1_lo, t1_hi, t2_hi, t2_lo = g_th
    return np.stack([p_cci < t1_lo * p_vpn, p_cci < t1_hi * p_vpn, p_cci > t2_hi * p_vpn,
                     p_cci > t2_lo * p_vpn], -1)


def _gated_scan_replay(vpn, cci, tog, pred, coef, margin, renew, rng, *, fault=None):
    """The gated fsm_scan's schedule in numpy, block by block: at step j the
    sums warp forms tile j's raw masks from its running prefixes, the gate
    warps (warp g takes half-rows 8g .. 8g + 7, both halves of rows 4g ..
    4g + 3: lanes over hours,
    the screen, the exact bits where it is not sure, one ballot a compare)
    form tile j's gate masks into slot j % 2, the FSM warp combines tile
    j - 1's raw masks with slot (j - 1) % 2's gate masks and steps, the cost
    warp adds tile j - 2 in hour order, the copy warps write tile j - 2's x
    and state; the roles of a step run in a random order, as the warps do
    between two barriers. ``fault="wrong_slot"`` makes the combine read slot
    j % 2 (the tile the gate warps form in the same step, or the one before
    it). Returns x, state (int32) and total_cost."""
    from repro_torch.fleet.policy import predicted_mode_costs

    N, T = vpn.shape
    p_vpn, p_cci = (x.numpy() for x in predicted_mode_costs(
        torch.from_numpy(pred), torch.from_numpy(coef), torch.float64))
    th1, th2 = tog["theta1"], tog["theta2"]
    x_out, s_out = np.zeros((N, T), np.int32), np.zeros((N, T), np.int32)
    total = np.zeros(N)
    n_tiles = -(-T // F_TILE)
    garbage = rng.uniform(-5, 5000, F_TILE)          # what an unstaged lane holds
    for n0 in range(0, N, F_ROWS):
        R = np.arange(n0, min(N, n0 + F_ROWS))
        rows = len(R)
        g_rows = [_gate_row_np(coef[n], th1[n], th2[n], margin[n]) for n in R]
        g_th = [np.array([th1[n] - margin[n], th1[n] + margin[n], th2[n] + margin[n],
                          th2[n] - margin[n]]) for n in R]
        h = tog["h"][R]
        p = {"D": tog["D"][R], "T": tog["T_cci"][R], "up": np.ones(rows, np.int64),
             "down": np.ones(rows, np.int64), "renew": renew}
        c = {k: np.zeros(rows, np.int64) for k in ("state", "t_state", "phase", "up", "down")}
        pv, pc, lv, lc = (np.zeros(rows) for _ in range(4))
        raw = [None, None]
        gate = [np.zeros((4, rows), np.uint64), np.zeros((4, rows), np.uint64)]
        dec = [None, None]
        tot = np.zeros(rows)

        def sums(j):
            nonlocal pv, pc, lv, lc
            t0, ln = j * F_TILE, min(F_TILE, T - j * F_TILE)
            req, rel = np.zeros((rows, F_TILE), bool), np.zeros((rows, F_TILE), bool)
            for i in range(ln):
                k = t0 + i - h - 1
                lag_v = np.where(k >= 0, vpn[R, np.maximum(k, 0)], 0.0)
                lag_c = np.where(k >= 0, cci[R, np.maximum(k, 0)], 0.0)
                lv, lc = lv + lag_v, lc + lag_c
                rv, rc = pv - lv, pc - lc
                req[:, i], rel[:, i] = rc < th1[R] * rv, rc > th2[R] * rv
                pv, pc = pv + vpn[R, t0 + i], pc + cci[R, t0 + i]
            raw[j % 2] = (req, rel)

        def gates(j):
            t0, ln = j * F_TILE, min(F_TILE, T - j * F_TILE)
            for g in range(F_GATE_WARPS):
                for v in range(F_UNITS):
                    u = g * F_UNITS + v          # rows 4g .. 4g + 3, both halves
                    if u >= 2 * rows:
                        continue
                    r, half = u >> 1, u & 1
                    lanes = 32 * half + np.arange(32)
                    staged = lanes < ln
                    x = np.where(staged, pred[R[r], np.minimum(t0 + lanes, T - 1)],
                                 garbage[lanes])
                    sure, bits = _gate_screen_np(g_rows[r], x)
                    sure |= ~staged
                    bits[~staged] = False
                    unsure = ~sure
                    if unsure.any():
                        cols = np.minimum(t0 + lanes, T - 1)
                        ex = _exact_bits(p_vpn[R[r], cols], p_cci[R[r], cols], g_th[r])
                        bits[unsure] = ex[unsure]
                    for q in range(4):           # one ballot a compare: lane l's bit to l
                        word = int(np.sum(bits[:, q].astype(np.uint64) << np.arange(32, dtype=np.uint64)))
                        mask = int(gate[j % 2][q, r])
                        mask = (mask & ~(0xFFFFFFFF << (32 * half))) | (word << (32 * half))
                        gate[j % 2][q, r] = np.uint64(mask)

        def fsm(t):
            ln = min(F_TILE, T - t * F_TILE)
            req, rel = raw[t % 2]
            slot = (t + 1) % 2 if fault == "wrong_slot" else t % 2
            bit = lambda q: ((gate[slot][q][:, None] >> np.arange(F_TILE, dtype=np.uint64))
                             & np.uint64(1)).astype(bool)
            req = bit(0) | (req & bit(1))        # the combine: two 64-bit operations
            rel = bit(2) | (rel & bit(3))
            s = np.zeros((rows, F_TILE), np.int64)
            for i in range(ln):
                s[:, i] = _fsm_step(p, c, req[:, i], rel[:, i])
            dec[t % 2] = s

        def cost(t):
            nonlocal tot
            t0, ln = t * F_TILE, min(F_TILE, T - t * F_TILE)
            s = dec[t % 2]
            for i in range(ln):
                tot = tot + np.where(s[:, i] == ON, cci[R, t0 + i], vpn[R, t0 + i])

        def store(t):
            t0, ln = t * F_TILE, min(F_TILE, T - t * F_TILE)
            s = dec[t % 2][:, :ln]
            x_out[R, t0:t0 + ln] = (s == ON)
            s_out[R, t0:t0 + ln] = s

        for j in range(n_tiles + 2):
            roles = []
            if j < n_tiles:
                roles += [lambda j=j: sums(j), lambda j=j: gates(j)]
            if 0 <= j - 1 < n_tiles:
                roles.append(lambda t=j - 1: fsm(t))
            if 0 <= j - 2 < n_tiles:
                # the cost warp and the copy warps read tile j - 2's decisions,
                # written in step j - 1
                roles += [lambda t=j - 2: cost(t), lambda t=j - 2: store(t)]
            for k in rng.permutation(len(roles)):
                roles[k]()
        total[R] = tot
    return x_out, s_out, total


def _gated_replay_case(N, T, seed):
    rng = np.random.default_rng(seed)
    vpn = rng.uniform(5.0, 50.0, (N, T))
    cci = vpn * np.repeat(rng.uniform(0.6, 1.4, (N, T // 40 + 1)), 40, axis=1)[:, :T]
    tog = dict(theta1=rng.uniform(0.85, 0.95, N), theta2=rng.uniform(1.05, 1.2, N),
               h=1 + (np.arange(N) * (T + 2)) // max(N - 1, 1),
               D=np.resize([0, 3, 10, 0], N), T_cci=np.resize([1, 5, 24, 1, 12], N))
    pred = (100.0 * np.repeat(rng.uniform(0.3, 3.0, (N, T // 50 + 1)), 50, axis=1)[:, :T]
            * rng.uniform(0.9, 1.1, (N, T)))
    if N > 2:
        pred[1, T // 5] = -1.0
        pred[1, T // 4] = -1.5
        pred[1, T // 3:] = np.nan
    a_v, b_v, d = rng.uniform(-3.0, -1.0, N), rng.uniform(0.6, 1.0, N), rng.uniform(-0.15, 0.15, N)
    coef = np.stack([a_v, b_v, a_v + np.log(rng.uniform(0.85, 1.15, N)) - 4.6 * d, b_v + d], 1)
    coef[3::11, 1::2] = 0.0
    margin = np.resize([0.0, 0.05, 0.15, 1e30], N).astype(np.float64)
    if N > 2:      # row 2's ratio crosses its thresholds at lp 2-22, its hours on them
        d2 = rng.choice([-1.0, 1.0]) * rng.uniform(0.05, 0.3)
        c0 = np.log(tog["theta1"][2]) - d2 * rng.uniform(8.0, 12.0)
        coef[2, 2:] = coef[2, 0] + c0, coef[2, 1] + d2
        t = np.array([tog["theta1"][2] - margin[2], tog["theta1"][2] + margin[2],
                      tog["theta2"][2] + margin[2], tog["theta2"][2] - margin[2]])
        lt = np.log(np.maximum(t[rng.integers(0, 4, T)], 1e-300))
        with np.errstate(over="ignore"):
            pred[2] = np.expm1((lt - c0) / d2) * (1 + rng.choice([-1, 1], T)
                                                   * 10.0 ** rng.uniform(-16, -1, T))
    return vpn, cci, tog, pred, coef, margin


def _gated_plain(vpn, cci, tog, pred, coef, margin, renew):
    t = lambda a, dt=torch.float64: torch.as_tensor(np.asarray(a), dtype=dt)
    one = torch.ones(len(margin), dtype=torch.int32)
    return ref.fsm_scan_ref(t(vpn), t(cci), t(tog["theta1"]), t(tog["theta2"]),
                            *(t(tog[k], torch.int32) for k in ("h", "D", "T_cci")), one, one,
                            renew_in_chunks=renew,
                            gate=(t(pred), t(coef), t(margin)))


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("shape", [(1, 1), (17, 63), (19, 64), (16, 65), (33, 130)],
                         ids=lambda s: "x".join(map(str, s)))
def test_gated_scan_schedule_bit_equal_to_plain(shape, renew):
    """The gated fsm_scan's schedule (gate masks by ballot over lanes from
    the screen or the exact bits, the combine at the FSM warp, tile tails,
    rows past a block's) replayed in numpy equals ref.fsm_scan_ref's gated
    form bit for bit: x, state, total_cost."""
    N, T = shape
    case = _gated_replay_case(N, T, 7 * N + T)
    got = _gated_scan_replay(*case, renew, np.random.default_rng(N + T))
    want = _gated_plain(*case, renew)
    assert np.array_equal(got[0], want["x"].numpy())
    assert np.array_equal(got[1], want["state"].numpy())
    assert _same_bits(torch.from_numpy(got[2]), want["total_cost"])


def test_gated_scan_replay_catches_the_wrong_mask_slot():
    """A combine that reads the other slot of the gate-mask ring (another
    tile's masks) must differ from the plain version."""
    case = _gated_replay_case(33, 130, 5)
    got = _gated_scan_replay(*case, False, np.random.default_rng(0), fault="wrong_slot")
    want = _gated_plain(*case, False)
    assert not (np.array_equal(got[0], want["x"].numpy())
                and np.array_equal(got[1], want["state"].numpy()))


def test_gate_screen_replay_sure_bits_are_exact():
    """The screen (gate_row, gate_screen, emulated in numpy) on predictions
    near the thresholds: every bit it is sure of equals the exact compare of
    the plain version's predicted costs, and it leaves the hours closest to a
    threshold to the exact form."""
    from repro_torch.fleet.policy import predicted_mode_costs

    rng = np.random.default_rng(11)
    n_sure = n_left = 0
    for r in range(40):
        vpn, cci, tog, pred, coef, margin = _gated_replay_case(3, 320, 100 + r)
        th = (tog["theta1"][2], tog["theta2"][2], margin[2])
        g = _gate_row_np(coef[2], *th)
        pv, pc = (x.numpy() for x in predicted_mode_costs(
            torch.from_numpy(pred[2:3]), torch.from_numpy(coef[2:3]), torch.float64))
        exact = _exact_bits(pv[0], pc[0], np.array([th[0] - th[2], th[0] + th[2],
                                                    th[1] + th[2], th[1] - th[2]]))
        for k in range(0, 320, 32):
            sure, bits = _gate_screen_np(g, pred[2, k:k + 32])
            assert np.array_equal(bits[sure], exact[k:k + 32][sure])
            n_sure += int(sure.sum())
            n_left += int((~sure).sum())
    assert n_sure > 1000 and n_left > 1000
