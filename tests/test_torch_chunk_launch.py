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
  before it through those barriers;
* the scan: the segment plan, one block per (row tile, segment slot), each
  segment's hours staged through the ring of shared-memory tiles (a tile
  must have landed before it is read, and a slot is refilled only once its
  tile is folded), the carry a tile at a time, the fold per (row, hour);
  and a chunk of one segment slot with no plan, its resets staged with the
  demand and applied in the carry.

Change a kernel's schedule and change its replay with it: the replays read
the kernels' tile constants from the CUDA sources.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.fleet import FleetRuntime, build_fleet_scenario
from repro_torch.kernels import ref
from repro_torch.kernels.stream_chunk import (MAX_SUBS, SUB_HOURS, TICK_MAX_K,
                                              TICK_MAX_TIERS, launch_form)
from repro_torch.kernels.tiered_cost_scan import (SCAN_ROWS, SCAN_TARGET_BLOCKS,
                                                  segment_plan, segment_slots)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _cu_const(source: str, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_tile_constants_match_the_sources():
    assert _cu_const("stream_chunk.cu", "kTickMaxK") == TICK_MAX_K
    assert _cu_const("stream_chunk.cu", "kTickMaxTiers") == TICK_MAX_TIERS
    assert _cu_const("stream_chunk.cu", "kSub") == SUB_HOURS
    assert _cu_const("stream_chunk.cu", "kMaxSubs") == MAX_SUBS
    assert _cu_const("tiered_cost_scan.cu", "kScanRows") == SCAN_ROWS
    # five named barriers a sub-tile, barrier 0 for __syncthreads: 16 in all
    assert 1 + _cu_const("stream_chunk.cu", "kPhases") * MAX_SUBS <= 16


# -- launch_form -------------------------------------------------------------

@pytest.mark.parametrize("K,want", [(1, 0), (TICK_MAX_K, 0), (TICK_MAX_K + 1, 1), (8, 1),
                                    (9, 2), (16, 2), (17, 3), (23, 3), (24, 3), (25, 3),
                                    (168, 3)])
def test_launch_form_by_K(K, want):
    assert launch_form(K, 4) == want


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


def _chunk_np(args, renew):
    """The chunk's operands as numpy: the block's planes and the per-row ones."""
    (block, K, endo, cap, lvpn, lease, cc, b, r, th1, th2, h, D, Tc, uh, dh, cal, fsm, pref,
     t0, hpm) = args
    M = cap.shape[0]
    blk = block.numpy()
    nd = (2 if endo else 1) * K * M
    n = lambda x: x.numpy()
    return {
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


def _pack(c, planes, tail, carry, rows_all):
    out = np.concatenate([planes.reshape(8 * c["K"], c["M"]), tail])
    fsm = np.stack([carry[k] for k in ("state", "t_state", "up", "down")]).astype(np.int32)
    return torch.from_numpy(out), torch.from_numpy(fsm)


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


def _pipe_block(c, n0, S, rng, early_pref=False):
    """``stream_chunk_pipe_kernel<S>`` for the block of rows n0..n0+15, its
    roles run as coroutines in an order ``rng`` picks (in order if None).
    ``early_pref`` breaks the schedule on purpose: the prefix warp hands each
    sub-tile on before it writes the snapshots."""
    K, M, t0 = c["K"], c["M"], c["t0"]
    R = 16
    tile = SUB_HOURS * S
    rows = slice(n0, min(M, n0 + R))
    nr = rows.stop - rows.start
    roles = [f"pair{j}" for j in range(S)] + ["cal", "pref", "fsm"]
    sim = _Sim(roles)
    out = {}

    def pair(j):
        me = f"pair{j}"
        for k0 in range(0, K, tile):
            hrs = [k for k in range(SUB_HOURS * j, SUB_HOURS * (j + 1)) if k < K - k0]
            loaded = {k: (c["demand"][k0 + k, rows],
                          c["cci_demand"][k0 + k, rows] if c["endo"] else None,
                          c["pre_v"][k0 + k, rows].copy(), c["pre_c"][k0 + k, rows].copy())
                      for k in hrs}
            yield ("sync0",)
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

    tail = {}

    def calendar():
        dcum, month = c["cal"][0, rows].copy(), c["cal"][1, rows].copy()
        ph = t0 % c["hpm"]
        for k0 in range(0, K, tile):
            dv = [c["demand"][k0 + k, rows] for k in range(min(tile, K - k0))]
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

    def prefixes():
        pv, pc = c["pref"][0, rows].copy(), c["pref"][1, rows].copy()
        for k0 in range(0, K, tile):
            ln = min(tile, K - k0)
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

    def fsm_warp():
        fc = _carry(c, rows)
        p = _sub(c["p"], rows)
        for k0 in range(0, K, tile):
            ln = min(tile, K - k0)
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


def _pipe_replay(c, S, rng, early_pref=False):
    K, M = c["K"], c["M"]
    planes = np.full((8, K, M), np.nan)
    written = np.zeros((K, M), bool)
    tail = np.zeros((4, M))
    carry = {k: np.zeros(M, np.int64) for k in ("state", "t_state", "up", "down", "phase")}
    for n0 in range(0, M, 16):
        out, t, rows = _pipe_block(c, n0, S, rng, early_pref)
        for (plane, k), v in out.items():
            planes[plane, k, rows] = v
            written[k, rows] |= plane == 7
        tail[0, rows], tail[1, rows] = t["cal"]
        tail[2, rows], tail[3, rows] = t["pref"]
        for k in carry:
            carry[k][rows] = t["fsm"][k]
    assert written.all()
    return _pack(c, planes, tail, carry, slice(0, M))


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
