"""The ``oracle_dp`` kernel's host-side launch plan, and its register form's
schedule, on the CPU.

:func:`repro_torch.kernels.oracle_dp.launch_plan` is a pure function of the
rows' ``D`` and ``T_cci``: it picks each row's form and register instance
and the order the kernels walk the rows in. Here it is checked on edge
rows, on the instance limits and just past them, and on random batches:
the order is a permutation of the rows, every register-form row's instance
holds its chain, the large-row form is taken exactly when a row is past the
largest instance, and the order groups the rows as the kernels expect.

The CUDA kernel has no CPU mode, so :func:`_register_form` below replays
the register form's warp body (``row_dp`` in ``csrc/oracle_dp.cu``) step by
step with the 32 lanes as a numpy axis: the ON ring with its head walking
the registers and lanes, the WAITING shift register with its lane carries
and top select, the scalars, and the staging ring of four 64-hour tiles
(every read must find its hour staged and waited for). It is held against
the plain version, ``ref.oracle_dp_ref``, bit for bit (NaN in the same
places) on the DP's edge rows, NaN and tie batches, the instance limits and
horizons that do not fill a tile.
"""
import numpy as np
import pytest
import torch

from test_torch_cuda import DP_ROWS, oracle_batch

from repro_torch.kernels import ref
from repro_torch.kernels.oracle_dp import (K1_MAX, K2_MAX, WARPS_MAX, launch_plan,
                                          rows_per_block)

TILE, SLOTS = 64, 256


def _chains(D, Tc):
    D, Tc = np.asarray(D, np.int64), np.asarray(Tc, np.int64)
    return Tc - (D == 0), np.maximum(D - 1, 0)


def _plan_np(D, Tc, form="auto"):
    p = launch_plan(torch.tensor(D, dtype=torch.int32), torch.tensor(Tc, dtype=torch.int32),
                    form)
    return tuple(x.numpy() for x in p)


def _random_rows(seed: int, n: int):
    """Rows across every instance and past the limits: edge D and T_cci,
    the scenarios' ranges, and long commitments and delays."""
    rng = np.random.default_rng(seed)
    D = rng.choice(np.concatenate([[0, 1, 2, 33, 34, 65, 66, 97, 98],
                                   rng.integers(0, 130, 20)]), n).astype(np.int32)
    Tc = rng.choice(np.concatenate([[1, 2, 32, 33, 383, 384, 385, 386],
                                    rng.integers(1, 420, 20)]), n).astype(np.int32)
    return D, Tc


EDGE_ROWS = list(DP_ROWS) + [(97, 384), (0, 385), (98, 1), (1, 385), (0, 386), (98, 384)]


@pytest.mark.parametrize("form", ["auto", "register", "large"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_launch_plan_order_is_a_permutation(seed, form):
    D, Tc = _random_rows(seed, 203)
    order, regs, large, fits = _plan_np(D, Tc, form)
    assert order.dtype == np.int32 and regs.dtype == np.int32
    assert np.array_equal(np.sort(order), np.arange(len(D)))


@pytest.mark.parametrize("rows", ["edges", "random"])
def test_launch_plan_instance_holds_each_chain(rows):
    """Every register-form row's instance holds its ON ring (R1 slots over
    32 lanes, the least K1 that does) and its WAITING chain (R2 positions,
    K2_MAX registers a lane), within the kernel's instances: K2 is 0
    exactly when R2 == 0, K1 == 0 only for the row with no ON ring (D == 0,
    T_cci == 1)."""
    if rows == "edges":
        D, Tc = (np.array(x, np.int32) for x in zip(*EDGE_ROWS))
    else:
        D, Tc = _random_rows(7, 500)
    order, regs, large, fits = _plan_np(D, Tc)
    r1, r2 = _chains(D, Tc)
    k1, k2 = regs // 4, regs % 4
    reg = ~large
    assert reg.any()
    assert np.all(32 * k1[reg] >= r1[reg]) and np.all(32 * k2[reg] >= r2[reg])
    assert np.array_equal(k1[reg], -(-r1[reg] // 32))
    assert np.array_equal(k2[reg], np.where(r2[reg] > 0, K2_MAX, 0))
    assert np.all((k1[reg] >= 0) & (k1[reg] <= K1_MAX))
    assert np.array_equal(k2[reg] == 0, r2[reg] == 0)
    assert np.all((k1[reg] > 0) | ((D[reg] == 0) & (Tc[reg] == 1)))


@pytest.mark.parametrize("rows", ["edges", "random"])
def test_launch_plan_large_form_exactly_past_the_largest_instance(rows):
    if rows == "edges":
        D, Tc = (np.array(x, np.int32) for x in zip(*EDGE_ROWS))
    else:
        D, Tc = _random_rows(11, 500)
    order, regs, large, fits = _plan_np(D, Tc)
    r1, r2 = _chains(D, Tc)
    past = (r1 > 32 * K1_MAX) | (r2 > 32 * K2_MAX)
    assert past.any() and (~past).any()
    assert np.array_equal(large, past) and np.array_equal(fits, ~past)


def test_launch_plan_limits():
    """The instances' edges, row by row: T_cci 384 with D 97 is the largest
    register-form row (and T_cci 385 with D 0, whose ring is one shorter);
    one more commitment hour or delay hour takes the large-row form."""
    D = np.array([97, 0, 1, 98, 0, 2, 0], np.int32)
    Tc = np.array([384, 385, 385, 384, 386, 1, 1], np.int32)
    order, regs, large, fits = _plan_np(D, Tc)
    assert large.tolist() == [False, False, True, True, True, False, False]
    assert (regs[0], regs[1], regs[5], regs[6]) == (12 * 4 + 3, 12 * 4 + 0, 1 * 4 + 3, 0)


@pytest.mark.parametrize("seed", [3, 4])
def test_launch_plan_orders_large_first_then_by_instance(seed):
    """The large-row form's rows come first, most states first; then the
    register form's by descending (K1, K2), each instance's rows together
    (in their own order), and in each block of the register form every
    warp's instance holds its row."""
    D, Tc = _random_rows(seed, 301)
    order, regs, large, fits = _plan_np(D, Tc)
    n_large = int(large.sum())
    assert large[order[:n_large]].all() and not large[order[n_large:]].any()
    states = (D.astype(np.int64) + Tc)[order[:n_large]]
    assert np.all(np.diff(states) <= 0)
    codes = regs[order[n_large:]]
    assert np.all(np.diff(codes) <= 0)
    r1, r2 = _chains(D, Tc)
    warps = rows_per_block(len(codes), 132)
    for b in range(0, len(codes), warps):
        rows = order[n_large + b:n_large + b + warps]
        assert np.all(32 * (regs[rows] // 4) >= r1[rows])
        assert np.all(32 * (regs[rows] % 4) >= r2[rows])
    for code in set(codes.tolist()):
        idx = np.flatnonzero(codes == code)
        assert np.all(np.diff(idx) == 1)
        assert np.all(np.diff(order[n_large + idx]) > 0)


@pytest.mark.parametrize("n_rows,want", [(1, 4), (128, 4), (528, 4), (529, 5), (1056, 8),
                                         (2048, 16), (2112, 16), (100000, 16)])
def test_rows_per_block(n_rows, want):
    """About one block an SM (132 on the H100), 4 to WARPS_MAX rows."""
    assert rows_per_block(n_rows, 132) == want
    assert 4 <= want <= WARPS_MAX


def test_launch_plan_forced_forms():
    D, Tc = _random_rows(5, 64)
    _, _, large, fits = _plan_np(D, Tc, "large")
    assert large.all()
    _, _, large, fits_r = _plan_np(D, Tc, "register")
    assert not large.any() and np.array_equal(fits, fits_r) and not fits.all()
    order, regs, large, _ = _plan_np(D[:0], Tc[:0])
    assert order.shape == regs.shape == large.shape == (0,)
    with pytest.raises(ValueError, match="form"):
        launch_plan(torch.tensor(D), torch.tensor(Tc), "fast")


# -- the register form's warp body, replayed ---------------------------------

def _register_form(vpn, cci, D: int, Tc: int, K1: int, K2: int, head_start: bool):
    """``row_dp<K1, K2>`` of ``csrc/oracle_dp.cu`` for one row, lanes as a
    numpy axis, its hour split as there into a step on operands read
    beforehand and the reads of the next hour's: ``(total, start_on)``."""
    T = len(vpn)
    KU, KW = max(K1, 1), max(K2, 1)
    R1, R2 = Tc - (D == 0), max(D - 1, 0)
    v = np.zeros((32, KU))
    w = np.zeros((32, KW))
    st = {"off": np.float64(0.0), "onf": np.float64(0.0), "t": T - 1}
    lane = np.arange(32)
    top_lane, top_reg = ((R2 - 1) // K2, (R2 - 1) % K2) if K2 else (0, 0)
    nb = -(-R1 // K1) if K1 else 1
    last = R1 - (nb - 1) * K1 if K1 else 1
    slot_hour = np.full(SLOTS, -1)       # hour each staging slot holds, once waited for
    pending = []                          # tiles copied but not waited for
    ops = {}                              # the next hour's operands

    def stage(k):
        # the copy may land any time before the wait: its slots must hold no
        # hour still to be read (every hour above t is read)
        h = np.arange(k * TILE, min(k * TILE + TILE, T))
        held = slot_hour[h & (SLOTS - 1)]
        assert np.all((held < 0) | (held > st["t"])), "staging overwrote a live tile"
        slot_hour[h & (SLOTS - 1)] = -2          # in flight: not readable yet
        pending.append(k)

    def wait_all():
        for k in pending:
            h = np.arange(k * TILE, min(k * TILE + TILE, T))
            slot_hour[h & (SLOTS - 1)] = h
        pending.clear()

    def reads(rr, hh):
        t = st["t"]
        if t >= 0:
            assert slot_hour[t & (SLOTS - 1)] == t, \
                f"hour {t} read from a slot holding {slot_hour[t & (SLOTS - 1)]}"
            ops["cv"], ops["cc"] = vpn[t], cci[t]
        ops["out"] = v[hh, rr] if K1 else st["onf"]
        if K2:
            ops["up"] = np.concatenate([w[:1, K2 - 1], w[:-1, K2 - 1]])   # __shfl_up_sync
            ops["src"] = w[top_lane, top_reg]
        else:
            ops["src"] = ops["out"]

    def step(r, head_lane):
        nonlocal v, w
        cv, cc, out, src = ops["cv"], ops["cc"], ops["out"], ops["src"]
        stay = cv + st["off"]
        req = (cv if K2 else (cc if D == 0 else cv)) + src
        stay_on = cc + st["onf"]
        if K1:
            head = np.where(lane == head_lane, st["onf"], v[:, r])
            v = cc + v
            v[:, r] = cc + head
        if K2:
            w = np.concatenate([(cv + np.where(lane == 0, out, ops["up"]))[:, None],
                                cv + w[:, :-1]], axis=1)
        st["off"] = req if req < stay else stay
        st["onf"] = stay_on if stay_on <= stay else stay
        st["t"] -= 1

    k_done = 0
    if T > 0:
        k_done = (T - 1) // TILE
        stage(k_done)
        wait_all()
        if k_done > 0:
            stage(k_done - 1)
        reads(0, 0)
    hl = 0
    while st["t"] >= 0:
        t = st["t"]
        n = last if hl == nb - 1 else KU
        m = min(n, t + 1)
        hl_next = 0 if hl + 1 == nb else hl + 1
        k_low = max(t - m, 0) // TILE
        if k_low < k_done:
            wait_all()
            k_done = k_low
            if k_low > 0:
                stage(k_low - 1)
        for r in range(KU):
            if r >= m:
                break
            step(r, hl)
            if r + 1 < m:
                reads((r + 1) % KU, hl)
            else:
                reads(0, hl_next)
        hl = hl_next
    off, onf = st["off"], st["onf"]
    take_on = bool(head_start) and onf < off
    return (onf if take_on else off), take_on


def _replay_batch(vpn, cci, D, Tc, head_start):
    _, regs, large, _ = _plan_np(D, Tc)
    assert not large.any()
    out = [_register_form(vpn[i], cci[i], int(D[i]), int(Tc[i]), int(regs[i]) // 4,
                          int(regs[i]) % 4, head_start) for i in range(len(D))]
    return (torch.tensor([o[0] for o in out], dtype=torch.float64),
            torch.tensor([o[1] for o in out], dtype=torch.bool))


def _same_bits(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int64),
                                               b[~nb].view(torch.int64))


def _batch(case: str):
    """``(vpn, cci, D, T_cci)``: the card tests' batches at short horizons
    (not a whole number of tiles), one row at each instance limit and the
    ring's edge rows, and horizons of 0, 1 and a tile and one hour."""
    if case in ("mixed", "nan", "ties"):
        return oracle_batch(case, T=203)
    rng = np.random.default_rng(9)
    if case == "limits":
        rows = [(97, 384), (0, 385), (66, 353), (65, 352), (33, 33), (34, 32), (2, 1), (0, 2)]
        T = 150
    else:
        rows = list(DP_ROWS[:6]) + [(3, 40)]
        T = {"T0": 0, "T1": 1, "T65": 65}[case]
    vpn = rng.uniform(5.0, 50.0, size=(len(rows), T))
    cci = vpn * np.repeat(rng.uniform(0.6, 1.4, size=(len(rows), T // 9 + 1)), 9,
                          axis=1)[:, :T]
    D = np.array([d for d, _ in rows], np.int32)
    Tc = np.array([tc for _, tc in rows], np.int32)
    return vpn, cci, D, Tc


@pytest.mark.parametrize("head_start", [True, False], ids=["head-start", "off-start"])
@pytest.mark.parametrize("case", ["mixed", "nan", "ties", "limits", "T0", "T1", "T65"])
def test_register_form_schedule_bit_equal_to_plain(case, head_start):
    vpn, cci, D, Tc = _batch(case)
    got_total, got_on = _replay_batch(vpn, cci, D, Tc, head_start)
    want_total, want_on = ref.oracle_dp_ref(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (vpn, cci, D, Tc)),
        allow_head_start=head_start)
    assert _same_bits(got_total, want_total)
    assert torch.equal(got_on, want_on)
