"""Port vs JAX package for the paper's evaluation core, and the batched
offline DP against the scalar one.

The same inputs (made with numpy from a seed; horizons ≤ 1200 h where the
numpy DP runs, except the reference's own 16 000-h ratio test) go through the
JAX package's ``repro.core`` and the port's ``repro_torch.core`` on the CPU.
The port's cost model, oracle, baselines and adversary are numpy copies, so
every schedule, cost and ratio is held bit for bit (``==``). The batched
plain version of the ``oracle_dp`` kernel (``ref.oracle_dp_ref``, what
``ops.oracle_dp`` runs on the CPU) is held against the port's scalar
``offline_optimal`` row by row, every bit of the total and the start state,
on rows covering the DP's edge branches (D in 0, 1, 2, 72; T_cci in 1, 2,
168), with NaN hours and with ties. ``fleet_oracle`` and ``topology_oracle``
(one ``oracle_dp`` call each) against the JAX oracles: bit for bit. The
reference's own theory tests (Property 1, Theorem 1, the oracle's lower
bounds, the brute force) are mirrored on the port, with the batched DP
beside the scalar one, their random inputs drawn from numpy seeds.
"""
import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (the enable_x64 alias, before repro)
from test_torch_cuda import DP_ROWS, oracle_batch

from repro.core import adversary as jadv
from repro.core import baselines as jbase
from repro.core import costmodel as jcost
from repro.core import oracle as jorc
from repro.core import pricing as jpri
from repro.core import togglecci as jtog
from repro.fleet import engine as jeng
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop

from repro_torch.core import adversary as tadv
from repro_torch.core import baselines as tbase
from repro_torch.core import costmodel as tcost
from repro_torch.core import oracle as torc
from repro_torch.core import pricing as tpri
from repro_torch.core import togglecci as ttog
from repro_torch.core.costmodel import HourlyCosts
from repro_torch.fleet import engine as teng
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import topology as ttop
from repro_torch.kernels import ops, ref

T_EVAL = 1200


def _params(mod, kind: str):
    """The paper's GCP -> AWS scenario, or a small flat-rate one (the
    reference's theory tests' CostParams(1.0, 0.1, 0.02, 0.1, 0.1, D=4,
    T_cci=6, h=8)), built by either package."""
    if kind == "gcp-aws":
        return mod.make_scenario("gcp", "aws")
    return mod.CostParams(1.0, 0.1, 0.02, 0.1, mod.flat_rate(0.1), D=4, T_cci=6, h=8)


def _demand(seed: int, T: int = T_EVAL, pairs: int = 0) -> np.ndarray:
    """Bursty demand around the GCP -> AWS break-even rate, (T,) or (T, pairs)."""
    rng = np.random.default_rng(seed)
    shape = (T,) if pairs == 0 else (T, pairs)
    level = np.repeat(rng.uniform(0.0, 3.0, size=(T // 100 + 1,) + shape[1:]), 100, axis=0)[:T]
    rate = jpri.breakeven_rate_gb_per_hour(jpri.make_scenario("gcp", "aws"))
    return level * rate * rng.uniform(0.5, 1.5, size=shape)


def _schedule(seed: int, T: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 7)
    return np.repeat(rng.integers(0, 2, size=T // 24 + 1), 24)[:T]


def _batched(vpn, cci, D, Tc, head_start=True):
    """``ops.oracle_dp`` on the CPU (its plain version) over numpy rows."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    total, start_on = ops.oracle_dp(t(vpn), t(cci), t(np.asarray(D, np.int32)),
                                    t(np.asarray(Tc, np.int32)), allow_head_start=head_start)
    return total.numpy(), start_on.numpy()


def _same_float(a: float, b: float) -> bool:
    return np.float64(a).tobytes() == np.float64(b).tobytes() or (np.isnan(a) and np.isnan(b))


# ---------------------------------------------------------------------------
# The core against JAX, bit for bit
# ---------------------------------------------------------------------------


def test_state_names_match_jax():
    assert ttog.STATE_NAMES == jtog.STATE_NAMES
    assert (ttog.OFF, ttog.WAITING, ttog.ON) == (jtog.OFF, jtog.WAITING, jtog.ON)


@pytest.mark.parametrize("pairs", [0, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_schedule_and_cost_breakdown_match_jax(seed, pairs):
    d = _demand(seed, pairs=pairs)
    x = _schedule(seed, T_EVAL)
    jp, tp = _params(jpri, "gcp-aws"), _params(tpri, "gcp-aws")
    assert tcost.evaluate_schedule(tp, d, x) == jcost.evaluate_schedule(jp, d, x)
    assert tcost.cost_breakdown(tp, d, x) == jcost.cost_breakdown(jp, d, x)


@pytest.mark.parametrize("head_start", [True, False], ids=["head-start", "off-start"])
@pytest.mark.parametrize("kind,seed", [("gcp-aws", 0), ("gcp-aws", 3), ("flat", 1)])
def test_offline_optimal_matches_jax(kind, seed, head_start):
    d = _demand(seed)
    if kind == "flat":
        d = d / 1e3
    jr = jorc.offline_optimal(_params(jpri, kind), d, allow_head_start=head_start)
    tr = torc.offline_optimal(_params(tpri, kind), d, allow_head_start=head_start)
    np.testing.assert_array_equal(tr.x, jr.x)
    assert tr.total_cost == jr.total_cost and tr.start_on == jr.start_on
    assert 0 < tr.x.sum() < tr.x.size or kind == "flat"


@pytest.mark.parametrize("seed", [0, 2])
def test_best_static_matches_jax(seed):
    d = _demand(seed)
    assert torc.best_static(_params(tpri, "gcp-aws"), d) == \
        jorc.best_static(_params(jpri, "gcp-aws"), d)


@pytest.mark.parametrize("name", sorted(jbase.BASELINES))
@pytest.mark.parametrize("pairs", [0, 2])
def test_baseline_schedules_match_jax(name, pairs):
    d = _demand(4, pairs=pairs)
    assert sorted(tbase.BASELINES) == sorted(jbase.BASELINES)
    got = tbase.BASELINES[name](_params(tpri, "gcp-aws"), d)
    want = jbase.BASELINES[name](_params(jpri, "gcp-aws"), d)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("seed", [0, 5])
def test_evaluate_all_matches_jax(seed):
    d = _demand(seed)
    got = tbase.evaluate_all(_params(tpri, "gcp-aws"), d)
    assert got == jbase.evaluate_all(_params(jpri, "gcp-aws"), d)
    assert got["oracle"] <= min(v for k, v in got.items() if k != "oracle")


@pytest.mark.parametrize("alpha", [2.0, 10.0, 100.0])
def test_adversary_matches_jax(alpha):
    ti, ji = tadv.instance_for_ratio(alpha), jadv.instance_for_ratio(alpha)
    assert ti.alpha == ji.alpha
    assert ti.params.__dict__.keys() == ji.params.__dict__.keys()
    for k in ("L_cci", "V_cci", "c_cci", "L_vpn", "D", "T_cci", "h"):
        assert getattr(ti.params, k) == getattr(ji.params, k), k
    assert ti.params.vpn_tier.rates == ji.params.vpn_tier.rates
    for branch in ("demand_spike", "demand_silent"):
        d = getattr(ti, branch)
        np.testing.assert_array_equal(d, getattr(ji, branch))
        for name in sorted(tbase.BASELINES):
            x = tbase.BASELINES[name](ti.params, d)
            assert tadv.competitive_ratio(ti.params, d, x) == \
                jadv.competitive_ratio(ji.params, d, x), (branch, name)
        x = ttog.run_togglecci(ti.params, d).x
        assert tadv.ratio_of_policy(lambda p, dd: x, ti.params, d) == \
            jadv.competitive_ratio(ji.params, d, x)


# ---------------------------------------------------------------------------
# The batched DP (oracle_dp's plain version) against the scalar numpy DP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_start", [True, False], ids=["head-start", "off-start"])
@pytest.mark.parametrize("case", ["mixed", "nan", "ties"])
def test_oracle_dp_ref_bit_equal_to_offline_optimal(case, head_start):
    """Every row's total and start state, bit for bit, on the DP's edge
    branches (D = 0 serves CCI in the request hour, D = 1 lands in ON,
    T_cci = 1 lands in ON free), NaN hours and tied costs."""
    vpn, cci, D, Tc = oracle_batch(case, T=T_EVAL)
    before = ops.LAUNCHES["oracle_dp"]
    total, start_on = _batched(vpn, cci, D, Tc, head_start)
    assert ops.LAUNCHES["oracle_dp"] == before, "the CPU runs the plain version"
    z = np.zeros(T_EVAL)
    starts = set()
    for i, (d_, tc) in enumerate(DP_ROWS):
        p = tpri.CostParams(1.0, 0.1, 0.02, 0.1, tpri.flat_rate(0.1), D=d_, T_cci=tc)
        r = torc.offline_optimal(p, costs=HourlyCosts(z, vpn[i], z, cci[i]),
                                 allow_head_start=head_start)
        assert _same_float(total[i], r.total_cost), (i, d_, tc, total[i], r.total_cost)
        assert bool(start_on[i]) == r.start_on, (i, d_, tc)
        starts.add(r.start_on)
    if case == "nan":
        assert np.isnan(total).any() and np.isfinite(total).any()
    if head_start and case != "nan":
        assert starts == {True, False}


def test_oracle_dp_ref_empty_and_zero_hours():
    total, start_on = _batched(np.zeros((0, 5)), np.zeros((0, 5)), [], [])
    assert total.shape == (0,) and start_on.shape == (0,)
    total, start_on = _batched(np.zeros((3, 0)), np.zeros((3, 0)), [0, 1, 5], [1, 2, 7])
    assert total.tolist() == [0.0, 0.0, 0.0] and not start_on.any()


# ---------------------------------------------------------------------------
# The OPT columns against JAX
# ---------------------------------------------------------------------------


def test_fleet_oracle_bit_equal_to_jax():
    jsc = jscen.build_fleet_scenario(6, horizon=T_EVAL, seed=11)
    tsc = tscen.build_fleet_scenario(6, horizon=T_EVAL, seed=11)
    want = jeng.fleet_oracle(jsc.fleet, jsc.demand)
    got = teng.fleet_oracle(tsc.fleet, tsc.demand, device="cpu")
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


TOPOLOGIES = {
    "relay": lambda m: m.build_relay_scenario(horizon=T_EVAL, seed=0),
    "multicast": lambda m: m.build_multicast_scenario(n_leaves=4, horizon=T_EVAL, seed=0),
    "topology": lambda m: m.build_topology_scenario(
        12, n_facilities=3, ports_per_facility=2, horizon=T_EVAL, seed=4),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_topology_oracle_bit_equal_to_jax(case):
    jsc, tsc = TOPOLOGIES[case](jscen), TOPOLOGIES[case](tscen)
    jr = jtop.optimize_routing(jsc.topo, jsc.demand)
    tr = ttop.optimize_routing(tsc.topo, tsc.demand)
    assert tr.paths == jr.paths
    want = jeng.topology_oracle(jsc.topo, jsc.demand, jr)
    got = teng.topology_oracle(tsc.topo, tsc.demand, tr, device="cpu")
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


def test_oracles_raise_without_cuda(monkeypatch):
    """No device and no CUDA: the OPT columns raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tscen.build_fleet_scenario(2, horizon=48, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.fleet_oracle(sc.fleet, sc.demand)
    rs = tscen.build_relay_scenario(horizon=48, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.topology_oracle(rs.topo, rs.demand, ttop.optimize_routing(rs.topo, rs.demand))


# ---------------------------------------------------------------------------
# Mirrors of the reference's theory tests (tests/test_theory.py), on the port
# ---------------------------------------------------------------------------

P = tpri.make_scenario("gcp", "aws")
SMALL = _params(tpri, "flat")


def _opt(params, d, head_start=True):
    """The port's scalar DP, held bit for bit to the batched one on the row."""
    costs = tcost.hourly_cost_series(params, d)
    r = torc.offline_optimal(params, costs=costs, allow_head_start=head_start)
    total, start_on = _batched(costs.vpn[None], costs.cci[None], [params.D],
                               [params.T_cci], head_start)
    assert _same_float(total[0], r.total_cost) and bool(start_on[0]) == r.start_on
    return r


@pytest.mark.parametrize("scale", [0.05, 0.2, 0.4, 0.6])
def test_property1_low_demand_exact_optimality(scale):
    """Below the activation threshold, ToggleCCI == all-VPN == OPT."""
    d = np.full(3000, scale * tpri.breakeven_rate_gb_per_hour(P))
    res = ttog.run_togglecci(P, d)
    opt = _opt(P, d)
    if scale == 0.2:
        assert (res.x == 0).all(), "must never leave VPN"
        assert res.total_cost == pytest.approx(opt.total_cost, rel=1e-12)
    if (res.x == 0).all():
        assert res.total_cost <= opt.total_cost * (1 + 1e-12) + 1e-9


def test_property1_high_demand_gap_bounded_by_gamma():
    d = np.full(6000, 20 * tpri.breakeven_rate_gb_per_hour(P))
    res = ttog.run_togglecci(P, d)
    opt = _opt(P, d)
    assert opt.start_on
    costs = tcost.hourly_cost_series(P, d)
    w = P.h + P.D
    gamma = float(np.sum(costs.vpn[:w] - costs.cci[:w]))
    assert 0 <= res.total_cost - opt.total_cost <= gamma + 1e-6


def test_property1_high_demand_ratio_to_one():
    rate = 20 * tpri.breakeven_rate_gb_per_hour(P)
    ratios = []
    for T in (2000, 8000, 16000):
        d = np.full(T, rate)
        ratios.append(ttog.run_togglecci(P, d).total_cost / _opt(P, d).total_cost)
    assert ratios[0] > ratios[1] > ratios[2]
    assert ratios[2] < 1.05, "asymptotically optimal"


@pytest.mark.parametrize("alpha", [2.0, 10.0, 100.0])
def test_theorem1_unbounded_ratio(alpha):
    inst = tadv.instance_for_ratio(alpha)
    policies = dict(tbase.BASELINES)
    policies["togglecci"] = lambda p, d: ttog.run_togglecci(p, d).x
    for name, pol in policies.items():
        r_spike = tadv.ratio_of_policy(pol, inst.params, inst.demand_spike)
        r_silent = tadv.ratio_of_policy(pol, inst.params, inst.demand_silent)
        assert max(r_spike, r_silent) > alpha, (name, r_spike, r_silent)


def test_theorem1_branches():
    """Branch A punishes VPN-leaning algs; branch B punishes CCI-leaning."""
    inst = tadv.instance_for_ratio(5.0)
    assert tadv.ratio_of_policy(tbase.always_vpn, inst.params, inst.demand_spike) > 5.0
    assert tadv.ratio_of_policy(tbase.always_cci, inst.params, inst.demand_silent) == np.inf


def _random_trace(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1e4, size=int(rng.integers(20, 300)))
    d[rng.random(d.size) < 0.3] = 0.0
    return d


@pytest.mark.parametrize("seed", range(6))
def test_oracle_lower_bounds_random_schedules(seed):
    d = _random_trace(seed)
    costs = tcost.hourly_cost_series(SMALL, d)
    opt = _opt(SMALL, d)
    rng = np.random.default_rng(seed)
    for _ in range(5):   # random *feasible* schedules: requests honor D and T_cci
        x = np.zeros(len(d), dtype=np.int64)
        t = 0
        while t < len(d):
            if rng.random() < 0.1:
                on_start = t + SMALL.D
                on_end = min(len(d), on_start + SMALL.T_cci + rng.integers(0, 50))
                if on_start < len(d):
                    x[on_start:on_end] = 1
                t = on_end
            else:
                t += 1
        assert opt.total_cost <= tcost.evaluate_schedule(SMALL, d, x, costs=costs) + 1e-9


@pytest.mark.parametrize("seed", range(6))
def test_oracle_lower_bounds_policies(seed):
    d = _random_trace(100 + seed)
    costs = tcost.hourly_cost_series(SMALL, d)
    opt = _opt(SMALL, d).total_cost
    for name, pol in tbase.BASELINES.items():
        assert opt <= tcost.evaluate_schedule(SMALL, d, pol(SMALL, d), costs=costs) + 1e-9, name
    assert opt <= ttog.run_togglecci(SMALL, d, costs=costs).total_cost + 1e-9


def test_oracle_no_head_start_is_weakly_worse():
    d = np.full(2000, 20 * tpri.breakeven_rate_gb_per_hour(P))
    assert _opt(P, d, True).total_cost <= _opt(P, d, False).total_cost + 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_matches_brute_force_tiny(seed):
    """DP == brute force over all feasible schedules on an 8-hour horizon."""
    params = tpri.CostParams(2.0, 0.0, 0.01, 0.05, tpri.flat_rate(0.2), D=1, T_cci=2, h=2)
    d = np.random.default_rng(seed).uniform(0, 50, size=8)
    costs = tcost.hourly_cost_series(params, d)
    best = np.inf

    def rec(t, state, tstate, cost):
        nonlocal best
        if t == len(d):
            best = min(best, cost)
            return
        vpn, cci = costs.vpn[t], costs.cci[t]
        if state == 0:          # OFF: stay, or request (one WAITING hour)
            rec(t + 1, 0, 0, cost + vpn)
            rec(t + 1, 2, 1, cost + vpn)
        elif state == 2:        # first committed hour
            rec(t + 1, 3, 1, cost + cci)
        elif state == 3:        # committed ON
            rec(t + 1, 3 if tstate + 1 < params.T_cci else 4,
                tstate + 1 if tstate + 1 < params.T_cci else 0, cost + cci)
        else:                   # free ON: stay or release
            rec(t + 1, 4, 0, cost + cci)
            rec(t + 1, 0, 0, cost + vpn)

    rec(0, 0, 0, 0.0)
    rec(0, 4, 0, 0.0)           # the head start: already ON, free
    assert _opt(params, d).total_cost == pytest.approx(best)
