"""Port vs JAX package for the fleet and topology reports and the offline
stream oracle.

Each package's report is fed its own package's plan of the same scenario
(built by both from one seed; ≤ 1200 hours), on the CPU. The OPT columns
(``fleet_oracle``/``topology_oracle``, the batched DP) and the event
timelines are held exactly; per-row and total costs that come out of a plan
at ``rtol=1e-9`` (XLA's float64 cumsum and fused adds are not PyTorch's
sequential, unfused CPU arithmetic; ``tests/test_torch_fleet.py`` holds the
plans so), and so are the savings the reports derive from them
(``relay_savings``, ``tree_sharing_savings``, ``lease_sharing_savings``,
``routing_improvement``). Decisions, ``requests``, ``releases``,
``on_fraction``, ``move_mix`` and refined routings are equal. The reference's
own report tests (``tests/test_fleet.py``, ``tests/test_multihop.py``, the
report columns of ``tests/test_policy.py``), which fail at collection on JAX
0.9.0, are mirrored on the port.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU  # the enable_x64 alias, before repro

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.fleet import engine as jeng
from repro.fleet import report as jrep
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.plan import forecast_topology_policy

from repro_torch.fleet import engine as teng
from repro_torch.fleet import policy as tpol
from repro_torch.fleet import report as trep
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import topology as ttop
from repro_torch.fleet.plan import TopologyScenario
from repro_torch.kernels import ops

RTOL = 1e-9
HORIZON = 1200


@functools.lru_cache(maxsize=None)
def _fleet(seed: int, n: int = 6):
    jsc = jscen.build_fleet_scenario(n, horizon=HORIZON, seed=seed)
    tsc = tscen.build_fleet_scenario(n, horizon=HORIZON, seed=seed)
    return jsc, jeng.plan_fleet(jsc.fleet, jsc.demand), tsc, teng.plan_fleet(
        tsc.fleet, tsc.demand, device=CPU)


TOPOLOGIES = {
    "relay": lambda m: m.build_relay_scenario(horizon=HORIZON, seed=0),
    "multicast": lambda m: m.build_multicast_scenario(n_leaves=4, horizon=HORIZON, seed=0),
    "topology": lambda m: m.build_topology_scenario(
        12, n_facilities=3, ports_per_facility=2, horizon=HORIZON, seed=4),
}


@functools.lru_cache(maxsize=None)
def _topology(case: str):
    jsc, tsc = TOPOLOGIES[case](jscen), TOPOLOGIES[case](tscen)
    jr = jtop.optimize_routing(jsc.topo, jsc.demand)
    tr = ttop.optimize_routing(tsc.topo, tsc.demand)
    assert tr.paths == jr.paths
    return (jsc, jr, jeng.plan_topology(jsc.topo, jsc.demand, routing=jr),
            tsc, tr, teng.plan_topology(tsc.topo, tsc.demand, routing=tr, device=CPU))


def _close(got: float, want: float) -> bool:
    return got == pytest.approx(want, rel=RTOL, abs=0)


# ---------------------------------------------------------------------------
# Event timelines
# ---------------------------------------------------------------------------


def test_toggle_events_and_lease_intervals_match_jax():
    """On every link's planned state trace, and on hand-made traces that end
    WAITING, end leased, and request at hour 0 straight into ON (D = 0)."""
    _, jplan, _, tplan = _fleet(7)
    rows = list(np.asarray(jplan["state"]))
    rows += [np.array(r) for r in ([1, 1, 2, 2, 0, 1], [2, 2, 0, 0, 1, 1, 2],
                                   [0, 1, 1, 2, 2, 2], [0, 0, 0], [2])]
    n_events = 0
    for s in rows:
        assert trep.toggle_events(s) == jrep.toggle_events(s)
        assert trep.lease_intervals(s) == jrep.lease_intervals(s)
        n_events += len(trep.lease_intervals(s))
    assert n_events >= 8   # the traces hold leases to compare
    for i, s in enumerate(tplan["state"]):   # the port's own plan, as a tensor row
        assert trep.toggle_events(s.numpy()) == jrep.toggle_events(rows[i])


# ---------------------------------------------------------------------------
# The fleet report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("oracle_links", [None, 4], ids=["all", "first-4"])
def test_fleet_report_matches_jax(oracle_links):
    jsc, jplan, tsc, tplan = _fleet(11)
    want = jrep.build_report(jsc, jplan, include_oracle=True, oracle_links=oracle_links)
    got = trep.build_report(tsc, tplan, include_oracle=True, oracle_links=oracle_links,
                            device=CPU)
    assert got.horizon == want.horizon and len(got.links) == len(want.links)
    for g, w in zip(got.links, want.links):
        assert (g.name, g.family, g.requests, g.releases, g.on_fraction, g.oracle_cost) == \
            (w.name, w.family, w.requests, w.releases, w.on_fraction, w.oracle_cost)
        for k in ("toggle_cost", "static_vpn", "static_cci", "best_static"):
            assert _close(getattr(g, k), getattr(w, k)), k
    assert got.totals.keys() == want.totals.keys()
    for k, v in got.totals.items():
        assert _close(v, want.totals[k]), k
    assert ("oracle" in got.totals) == (oracle_links is None)
    assert got.render_text(max_rows=4) == want.render_text(max_rows=4)


def test_report_aggregates_and_oracle_bound():
    """Mirror of tests/test_fleet.py::test_report_aggregates_and_oracle_bound."""
    sc = tscen.build_fleet_scenario(6, horizon=1600, seed=11)
    plan = teng.plan_fleet(sc.fleet, sc.demand, device=CPU)
    rep = trep.build_report(sc, plan, include_oracle=True, device=CPU)
    assert len(rep.links) == 6
    t = rep.totals
    assert t["togglecci"] == pytest.approx(sum(link.toggle_cost for link in rep.links))
    for link in rep.links:   # OPT lower-bounds every policy, per link and in aggregate
        assert link.oracle_cost is not None
        assert link.oracle_cost <= link.toggle_cost * (1 + 1e-9)
        assert link.oracle_cost <= link.best_static * (1 + 1e-9)
        assert link.competitive_ratio >= 1.0 - 1e-9
    assert "oracle" in t
    text = rep.render_text()
    assert "fleet total" in text and rep.links[0].name in text


# ---------------------------------------------------------------------------
# The topology report
# ---------------------------------------------------------------------------


def _assert_topology_report(got, want):
    assert got.horizon == want.horizon and got.routing.paths == want.routing.paths
    for g, w in zip(got.ports, want.ports):
        assert (g.name, g.facility, g.n_pairs, g.requests, g.releases, g.on_fraction,
                g.oracle_cost) == (w.name, w.facility, w.n_pairs, w.requests, w.releases,
                                   w.on_fraction, w.oracle_cost)
        for k in ("toggle_cost", "static_vpn", "static_cci"):
            assert _close(getattr(g, k), getattr(w, k)), k
    assert got.totals.keys() == want.totals.keys()
    for k, v in got.totals.items():
        assert _close(v, want.totals[k]), k
    assert got.refine_move_mix == want.refine_move_mix
    assert (got.refined_routing is None) == (want.refined_routing is None)
    if got.refined_routing is not None:
        assert got.refined_routing.paths == want.refined_routing.paths


@pytest.mark.parametrize("case", sorted(TOPOLOGIES))
def test_topology_report_matches_jax(case):
    """Savings, oracle gap and per-port columns; ``relay_savings`` 0.3785 and
    ``tree_sharing_savings`` 0.1101 at 1200 h, the JAX report's."""
    jsc, jr, jplan, tsc, tr, tplan = _topology(case)
    want = jrep.build_topology_report(jsc, jplan, jr, include_oracle=True)
    got = trep.build_topology_report(tsc, tplan, tr, include_oracle=True, device=CPU)
    _assert_topology_report(got, want)
    t = got.totals
    assert t["oracle"] <= t["togglecci"] * (1 + 1e-9) and t["oracle_gap"] >= 1.0
    assert 0.0 < t["lease_sharing_savings"] < 1.0
    if case == "relay":
        assert abs(t["relay_savings"] - 0.3785) < 1e-4
    if case == "multicast":
        assert abs(t["tree_sharing_savings"] - 0.1101) < 1e-4
    assert got.render_text() == want.render_text()


def test_topology_report_refine_matches_jax():
    """``refine=True`` from the relay scenario's 1-hop routing: the refined
    routing (a relay move), its move mix, ``refined_cost`` and
    ``routing_improvement``."""
    jsc, _, _, tsc, _, _ = _topology("relay")
    jr = jtop.optimize_routing(jsc.topo, jsc.demand, max_hops=1)
    tr = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=1)
    jplan = jeng.plan_topology(jsc.topo, jsc.demand, routing=jr)
    tplan = teng.plan_topology(tsc.topo, tsc.demand, routing=tr, device=CPU)
    kw = dict(include_dedicated_baseline=False, refine=True, refine_max_moves=3)
    want = jrep.build_topology_report(jsc, jplan, jr, **kw)
    got = trep.build_topology_report(tsc, tplan, tr, device=CPU, **kw)
    _assert_topology_report(got, want)
    assert got.refine_move_mix["relay"] >= 1 and got.refined_routing.hop_depth >= 2
    assert got.totals["routing_improvement"] > 0.0


@functools.lru_cache(maxsize=None)
def _forecast_policy():
    """tests/test_policy.py::test_report_forecast_and_refinement_columns's
    scenario and the JAX forecast-gated policy on the greedy routing
    (``forecast_topology_policy`` trains the forecaster, which the port
    cannot yet: ROADMAP item 6c)."""
    build = lambda m: m.build_topology_scenario(
        8, n_facilities=2, horizon=800, history_hours=400, families=("bursty",), seed=6)
    jsc, tsc = build(jscen), build(tscen)
    jr = jtop.optimize_routing(jsc.topo, jsc.demand)
    with enable_x64():
        arrays = jsc.topo.stack(jr, jnp.float64)
    fpol = forecast_topology_policy(arrays, jsc.demand, jsc.history, steps=60)
    return jsc, tsc, jr, arrays, fpol


@functools.lru_cache(maxsize=None)
def _forecast_case():
    """The JAX forecast-gated plan of :func:`_forecast_policy` (the report
    takes any plan's outputs as its forecast column)."""
    jsc, tsc, jr, arrays, fpol = _forecast_policy()
    fplan = jeng.plan_topology(arrays, jsc.demand, policy=fpol,
                               hours_per_month=jsc.topo.hours_per_month)
    return jsc, tsc, jr, {k: np.asarray(v) for k, v in fplan.items()}


def test_topology_report_takes_the_ports_own_forecast_plan():
    """The port's own forecast-gated plan, built on the port's routing from
    the JAX policy's carried predictions, cost coefficients and margins,
    equals the JAX forecast plan (decisions exactly, costs ``rtol=1e-9``)
    and fills the report's forecast column as the JAX plan fills JAX's."""
    jsc, tsc, jr, _, fpol = _forecast_policy()
    _, _, _, jfplan = _forecast_case()
    tr = ttop.optimize_routing(tsc.topo, tsc.demand)
    arrays = tsc.topo.stack(tr, torch.float64, CPU)
    pol = tpol.forecast_gated_policy(
        arrays.toggle, np.asarray(fpol.pred_demand), margin=np.asarray(fpol.margin),
        cost_coef=np.asarray(fpol.cost_coef))
    tfplan = teng.plan_topology(arrays, tsc.demand, policy=pol, device=CPU)
    for k in ("x", "state"):
        np.testing.assert_array_equal(tfplan[k].numpy(), jfplan[k], err_msg=k)
    np.testing.assert_allclose(tfplan["toggle_cost"].numpy(), jfplan["toggle_cost"], rtol=RTOL)
    assert 0 < int(tfplan["x"].sum()) < tfplan["x"].numel()
    jplan = jeng.plan_topology(jsc.topo, jsc.demand, routing=jr)
    tplan = teng.plan_topology(tsc.topo, tsc.demand, routing=tr, device=CPU)
    want = jrep.build_topology_report(jsc, jplan, jr, include_oracle=True, forecast_plan=jfplan)
    rep = trep.build_topology_report(tsc, tplan, tr, include_oracle=True, forecast_plan=tfplan,
                                     device=CPU)
    _assert_topology_report(rep, want)
    assert "forecast_gain" in rep.totals
    assert rep.render_text() == want.render_text()


def test_topology_report_forecast_and_refinement_columns_match_jax():
    """Mirror of tests/test_policy.py::test_report_forecast_and_refinement_columns
    on the port, against the JAX report fed the same forecast plan."""
    jsc, tsc, jr, fplan = _forecast_case()
    tr = ttop.optimize_routing(tsc.topo, tsc.demand)
    assert tr.paths == jr.paths
    jplan = jeng.plan_topology(jsc.topo, jsc.demand, routing=jr)
    tplan = teng.plan_topology(tsc.topo, tsc.demand, routing=tr, device=CPU)
    kw = dict(include_oracle=True, forecast_plan=fplan, refine=True, refine_max_moves=2)
    want = jrep.build_topology_report(jsc, jplan, jr, **kw)
    rep = trep.build_topology_report(tsc, tplan, tr, device=CPU, **kw)
    _assert_topology_report(rep, want)
    t = rep.totals
    assert "forecast" in t and "forecast_gain" in t
    assert "refined_cost" in t and "routing_improvement" in t
    assert t["refined_cost"] <= t["togglecci"] + 1e-6
    assert t["oracle"] <= t["forecast"] * (1 + 1e-9)
    for p, w in zip(rep.ports, want.ports):
        assert p.forecast_cost == w.forecast_cost is not None
        assert _close(p.forecast_gain, w.forecast_gain)
    text = rep.render_text()
    assert "forecast-gated" in text and "refined routing" in text
    assert text == want.render_text()

    # A spec whose default policy kind the engine cannot resolve ("forecast")
    # still refines: the refinement replan is explicitly reactive.
    sc2 = dataclasses.replace(tsc, topo=dataclasses.replace(tsc.topo, policy="forecast"))
    rep2 = trep.build_topology_report(sc2, fplan, tr, include_dedicated_baseline=False,
                                      refine=True, refine_max_moves=1, device=CPU)
    assert rep2.totals["refined_cost"] <= rep2.refine_base_cost + 1e-6


def test_relay_path_beats_direct_by_5pct():
    """Mirror of tests/test_multihop.py::test_relay_path_beats_direct_by_5pct."""
    _, _, _, sc, routing, plan = _topology("relay")
    assert routing.hop_depth >= 2, "the planner must take the relay"
    totals = trep.build_topology_report(sc, plan, routing, device=CPU).totals
    assert totals["relay_savings"] >= 0.05


def test_tree_beats_per_leaf_unicast():
    """Mirror of tests/test_multihop.py::test_tree_beats_per_leaf_unicast: the
    report's baseline equals the explicit per-leaf expansion's report."""
    _, _, _, sc, routing, plan = _topology("multicast")
    (tree_row,) = sc.topo.tree_row_indices()
    assert len(routing.paths[tree_row]) >= 1 and routing.tree_rows == (tree_row,)
    totals = trep.build_topology_report(sc, plan, routing, device=CPU).totals
    assert totals["tree_sharing_savings"] > 0.0
    etopo, row_map = ttop.multicast_unicast_expansion(sc.topo)
    d_uni = np.asarray(sc.demand)[row_map]
    uni_routing = ttop.optimize_routing(etopo, d_uni, max_hops=1)
    uni_plan = teng.plan_topology(etopo, d_uni, routing=uni_routing, device=CPU)
    uni_sc = TopologyScenario(topo=etopo, demand=d_uni, horizon=sc.horizon)
    uni = trep.build_topology_report(uni_sc, uni_plan, uni_routing, device=CPU).totals
    assert totals["togglecci"] < uni["togglecci"]
    assert abs(totals["tree_sharing_savings"] - (1.0 - totals["togglecci"] / uni["togglecci"])) \
        < 1e-6


def test_reports_raise_without_cuda(monkeypatch):
    """No device and no CUDA: the reports' oracles and replans raise instead
    of running on the CPU."""
    _, _, _, tsc, tr, tplan = _topology("relay")
    _, _, fsc, fplan = _fleet(11)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trep.build_report(fsc, fplan, include_oracle=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trep.build_topology_report(tsc, tplan, tr)
    assert trep.build_report(fsc, fplan).totals["togglecci"] > 0   # no OPT column: no device


# ---------------------------------------------------------------------------
# The offline stream oracle
# ---------------------------------------------------------------------------


def test_offline_stream_oracle_fleet_mode_matches_jax():
    from test_torch_support import jax_fleet_dict
    from repro_torch.fleet.spec import fleet_arrays_from_numpy

    jsc, _, tsc, _ = _fleet(3)
    with enable_x64():
        jarr = jsc.fleet.stack(jnp.float64)
    tarr = fleet_arrays_from_numpy(jax_fleet_dict(jarr), CPU)
    want = jeng.offline_stream_oracle(jarr, jsc.demand)
    got = teng.offline_stream_oracle(tarr, tsc.demand, device=CPU)
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("toggle_cost", "static_vpn", "static_cci"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, err_msg=k)
    with pytest.raises(ValueError, match="no routing schedule"):
        teng.offline_stream_oracle(tarr, tsc.demand, schedule=[(0, None)], device=CPU)


def test_offline_stream_oracle_topology_mode_matches_jax():
    """A routing schedule (1-hop routing, then the relay from hour 600) and
    the default one-segment schedule, which is ``plan_topology`` itself."""
    jsc, jr, jplan, tsc, tr, tplan = _topology("relay")
    j1 = jtop.optimize_routing(jsc.topo, jsc.demand, max_hops=1)
    t1 = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=1)
    with enable_x64():
        jarr = jsc.topo.stack(jr, jnp.float64)
    tarr = tsc.topo.stack(tr, torch.float64, CPU)
    ops.reset_launches()
    one = teng.offline_stream_oracle(tarr, tsc.demand, device=CPU)
    for k in ("x", "state", "toggle_cost"):
        assert torch.equal(one[k], tplan[k]), k
    want = jeng.offline_stream_oracle(jarr, jsc.demand, schedule=[(0, j1), (600, jr)])
    got = teng.offline_stream_oracle(tarr, tsc.demand, schedule=[(0, t1), (600, tr)],
                                     device=CPU)
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("toggle_cost", "vpn_hourly", "cci_hourly"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, err_msg=k)
    assert not torch.equal(got["x"], one["x"])
