"""Port vs JAX package for the observability layer's parts.

* the metrics ring: the port's ``update_ring`` (torch, on the CPU) against
  JAX's on the same numpy inputs from a seed, fleet and topology, with and
  without a forecast, on a value exactly on a histogram edge, a NaN realized
  cost, a month volume exactly on a tier bound and a single tier: counts
  exact, float fields ``rtol=1e-12`` (the two packages sum in different
  orders); ``update_ring_chunk`` against K ``update_ring`` calls, every bit;
  the layout round trip, ``prev_state`` across a reset, the tenant helpers;
* ``TraceRecorder``, ``trace_from_plan`` and ``TickProfiler`` against the
  reference's on the same state streams: every event, export and summary;
* each contract monitor on the same corrupted or biased streams as
  ``tests/test_obs.py``'s monitor cases, both runtimes side by side: the port
  raises ``ContractViolation`` where JAX raises (the same monitor, row, hour
  and text) and passes where it passes; ``TenantSLOMonitor`` on the same
  drains; the regret oracle (one ``oracle_dp`` call) against
  ``offline_optimal`` row by row, every bit.
"""
import json

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (aliases enable_x64 before repro imports)

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro import obs as jobs
from repro.core.costmodel import HourlyCosts as JHourlyCosts
from repro.core.oracle import offline_optimal as joffline_optimal
from repro.fleet import plan as jplan
from repro.fleet.policy import fit_cost_coef as jfit_cost_coef
from repro.fleet.stream import FleetRuntime as JFleetRuntime

from repro_torch import obs
from repro_torch.core.togglecci import OFF, ON, WAITING
from repro_torch.fleet import (FleetRuntime, build_fleet_scenario, build_topology_scenario,
                               forecast_gated_policy, optimize_routing)
from repro_torch.fleet import observe
from repro_torch.kernels import ops

STATES = (OFF, WAITING, ON)
FLOAT_RTOL = 1e-12
COUNTS = ("ticks", "requests", "activations", "releases", "cost_hist")


def test_namespaces_export_the_reference_names():
    """``repro_torch.obs`` and ``repro_torch.fleet.observe`` export every name
    of ``repro.obs.__all__`` (and the chunk-wide ring update)."""
    want = set(jobs.__all__)
    assert want <= set(obs.__all__) and want <= set(observe.__all__)
    assert set(obs.__all__) - want == {"update_ring_chunk"}
    for name in obs.__all__:
        assert getattr(observe, name) is getattr(obs, name)


# ---------------------------------------------------------------------------
# The ring against JAX's
# ---------------------------------------------------------------------------


def _ticks(seed, M, P, n, *, pred):
    """``n`` ticks of random ring inputs (numpy)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        st = rng.choice(STATES, size=M).astype(np.int32)
        out.append({
            "x": (st == ON).astype(np.int32), "state": st,
            "vpn": rng.uniform(0.0, 500.0, M), "cci": rng.uniform(0.0, 500.0, M),
            "d_pair": rng.uniform(0.0, 300.0, P), "d_row": rng.uniform(0.0, 300.0, M),
            "month_cum": rng.uniform(0.0, 3000.0, P),
            "pred": rng.uniform(0.0, 300.0, M) if pred else None,
        })
    return out


def _plant(ticks, edges, bounds):
    """The edge cases, in the first tick: a VPN cost exactly on a histogram
    edge (row served on VPN), a NaN CCI cost on a row served on CCI, a month
    volume exactly on a tier bound."""
    tk = ticks[0]
    tk["state"][:2] = (OFF, ON)
    tk["x"][:2] = (0, 1)
    tk["vpn"][0] = edges[2]
    tk["cci"][1] = np.nan
    if bounds.shape[1] > 1:
        tk["month_cum"][2] = bounds[2, 0]


def _run_jax(ticks, edges, bounds, cap, routing_idx):
    B, Kt = edges.shape[0] - 1, bounds.shape[1]
    M = ticks[0]["state"].shape[0]
    with enable_x64():
        ring = jobs.init_ring(M, cap, B, Kt)
        for tk in ticks:
            ring = jobs.update_ring(
                ring, jnp.asarray(edges), x_t=jnp.asarray(tk["x"]),
                state_t=jnp.asarray(tk["state"]), vpn_t=jnp.asarray(tk["vpn"]),
                cci_t=jnp.asarray(tk["cci"]), d_pair=jnp.asarray(tk["d_pair"]),
                d_row=jnp.asarray(tk["d_row"]), month_cum=jnp.asarray(tk["month_cum"]),
                tier_bounds=jnp.asarray(bounds),
                routing_idx=None if routing_idx is None else jnp.asarray(routing_idx, jnp.int32),
                pred_t=None if tk["pred"] is None else jnp.asarray(tk["pred"]))
        return np.asarray(jobs.flatten_ring(ring)), np.asarray(ring.prev_state)


def _port_ring(ticks, edges, bounds, cap, routing_idx, ring=None):
    B, Kt = edges.shape[0] - 1, bounds.shape[1]
    M = ticks[0]["state"].shape[0]
    T = torch.from_numpy
    ring = obs.init_ring(M, cap, B, Kt) if ring is None else ring
    for tk in ticks:
        ring = obs.update_ring(
            ring, edges, x_t=T(tk["x"]), state_t=T(tk["state"]), vpn_t=T(tk["vpn"]),
            cci_t=T(tk["cci"]), d_pair=T(tk["d_pair"]), d_row=T(tk["d_row"]),
            month_cum=T(tk["month_cum"]), tier_bounds=T(bounds),
            routing_idx=None if routing_idx is None else T(routing_idx),
            pred_t=None if tk["pred"] is None else T(tk["pred"]))
    return ring


def _assert_drains(got, want, *, rtol=FLOAT_RTOL):
    """Two DrainedMetrics: counts exact, float fields within ``rtol`` (NaN in
    the same places)."""
    a, b = got.to_json(), want.to_json()
    assert a.keys() == b.keys()
    for k in a:
        if k in COUNTS or k == "hour":
            assert a[k] == b[k], k
        else:
            np.testing.assert_allclose(np.asarray(a[k], float), np.asarray(b[k], float),
                                       rtol=rtol, atol=0, err_msg=k)


RING_CASES = {   # topology, forecast, tiers
    "fleet": (False, False, 4),
    "fleet-pred": (False, True, 3),
    "topology-pred": (True, True, 4),
    "topology": (True, False, 2),
    "one-tier": (False, False, 1),
    "topology-one-tier": (True, True, 1),
}


@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_update_ring_matches_jax(case):
    topology, pred, Kt = RING_CASES[case]
    rng = np.random.default_rng(len(case))
    M, cap, B = 6, 5, 7
    P = 9 if topology else M
    routing_idx = rng.integers(0, M, P) if topology else None
    edges = obs.default_hist_edges(B, 1e-1, 1e3)
    np.testing.assert_array_equal(edges, jobs.default_hist_edges(B, 1e-1, 1e3))
    bounds = np.sort(rng.uniform(100, 2500, (P, Kt)), axis=1)
    bounds[:, -1] = np.inf
    ticks = _ticks(len(case) + 1, M, P, cap, pred=pred)
    _plant(ticks, edges, bounds)
    want, want_prev = _run_jax(ticks, edges, bounds, cap, routing_idx)
    ring = _port_ring(ticks, edges, bounds, cap, routing_idx)
    got = obs.flatten_ring(ring).numpy()
    np.testing.assert_array_equal(ring.prev_state.numpy(), want_prev)
    kw = dict(cap=cap, n_bins=B, n_tiers=Kt)
    g = obs.DrainedMetrics.from_flat(7, got, **kw)
    w = jobs.DrainedMetrics.from_flat(7, want, **kw)
    _assert_drains(g, w)
    assert g.cost_hist[1] >= 1                  # the edge value stayed in the lower bin
    assert np.isnan(g.realized_cost[0])         # the NaN cost is summed ...
    assert g.cost_hist.sum() == M * cap         # ... and binned (bin 0)
    if not pred:
        assert not g.pred_total.any() and not g.forecast_abs_err.any()


@pytest.mark.parametrize("rows", [(6, 9), (48, 64), (300, 2100)], ids=["6", "48", "300"])
@pytest.mark.parametrize("K", [1, 7, 24])
@pytest.mark.parametrize("topology,pred", [(False, False), (True, True), (False, True)])
def test_update_ring_chunk_is_k_update_ring_calls(K, topology, pred, rows):
    """Bit for bit, from a ring already five ticks into its window, with NaN
    and edge values among the inputs, at a few row counts (a float sum's
    algorithm may depend on the row length, never on K)."""
    rng = np.random.default_rng(K)
    M, B, Kt, cap = rows[0], 9, 4, 40
    P = rows[1] if topology else M
    routing_idx = rng.integers(0, M, P) if topology else None
    edges = obs.default_hist_edges(B)
    bounds = np.sort(rng.uniform(100, 2500, (P, Kt)), axis=1)
    bounds[:, -1] = np.inf
    head = _ticks(1, M, P, 5, pred=pred)
    ticks = _ticks(2, M, P, K, pred=pred)
    _plant(ticks, edges, bounds)
    ticks[-1]["d_pair"][3] = np.nan
    start = _port_ring(head, edges, bounds, cap, routing_idx)
    want = _port_ring(ticks, edges, bounds, cap, routing_idx, ring=start)
    plane = lambda k: torch.from_numpy(np.stack([tk[k] for tk in ticks]))
    got = obs.update_ring_chunk(
        start, edges, x_t=plane("x"), state_t=plane("state"), vpn_t=plane("vpn"),
        cci_t=plane("cci"), d_pair=plane("d_pair"), d_row=plane("d_row"),
        month_cum=plane("month_cum"), tier_bounds=torch.from_numpy(bounds),
        routing_idx=None if routing_idx is None else torch.from_numpy(routing_idx),
        pred_t=plane("pred") if pred else None)
    cost = torch.where(plane("x") == 1, plane("cci"), plane("vpn"))
    given = obs.update_ring_chunk(
        start, edges, x_t=plane("x"), state_t=plane("state"), vpn_t=plane("vpn"),
        cci_t=plane("cci"), d_pair=plane("d_pair"), d_row=plane("d_row"),
        month_cum=plane("month_cum"), tier_bounds=torch.from_numpy(bounds),
        routing_idx=None if routing_idx is None else torch.from_numpy(routing_idx),
        pred_t=plane("pred") if pred else None, cost_t=cost)
    for ring in (got, given):
        for a, b, name in zip(ring, want, want._fields):
            assert a.dtype == b.dtype and torch.equal(a.nan_to_num(-7.0), b.nan_to_num(-7.0)), name
            assert torch.equal(a.isnan(), b.isnan()), name


def test_update_ring_chunk_refuses_to_overrun_the_window():
    ring = obs.init_ring(2, 3, 4, 1)
    z = torch.zeros((4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="overrun"):
        obs.update_ring_chunk(ring, obs.default_hist_edges(4), x_t=z, state_t=z, vpn_t=z,
                              cci_t=z, d_pair=z, d_row=z, month_cum=z,
                              tier_bounds=torch.full((2, 1), np.inf))


def test_ring_layout_roundtrip_and_reset_carry():
    """The layout is the reference's; a flattened ring unpacks to its fields;
    a reset keeps ``prev_state`` (a WAITING → ON edge across a drain is an
    activation, not a second request), as JAX's does."""
    assert obs.ring_layout(3, 4, 2) == jobs.ring_layout(3, 4, 2)
    assert obs.ring_size(3, 4, 2) == jobs.ring_size(3, 4, 2)
    M, cap, B, Kt = 3, 2, 4, 2
    edges = obs.default_hist_edges(B)
    bounds = np.tile([50.0, np.inf], (M, 1))
    z = np.zeros(M)
    tick = lambda st: {"x": (np.asarray(st) == ON).astype(np.int32),
                       "state": np.asarray(st, np.int32), "vpn": z, "cci": z, "d_pair": z,
                       "d_row": z, "month_cum": z, "pred": None}
    first = [tick([WAITING, OFF, OFF]), tick([WAITING, OFF, OFF])]
    ring = _port_ring(first, edges, bounds, cap, None)
    a = obs.DrainedMetrics.from_flat(2, obs.flatten_ring(ring), cap=cap, n_bins=B, n_tiers=Kt)
    ring = obs.reset_ring(ring)
    assert int(ring.small.abs().sum()) == 0 and ring.prev_state.tolist() == [WAITING, OFF, OFF]
    ring = _port_ring([tick([ON, OFF, OFF])], edges, bounds, cap, None, ring=ring)
    b = obs.DrainedMetrics.from_flat(3, obs.flatten_ring(ring), cap=cap, n_bins=B, n_tiers=Kt)
    assert (a.requests, a.activations, a.releases, a.ticks) == (1, 0, 0, 2)
    assert (b.requests, b.activations, b.releases, b.ticks) == (0, 1, 0, 1)
    # The same two windows through JAX's ring.
    with enable_x64():
        jr = jobs.init_ring(M, cap, B, Kt)
        for tk in first:
            jr = jobs.update_ring(jr, jnp.asarray(edges), x_t=jnp.asarray(tk["x"]),
                                  state_t=jnp.asarray(tk["state"]), vpn_t=jnp.asarray(z),
                                  cci_t=jnp.asarray(z), d_pair=jnp.asarray(z),
                                  d_row=jnp.asarray(z), month_cum=jnp.asarray(z),
                                  tier_bounds=jnp.asarray(bounds))
        ja = jobs.DrainedMetrics.from_flat(2, np.asarray(jobs.flatten_ring(jr)), cap=cap,
                                           n_bins=B, n_tiers=Kt)
    _assert_drains(a, ja)
    assert a.to_json() == ja.to_json() and json.dumps(a.to_json())
    hist = np.array([3.0, 1.0, 0.0, 4.0])
    dm = obs.DrainedMetrics.from_flat(0, np.r_[np.zeros(5 + 8 * cap), hist, 0.0, 0.0], cap=cap,
                                      n_bins=B, n_tiers=Kt)
    jdm = jobs.DrainedMetrics.from_flat(0, np.r_[np.zeros(5 + 8 * cap), hist, 0.0, 0.0],
                                        cap=cap, n_bins=B, n_tiers=Kt)
    assert dm.cost_quantiles(edges) == jdm.cost_quantiles(edges)


def test_tenant_ring_helpers_match_jax():
    """The pooled ring's shapes and values, and a slot reset, as JAX's."""
    port = obs.init_tenant_ring(3, 4, 5, 6, 2)
    with enable_x64():
        jr = jobs.init_tenant_ring(3, 4, 5, 6, 2)
        for a, b in zip(port, jr):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert a.numpy().dtype == np.asarray(b).dtype
        filled = obs.MetricsRing(port.small + 2.0, port.prev_state + ON, port.gauges + 1.5)
        jfilled = jobs.MetricsRing(jr.small + 2.0, jr.prev_state + ON, jr.gauges + 1.5)
        got = obs.reset_ring_slot(filled, 1)
        want = jobs.reset_ring_slot(jfilled, 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(filled.small[1].sum()) > 0            # the input is untouched


# ---------------------------------------------------------------------------
# Trace recorder and profiler against the reference's
# ---------------------------------------------------------------------------


def _state_stream(seed, rows, T):
    """FSM state sequences with real lifecycles: OFF, then WAITING for a few
    hours (or straight to ON), ON, back to OFF; and one WAITING → OFF edge."""
    rng = np.random.default_rng(seed)
    st = np.full((rows, T), OFF, np.int64)
    for r in range(rows):
        t = int(rng.integers(0, 6))
        while t < T:
            wait = int(rng.integers(0, 4))
            st[r, t:t + wait] = WAITING
            on = int(rng.integers(1, 9))
            st[r, t + wait:t + wait + on] = ON
            t += wait + on + int(rng.integers(1, 7))
    st[0, 3:5] = (WAITING, OFF)
    return st


def test_trace_recorder_matches_the_reference(tmp_path):
    states = _state_stream(0, 5, 60)
    a = obs.TraceRecorder(5, hour_us=250.0, kind="port")
    b = jobs.TraceRecorder(5, hour_us=250.0, kind="port")
    for t in range(states.shape[1]):
        a.observe_states(t, states[:, t])
        b.observe_states(t, states[:, t])
        if t in (20, 41):
            for rec in (a, b):
                rec.instant(t, "reroute", moved_pairs=2, pairs=5)
                rec.counter(t, "lease_on", {"rows": 1.5})
    assert a.events == b.events and a.n_events == b.n_events > 20
    assert any(e.get("event") == "edge1->0" for e in a.events)
    assert a.chrome_trace() == b.chrome_trace()
    for save in ("save_chrome", "save_jsonl"):
        pa, pb = tmp_path / f"a_{save}", tmp_path / f"b_{save}"
        getattr(a, save)(str(pa))
        getattr(b, save)(str(pb))
        assert pa.read_text() == pb.read_text()


def test_trace_from_plan_matches_the_reference():
    states = _state_stream(1, 4, 80)
    a = obs.trace_from_plan(torch.from_numpy(states), kind="link", row_names=list("abcd"))
    b = jobs.trace_from_plan(states, kind="link", row_names=list("abcd"))
    assert a.events == b.events and a.chrome_trace() == b.chrome_trace()
    c = obs.trace_from_plan(states, kind="link", row_names=list("abcd"))
    assert c.events == a.events


def test_tick_profiler_matches_the_reference():
    a, b = obs.TickProfiler(), jobs.TickProfiler()
    assert np.isnan(a.percentiles()["p50"])
    for p in (a, b):
        for dt in (1e-3, 2e-3, 3e-3):
            p.record(dt, 100, 200)
        p.record_chunk(0.024, 1000, 2000, 24)
        p.note_drain()
        p.note_compile()
    assert a.summary() == b.summary()
    assert a.summary()["chunks"] == 1 and a.summary()["ticks"] == 27


# ---------------------------------------------------------------------------
# Contract monitors: both runtimes on the same streams
# ---------------------------------------------------------------------------


def _fleets(n=6, horizon=220, seed=0):
    jsc = jplan.build_fleet_scenario(n, horizon=horizon, history_hours=100, seed=seed)
    sc = build_fleet_scenario(n, horizon=horizon, history_hours=100, seed=seed)
    assert np.array_equal(jsc.demand, sc.demand)
    return jsc, sc


def _both(cfg, jcfg, n=6, horizon=220, hours=None):
    """Both runtimes on the same fleet, streamed per tick over ``hours``."""
    jsc, sc = _fleets(n, horizon)
    jrt = JFleetRuntime(jsc.fleet, obs=jcfg)
    rt = FleetRuntime(sc.fleet, obs=cfg, device="cpu")
    T = sc.demand.shape[1] if hours is None else hours
    jrt.run(jsc.demand[:, :T])
    rt.run(sc.demand[:, :T])
    return jrt, rt, sc


def _raises_alike(jrt, rt, match, **kw):
    """Both ``obs_check`` calls raise, with the same violation."""
    with pytest.raises(jobs.ContractViolation, match=match) as je:
        jrt.obs_check(**kw)
    with pytest.raises(obs.ContractViolation, match=match) as pe:
        rt.obs_check(**kw)
    j, p = je.value, pe.value
    assert (p.monitor, p.row, p.hour) == (j.monitor, j.row, j.hour)
    assert str(p) in [str(v) for v in rt.obs.violations]
    return p, j


def _cfgs(**kw):
    return obs.ObsConfig(**kw), jobs.ObsConfig(**kw)


def test_clean_stream_all_monitors_pass_alike():
    jrt, rt, _ = _both(*_cfgs(cadence=32, divergence=True))
    jrt.obs_check(final=True)
    rt.obs_check(final=True)
    rep, jrep = rt.obs_report(), jrt.obs_report()
    assert rep.violations == jrep.violations == []
    assert rep.monitors["billing"]["checks"] == jrep.monitors["billing"]["checks"] > 0
    assert rep.monitors["divergence"] == jrep.monitors["divergence"]


def test_billing_monitor_fires_alike_on_a_corrupted_accumulator():
    jrt, rt, _ = _both(*_cfgs(cadence=32))
    jrt._state.vpn_pref[2] *= 1.01
    rt._state.vpn_pref[2] *= 1.01
    p, j = _raises_alike(jrt, rt, "billing")
    assert p.row == 2 and p.details["accumulator"] == "vpn_pref" == j.details["accumulator"]


def test_billing_monitor_fires_alike_on_a_drained_total_mismatch():
    jrt, rt, _ = _both(*_cfgs(cadence=32))
    jrt.obs.billing.dev["realized"] *= 1.5
    rt.obs.billing.dev["realized"] *= 1.5
    _raises_alike(jrt, rt, "realized")


def test_divergence_monitor_fires_alike_on_a_flipped_decision():
    jrt, rt, _ = _both(*_cfgs(cadence=64, divergence=True))
    for m in (jrt.obs.divergence, rt.obs.divergence):
        m.x[40] = 1 - m.x[40]
    p, _ = _raises_alike(jrt, rt, "diverged")
    assert p.monitor == "divergence" and p.hour == 40


def test_divergence_monitor_covers_a_mid_stream_reroute_alike():
    """Topology mode: the recorded routing schedule feeds the offline replay
    (the port's ``replay_plan_topology``), so a clean stream with a reroute
    reconciles in both packages."""
    jsc = jplan.build_topology_scenario(8, n_facilities=3, horizon=200, seed=1)
    sc = build_topology_scenario(8, n_facilities=3, horizon=200, seed=1)
    j0, r0 = jplan.optimize_routing(jsc.topo, jsc.demand), optimize_routing(sc.topo, sc.demand)
    assert j0.paths == r0.paths
    idx = np.asarray(r0.primary).copy()
    for i, pr in enumerate(sc.topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others:
            idx[i] = int(others[0])
            break
    assert not np.array_equal(idx, r0.primary)
    j1, r1 = jsc.topo.plan(idx), sc.topo.plan(idx)
    cfg, jcfg = _cfgs(cadence=32, divergence=True)
    jrt = JFleetRuntime(jsc.topo, routing=j0, obs=jcfg)
    rt = FleetRuntime(sc.topo, routing=r0, obs=cfg, device="cpu")
    for t in range(sc.demand.shape[1]):
        if t == 100:
            jrt.reroute(j1)
            rt.reroute(r1)
        jrt.step(jsc.demand[:, t])
        rt.step(sc.demand[:, t])
    jrt.obs_check(final=True)
    rt.obs_check(final=True)
    assert rt.obs.divergence.summary() == jrt.obs.divergence.summary()
    assert rt.obs.divergence.summary()["routing_segments"] == 2
    reroutes = [e for e in rt.obs.trace.events if e["type"] == "reroute"]
    assert reroutes == [e for e in jrt.obs.trace.events if e["type"] == "reroute"]
    assert reroutes[0]["hour"] == 100 and reroutes[0]["moved_pairs"] == 1
    rt.obs.divergence.state[150] = np.where(rt.obs.divergence.state[150] == ON, OFF, ON)
    with pytest.raises(obs.ContractViolation, match="diverged"):
        rt.obs_check()


def test_divergence_monitor_disables_alike_on_endogenous_demand():
    jsc, sc = _fleets()
    for rt, d in ((JFleetRuntime(jsc.fleet, obs=jobs.ObsConfig(cadence=32, divergence=True)),
                   jsc.demand),
                  (FleetRuntime(sc.fleet, obs=obs.ObsConfig(cadence=32, divergence=True),
                                device="cpu"), sc.demand)):
        rt.step(d[:, 0], cci_demand_t=d[:, 0] * 0.25)
        s = rt.obs.divergence.summary()
        assert s["enabled"] is False and "endogenous" in s["reason"]
        rt.obs_check()


def test_regret_monitor_fires_alike_on_an_injected_overrun():
    jrt, rt, _ = _both(*_cfgs(cadence=32, max_regret_vs_static=1.0))
    jrt.obs_check(final=True)
    rt.obs_check(final=True)
    jrt.obs.regret.realized *= 3.0
    rt.obs.regret.realized *= 3.0
    p, j = _raises_alike(jrt, rt, "best-static", final=True)
    assert p.details["regret_vs_static"] == pytest.approx(j.details["regret_vs_static"],
                                                          rel=1e-9)


def test_regret_monitor_oracle_ratio_fires_alike():
    jrt, rt, _ = _both(*_cfgs(cadence=64, max_oracle_ratio=2.0), n=3, horizon=150)
    ops.reset_launches()
    jrt.obs_check(final=True)
    rt.obs_check(final=True)
    assert rt.obs.regret.oracle_ratio == pytest.approx(jrt.obs.regret.oracle_ratio, rel=1e-12)
    assert rt.obs.regret.oracle_ratio >= 0.999
    jrt.obs.regret.realized *= 3.0
    rt.obs.regret.realized *= 3.0
    _raises_alike(jrt, rt, "oracle", final=True)


def test_regret_oracle_is_one_oracle_dp_call_equal_to_offline_optimal():
    """``oracle_cost`` hands every row's recorded series to one
    ``ops.oracle_dp`` call; each total equals the reference's
    ``offline_optimal`` on the row (as ``RegretMonitor`` loops it), every
    bit."""
    jsc, sc = _fleets(n=8, horizon=300)
    rt = FleetRuntime(sc.fleet, obs=obs.ObsConfig(cadence=60, max_oracle_ratio=10.0),
                      device="cpu")
    rt.run(sc.demand)
    calls = []
    real = ops.oracle_dp
    try:
        ops.oracle_dp = lambda *a, **k: calls.append(a) or real(*a, **k)
        got = rt.obs.regret.oracle_cost()
    finally:
        ops.oracle_dp = real
    assert len(calls) == 1 and calls[0][0].shape == (8, 300)
    reg = rt.obs.regret
    vpn, cci = np.stack(reg.vpn_hist, 1), np.stack(reg.cci_hist, 1)
    zeros = np.zeros(vpn.shape[1])
    with enable_x64():
        want = [joffline_optimal(
            type("P", (), {"D": int(reg.D[m]), "T_cci": int(reg.T_cci[m])})(),
            costs=JHourlyCosts(vpn_lease=zeros, vpn_transfer=vpn[m], cci_lease=zeros,
                               cci_transfer=cci[m])).total_cost for m in range(8)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float64))


def test_calibration_monitor_fires_alike_on_a_biased_forecast():
    """A replay-mode policy fed 3x the demand: both runtimes raise at the
    first drain (hour 32), inside ``run``."""
    jsc, sc = _fleets()
    base = FleetRuntime(sc.fleet, device="cpu").run(sc.demand)
    arrays = sc.fleet.stack(torch.float64, "cpu")
    from repro_torch.fleet import fit_cost_coef

    coef = fit_cost_coef(torch.from_numpy(sc.demand), torch.from_numpy(base["vpn_cost"]),
                         torch.from_numpy(base["cci_cost"])).numpy()
    pol = forecast_gated_policy(arrays.toggle, sc.demand * 3.0, margin=0.05, cost_coef=coef)
    with enable_x64():
        jarr = jsc.fleet.stack(jnp.float64)
        jcoef = np.asarray(jfit_cost_coef(jnp.asarray(jsc.demand),
                                          jnp.asarray(base["vpn_cost"]),
                                          jnp.asarray(base["cci_cost"])))
        jpol = jplan.forecast_gated_policy(jarr.toggle, jsc.demand * 3.0, margin=0.05,
                                           cost_coef=jcoef)
    np.testing.assert_allclose(coef, jcoef, rtol=1e-9)
    cfg, jcfg = _cfgs(cadence=32, max_forecast_bias=1.5)
    ort = FleetRuntime(arrays, policy=pol, hours_per_month=sc.fleet.hours_per_month, obs=cfg,
                       device="cpu")
    jort = JFleetRuntime(jarr, policy=jpol, hours_per_month=jsc.fleet.hours_per_month,
                         obs=jcfg)
    with pytest.raises(jobs.ContractViolation, match="bias") as je:
        jort.run(jsc.demand)
    with pytest.raises(obs.ContractViolation, match="bias") as pe:
        ort.run(sc.demand)
    assert pe.value.monitor == "calibration" and ort.t == jort.t == 32
    assert pe.value.details["bias"] == pytest.approx(je.value.details["bias"], rel=1e-9)
    assert pe.value.details["bias"] > 1.5


def test_calibration_monitor_inactive_alike_for_memoryless_policies():
    jrt, rt, _ = _both(*_cfgs(cadence=32, max_forecast_bias=1.01), hours=40)
    jrt.obs_check()
    rt.obs_check()
    s = rt.obs.calibration.summary()
    assert s == jrt.obs.calibration.summary()
    assert s["enabled"] is False and "forecast" in s["reason"]


def _drain(rng, ticks=8, hist=6, tiers=2, scale=1.0):
    vec = np.r_[ticks, 0, 0, 0, 5.0, rng.uniform(0, 10, 8 * ticks) * scale,
                np.zeros(hist), np.zeros(tiers)]
    return vec, dict(cap=ticks, n_bins=hist, n_tiers=tiers)


def test_tenant_slo_monitor_matches_the_reference():
    """The gateway's per-tenant reconciler, on the same drains: the same
    recorded violations (billing drift, an SLO breach) and summaries."""
    rng = np.random.default_rng(5)
    port = obs.TenantSLOMonitor("t0", max_hourly_cost=30.0)
    ref = jobs.TenantSLOMonitor("t0", max_hourly_cost=30.0)
    host = {"realized": 0.0, "vpn": 0.0, "cci": 0.0, "gb": 0.0}
    for i, scale in enumerate((1.0, 1.0, 8.0)):
        vec, kw = _drain(rng, scale=scale)
        dm = obs.DrainedMetrics.from_flat(8 * (i + 1), vec, **kw)
        jdm = jobs.DrainedMetrics.from_flat(8 * (i + 1), vec, **kw)
        host = {"realized": host["realized"] + dm.realized_cost.sum(),
                "vpn": host["vpn"] + dm.vpn_cost.sum(), "cci": host["cci"] + dm.cci_cost.sum(),
                "gb": host["gb"] + dm.billed_gb.sum() * (1.1 if i == 1 else 1.0)}
        got = port.on_drain(dm.hour, dm, host_totals=host)
        want = ref.on_drain(jdm.hour, jdm, host_totals=host)
        assert [str(v) for v in got] == [str(v) for v in want]
        assert [v.details for v in got] == [v.details for v in want]
        assert all(isinstance(v, obs.ContractViolation) for v in got)
        assert bool(got) == (i > 0)
    assert port.summary() == ref.summary()
