"""``FleetRuntime(obs=...)`` in the port, against itself and the JAX runtime.

With observability on, the port's runtime updates the metrics ring on the
host after each chunk (``repro_torch.obs.metrics``) and fans each hour out
to the trace, the monitors and the profiler. Held on the CPU:

* observability is a pure consumer: decisions, costs and the carried
  prefixes with it on equal the stream with it off, bit for bit, in fleet and
  topology mode, per tick and in chunks of K = 7 and 24, reactive, replay and
  live, across a ``reroute()``; and the honest stream passes every monitor;
* the drains fire at the JAX runtime's hours with its windows: counts exact,
  float fields within ``rtol=1e-9`` (``COST_RTOL``, the two packages' sums
  differ in order), live-mode calibration gauges within ``PRED_RTOL``
  (``tests/test_torch_stream_live.py``'s); the ``ObsReport`` fields equal
  JAX's apart from ``profile``, the traces' lease events equal;
* a chunked stream drains what a per-tick stream drains, bit for bit;
* the refusals (a chunk across a drain hour, an ``obs`` with no cadence, a
  report without ``obs=``) and ``ElasticFleetPlanner(obs=True)``'s
  sync-domain instants, fleet and per port, against JAX's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU

import jax
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro import obs as jobs
from repro.core import planner as jplanner
from repro.fleet import plan as jplan
from repro.fleet import runtime as jrt
from repro.fleet.policy import forecast_gated_policy as jforecast_gated_policy
from repro.fleet.spec import fleet_from_params as jfleet_from_params

from repro_torch import obs
from repro_torch.core import planner
from repro_torch.core.togglecci import OFF, ON
from repro_torch.fleet import (ElasticFleetPlanner, FleetRuntime, RuntimeConfig,
                               StreamingForecaster, build_fleet_scenario,
                               build_topology_scenario, fit_cost_coef, forecast_gated_policy,
                               optimize_routing)
from repro_torch.fleet.engine import routed_cost_series
from repro_torch.fleet.spec import fleet_from_params
from repro_torch.models.convert import tree_from_reference
from repro_torch.models.ssm import demand_forecaster_init

N_LINKS, N_PAIRS, HOURS, HISTORY = 8, 10, 240, 120
SWAP = 168                      # a chunk boundary for every K in {1, 7, 24}
COST_RTOL = 1e-9
PRED_RTOL = 1e-5
FIELDS = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
CARRIES = ("dcum", "dcum_month", "vpn_pref", "cci_pref")
COUNTS = ("hour", "ticks", "requests", "activations", "releases", "cost_hist")
CALIBRATION = ("forecast_abs_err", "pred_total")


# -- scenarios and policies (both packages from one seed) ------------------------

@functools.lru_cache(maxsize=None)
def _fleet():
    jsc = jplan.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=0)
    sc = build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=0)
    assert np.array_equal(jsc.demand, sc.demand) and np.array_equal(jsc.history, sc.history)
    return jsc, sc, sc.fleet.stack(torch.float64, CPU)


@functools.lru_cache(maxsize=None)
def _topology():
    jsc = jplan.build_topology_scenario(N_PAIRS, n_facilities=3, horizon=HOURS,
                                        history_hours=HISTORY, seed=1)
    sc = build_topology_scenario(N_PAIRS, n_facilities=3, horizon=HOURS,
                                 history_hours=HISTORY, seed=1)
    assert np.array_equal(jsc.demand, sc.demand)
    r0, j0 = optimize_routing(sc.topo, sc.demand), jplan.optimize_routing(jsc.topo, jsc.demand)
    assert r0.paths == j0.paths
    idx = np.asarray(r0.primary).copy()
    moved = 0
    for i, pr in enumerate(sc.topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others and moved < 3:
            idx[i], moved = others[0], moved + 1
    assert moved
    return jsc, sc, (j0, jsc.topo.plan(idx)), (r0, sc.topo.plan(idx))


def _series(mode):
    """The history's per-row demand and cost series on the CPU (the live
    policy's coefficient fit, as ``streaming_forecast_policy`` does it)."""
    if mode == "fleet":
        _, sc, arrays = _fleet()
        hist = sc.history
    else:
        _, sc, _, (r0, _) = _topology()
        arrays, hist = sc.topo.stack(r0, torch.float64, CPU), sc.history
    return arrays, routed_cost_series(arrays, hist, hours_per_month=730, device="cpu")


@functools.lru_cache(maxsize=None)
def _policy(mode, kind):
    """The port's policy of ``kind`` for ``mode`` (None: the spec's reactive
    kind), and a live forecaster: the seeded readout warmed through the
    history's row demand."""
    if kind == "reactive":
        return None, None
    arrays, s = _series(mode)
    coef = fit_cost_coef(s.row_demand, s.vpn, s.cci).numpy()
    M = coef.shape[0]
    margins = np.resize(np.array([0.05, 0.0, 0.15]), M)
    if kind == "replay":
        rng = np.random.default_rng(3)
        pred = s.row_demand.numpy().mean(1, keepdims=True) * rng.uniform(0.2, 3.0, (M, HOURS))
        return forecast_gated_policy(arrays.toggle, pred, margin=margins, cost_coef=coef), None
    rng = np.random.default_rng(8)
    params = dict(demand_forecaster_init(None, 8, device="cpu"),
                  w=torch.tensor(0.3 * rng.standard_normal(8), dtype=torch.float32),
                  bias=torch.tensor(0.05, dtype=torch.float32))
    fc = StreamingForecaster.from_history(params, s.row_demand.numpy(), device="cpu")
    pol = forecast_gated_policy(arrays.toggle, np.zeros(M), margin=margins, cost_coef=coef)
    return pol, fc


def _runtime(mode, kind, obs_cfg):
    pol, fc = _policy(mode, kind)
    if mode == "fleet":
        sc = _fleet()[1]
        return FleetRuntime(sc.fleet, policy=pol, forecaster=fc, obs=obs_cfg, device="cpu")
    _, sc, _, (r0, _) = _topology()
    return FleetRuntime(sc.topo, routing=r0, policy=pol, forecaster=fc, obs=obs_cfg,
                        device="cpu")


def _stream(rt, demand, swap=None, *, K):
    """Chunks of K (K = 1: per tick), a per-tick tail, ``rt.reroute(swap[1])``
    at hour ``swap[0]``; outputs stacked to (rows, T)."""
    T = demand.shape[1]
    outs, t = [], 0
    while t < T:
        if swap is not None and t == swap[0]:
            rt.reroute(swap[1])
        if K > 1 and t + K <= T:
            outs.append(rt.step_many(demand[:, t:t + K]))
            t += K
        else:
            outs.append({k: v[:, None] for k, v in rt.step(demand[:, t]).items()})
            t += 1
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}


def _demand_and_swap(mode, port=True):
    if mode == "fleet":
        jsc, sc, _ = _fleet()
        return (sc if port else jsc).demand, None
    jsc, sc, (_, j1), (_, r1) = _topology()
    return (sc if port else jsc).demand, (SWAP, r1 if port else j1)


# -- observability is a pure consumer ----------------------------------------------

ONOFF = [(m, k, K) for m in ("fleet", "topology") for k in ("reactive", "replay", "live")
         for K in (1, 7, 24)]


@pytest.mark.parametrize("mode,kind,K", ONOFF, ids=[f"{m}-{k}-K{K}" for m, k, K in ONOFF])
def test_obs_on_off_bit_exact(mode, kind, K):
    """Every output field, the carried host prefixes and the FSM carry equal
    the stream without observability, bit for bit (drains every 3K hours:
    they interleave with the chunks); the honest stream passes every
    monitor, the divergence replay included where it applies."""
    demand, swap = _demand_and_swap(mode)
    plain_rt = _runtime(mode, kind, None)
    plain = _stream(plain_rt, demand, swap, K=K)
    cadence = 3 * K if K > 1 else 7
    ort = _runtime(mode, kind, obs.ObsConfig(cadence=cadence, divergence=True))
    traced = _stream(ort, demand, swap, K=K)
    assert traced.keys() == plain.keys()
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)
    for k in CARRIES:
        np.testing.assert_array_equal(getattr(ort._state, k), getattr(plain_rt._state, k),
                                      err_msg=k)
    assert torch.equal(ort._state.fsm, plain_rt._state.fsm)
    ort.obs_check(final=True)
    rep = ort.obs_report()
    assert rep.hours == HOURS and rep.violations == [] and rep.drains == -(-HOURS // cadence)
    div = rep.monitors["divergence"]
    assert div["enabled"] == (kind != "live")
    assert div["checks"] == (kind != "live")
    if swap is not None and kind != "live":
        assert div["routing_segments"] == 2
    assert rep.monitors["calibration"]["enabled"] == (kind != "reactive")


# -- against the JAX runtime --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_live(mode):
    """JAX's live policy and forecaster (``streaming_forecast_policy``, 3
    training steps) and the port's twins carried across."""
    if mode == "fleet":
        jsc, sc, arrays = _fleet()
        with enable_x64():
            jarr = jsc.fleet.stack(jnp.float64)
    else:
        jsc, sc, (j0, _), (r0, _) = _topology()
        arrays = sc.topo.stack(r0, torch.float64, CPU)
        with enable_x64():
            jarr = jsc.topo.stack(j0, jnp.float64)
    jpol, jfc = jrt.streaming_forecast_policy(jarr, jsc.history, steps=3)
    fc = StreamingForecaster(
        params=tree_from_reference(jax.tree.map(np.asarray, jfc.params), device=CPU),
        scale=np.asarray(jfc.scale), h0=np.asarray(jfc.h0), pred0=np.asarray(jfc.pred0))
    pol = forecast_gated_policy(arrays.toggle, np.zeros(np.asarray(jpol.cost_coef).shape[0]),
                                margin=0.05, cost_coef=np.asarray(jpol.cost_coef))
    return jpol, jfc, pol, fc


def _pair(mode, kind, cfg_kw):
    """Both runtimes of ``mode`` streaming the same policy of ``kind``."""
    jcfg, cfg = jobs.ObsConfig(**cfg_kw), obs.ObsConfig(**cfg_kw)
    jsc, sc = (_fleet() if mode == "fleet" else _topology())[:2]
    jkw, kw = {}, {}
    if mode == "topology":
        jkw["routing"], kw["routing"] = _topology()[2][0], _topology()[3][0]
    if kind == "replay":
        pol, _ = _policy(mode, "replay")
        with enable_x64():
            if mode == "fleet":
                jtog = jsc.fleet.stack(jnp.float64).toggle
            else:
                jtog = jsc.topo.stack(jkw["routing"], jnp.float64).toggle
            jpol = jforecast_gated_policy(jtog, pol.pred_demand.numpy(),
                                          margin=pol.margin.numpy(),
                                          cost_coef=pol.cost_coef.numpy())
        jkw["policy"], kw["policy"] = jpol, pol
    elif kind == "live":
        jpol, jfc, pol, fc = _jax_live(mode)
        jkw.update(policy=jpol, forecaster=jfc)
        kw.update(policy=pol, forecaster=fc)
    spec, jspec = (sc.fleet, jsc.fleet) if mode == "fleet" else (sc.topo, jsc.topo)
    return (jrt.FleetRuntime(jspec, obs=jcfg, **jkw),
            FleetRuntime(spec, obs=cfg, device="cpu", **kw))


def _close(a, b, rtol, where):
    """Recursive equality of report values: ints, strings, None exactly,
    floats within ``rtol``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _close(a[k], b[k], rtol, f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, rtol, f"{where}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=where)
    else:
        assert a == b, where


JAX_RUNS = {   # mode, policy, K, extra ObsConfig
    "fleet-reactive-K24": ("fleet", "reactive", 24, dict(max_oracle_ratio=10.0)),
    "fleet-reactive-step": ("fleet", "reactive", 1, dict(max_regret_vs_static=5.0)),
    "fleet-replay-K7": ("fleet", "replay", 7, {}),
    "fleet-live-K24": ("fleet", "live", 24, dict(max_forecast_bias=1e4)),
    "topology-reactive-K24": ("topology", "reactive", 24, dict(max_oracle_ratio=10.0)),
    "topology-live-step": ("topology", "live", 1, {}),
}


@pytest.mark.parametrize("case", sorted(JAX_RUNS))
def test_drains_and_report_match_the_jax_runtime(case):
    mode, kind, K, extra = JAX_RUNS[case]
    cadence = 72 if K == 24 else (21 if K == 7 else 64)
    jr, rt = _pair(mode, kind, dict(cadence=cadence, divergence=True, **extra))
    want = _stream(jr, *_demand_and_swap(mode, port=False), K=K)
    got = _stream(rt, *_demand_and_swap(mode), K=K)
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    np.testing.assert_array_equal(got["state"], np.asarray(want["state"]))
    jr.obs_check(final=True)
    rt.obs_check(final=True)
    jd, pd = jr.obs.drained, rt.obs.drained
    assert [d.hour for d in pd] == [d.hour for d in jd]
    assert len(pd) == -(-HOURS // cadence)
    for g, w in zip(pd, jd):
        a, b = g.to_json(), w.to_json()
        for k in a:
            if k in COUNTS:
                assert a[k] == b[k], (g.hour, k)
            else:
                rtol = PRED_RTOL if (kind == "live" and k in CALIBRATION) else COST_RTOL
                np.testing.assert_allclose(np.asarray(a[k], float), np.asarray(b[k], float),
                                           rtol=rtol, atol=0, err_msg=f"{g.hour}:{k}")
    if kind == "live":
        assert any(d.pred_total.any() for d in pd)
    rep, jrep = rt.obs_report(), jr.obs_report()
    for f in dataclasses.fields(rep):
        if f.name != "profile":
            rtol = PRED_RTOL if (kind == "live" and f.name == "monitors") else COST_RTOL
            _close(getattr(rep, f.name), getattr(jrep, f.name), rtol, f.name)
    assert rep.profile["ticks"] == HOURS and rep.profile["compiles"] == 0
    assert rep.profile["chunks"] == (HOURS // K if K > 1 else 0)
    toggles = lambda r: [e for e in r.obs.trace.events if e["type"] == "toggle"]
    assert toggles(rt) == toggles(jr) and toggles(rt)
    if mode == "topology":
        reroute = lambda r: [e for e in r.obs.trace.events if e["type"] == "reroute"]
        assert reroute(rt) == reroute(jr) and reroute(rt)[0]["hour"] == SWAP


@pytest.mark.parametrize("mode", ["fleet", "topology"])
def test_chunked_drains_equal_per_tick_drains(mode):
    """K = 24 chunks (and a mixed stream of 24, 1 and 23) against per-tick
    steps at cadence 72: every drained vector and monitor summary, bit for
    bit."""
    demand, swap = _demand_and_swap(mode)

    def drains(Ks):
        rt = _runtime(mode, "replay", obs.ObsConfig(cadence=72, max_oracle_ratio=10.0))
        t, i = 0, 0
        while t < HOURS:
            if swap is not None and t == swap[0]:
                rt.reroute(swap[1])
            k = min(Ks[i % len(Ks)], HOURS - t, (t // 72 + 1) * 72 - t)
            i += 1
            if k == 1:
                rt.step(demand[:, t])
            else:
                rt.step_many(demand[:, t:t + k])
            t += k
        rt.obs_check(final=True)
        return [d.to_json() for d in rt.obs.drained], rt.obs.monitor_summaries()

    want = drains((1,))
    assert drains((24,)) == want
    assert drains((24, 1, 23)) == want
    assert len(want[0]) == 4


def test_report_aggregates_match_the_outputs_and_reset_starts_afresh():
    """``tests/test_obs.py``'s aggregate checks on the port's own stream:
    lease counts from the state matrix, totals from the outputs, the volume
    split closing, the profile; ``reset()`` starts a fresh run."""
    sc = _fleet()[1]
    rt = FleetRuntime(sc.fleet, obs=obs.ObsConfig(cadence=64), device="cpu")
    out = _stream(rt, sc.demand, K=1)
    rep = rt.obs_report()
    st = np.concatenate([np.full((rt.n_rows, 1), OFF), out["state"]], axis=1)
    prev, cur = st[:, :-1], st[:, 1:]
    assert rep.requests == int(np.sum((prev == OFF) & (cur != OFF)))
    assert rep.activations == int(np.sum((prev != ON) & (cur == ON)))
    assert rep.releases == int(np.sum((prev == ON) & (cur == OFF)))
    assert rep.hours == HOURS and rep.drains == 4      # 3 drains + the report's flush
    assert rep.realized_cost == pytest.approx(out["cost"].sum(), rel=1e-9)
    d_clip = np.minimum(sc.demand, rt.arrays.capacity.numpy()[:, None])
    assert rep.billed_gb == pytest.approx(d_clip.sum(), rel=1e-9)
    assert sum(rep.vpn_tier_gb) + rep.cci_path_gb == pytest.approx(rep.billed_gb, rel=1e-9)
    assert rep.lease_on_mean == pytest.approx(np.mean(out["x"].sum(axis=0)))
    p = rep.profile
    assert p["ticks"] == HOURS and p["drains"] == 4 and p["h2d_bytes"] > 0 < p["d2h_bytes"]
    assert "observability report" in rep.render_text() and rep.trace_events > 0
    rt.reset()
    assert rt.obs.profiler.ticks == 0 and rt.obs.drained == [] and rt.t == 0
    assert int(rt._state.metrics.small.abs().sum()) == 0
    assert (rt._state.metrics.prev_state == OFF).all()


def test_refusals_match_the_reference():
    """A chunk across a drain hour is refused before anything runs (ValueError
    where JAX asserts, as the port's other refusals); an ``obs`` with no
    cadence is the reference's TypeError; no report or check without
    ``obs=``."""
    sc = _fleet()[1]
    rt = FleetRuntime(sc.fleet, obs=obs.ObsConfig(cadence=10), device="cpu")
    rt.step_many(sc.demand[:, :6])
    with pytest.raises(ValueError, match="obs drain cadence 10 falls mid-chunk"):
        rt.step_many(sc.demand[:, 6:12])
    assert rt.t == 6 and int(rt._state.metrics.small[0]) == 6
    rt.step_many(sc.demand[:, 6:10])                      # ends on the drain hour
    assert [d.hour for d in rt.obs.drained] == [10]
    with pytest.raises(TypeError, match="ObsConfig-like object with a drain cadence") as pe:
        RuntimeConfig(obs=3).validate()
    with pytest.raises(TypeError) as je:
        jrt.RuntimeConfig(obs=3).validate()
    assert str(pe.value) == str(je.value)
    for ok in (None, True, False, obs.ObsConfig(cadence=5)):
        RuntimeConfig(obs=ok).validate()
    plain = FleetRuntime(sc.fleet, device="cpu")
    for call in (plain.obs_report, plain.obs_check):
        with pytest.raises(ValueError, match="without obs="):
            call()
    assert FleetRuntime(sc.fleet, device="cpu", obs=False).obs is None


def _domains(pl):
    return [e for e in pl.runtime.obs.trace.events if e["type"] == "sync_domains"]


def test_elastic_planner_sync_domain_instants_match_jax():
    """Fleet mode (the two-link DCI fleet, a hot link leasing) and per port
    (the topology scenario, a reroute mid-stream): the traced sync-domain
    changes equal JAX's, hour for hour."""
    fleet = fleet_from_params([planner.dci_scenario(), planner.dci_scenario()])
    jfleet = jfleet_from_params([jplanner.dci_scenario(), jplanner.dci_scenario()])
    pl = ElasticFleetPlanner(fleet, device="cpu", obs=True)
    jpl = jrt.ElasticFleetPlanner(jfleet, obs=True)
    traffic = np.tile([1e9, 200e12], (300, 1))
    traffic[150:, 1] = 1e9
    for b in traffic:
        assert pl.feed_hour(b) == jpl.feed_hour(b)
    assert _domains(pl) == _domains(jpl) and len(_domains(pl)) >= 2
    jsc, sc, (j0, j1), (r0, r1) = _topology()
    pl = ElasticFleetPlanner(sc.topo, routing=r0, device="cpu", obs=True)
    jpl = jrt.ElasticFleetPlanner(jsc.topo, routing=j0, obs=True)
    for t in range(HOURS):
        if t == SWAP:
            pl.runtime.reroute(r1)
            jpl.runtime.reroute(j1)
        b = sc.demand[:, t] * 16e9
        assert pl.feed_hour(b) == jpl.feed_hour(b)
    assert _domains(pl) == _domains(jpl) and len(_domains(pl)) >= 2
