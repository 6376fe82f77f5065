"""The forecast-gated policy streamed in replay mode, port vs port and port vs JAX.

A :class:`ForecastGatedPolicy` with its ``cost_coef`` given streams through
the port's ``FleetRuntime``: the predicted mode costs are formed once, at
construction, by the offline planners' own call, and each chunk's gates read
them at hour ``min(t, T_pred − 1)``. On the CPU the runtime runs the chunk
kernels' plain versions (``stream_chunk_ref``, ``stream_chunk_routed_ref``)
with their gate. Inputs follow the reference's ``_policies_for``
(``tests/test_fleet_runtime.py:86-106``): noisy predictions, coefficients
fitted on the stream's own cost series, margin 0.05 and per-row margins.

Held:

* the CPU stream against the port's CPU ``plan_fleet`` (fleet mode) and
  ``replay_plan_topology`` (topology mode, a two-segment schedule with
  ``reroute()`` at hour 137 or 400): every bit of ``x``, ``state`` and the
  float64 costs, per tick, in chunks of K = 1–5 (the card's tick form), of
  K = 6–30 (its chunk form) and in mixed chunkings; with endogenous CCI
  demand (which no offline planner prices) against ``policy_scan`` on the
  stream's own cost series, bit for bit;
* against JAX's ``FleetRuntime.step_many`` in replay mode, fleet and
  topology (across a reroute): decisions equal, costs within ``rtol=1e-9``
  (``exp``/``log1p`` and XLA's fused multiply-adds may differ in the last
  place), NaN predictions and a stream longer than ``T_pred`` included;
* margin 1e30 against the reactive stream, every bit;
* the resolver's refusals: ``cost_coef=None`` (the reference's text),
  ``pred_demand`` of the wrong shape, and ``forecaster=`` of the wrong type
  (the reference's TypeError; live mode is ``tests/test_torch_stream_live.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.fleet import policy as jpol
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.stream import FleetRuntime as JFleetRuntime

from repro_torch.fleet import (
    FleetRuntime,
    RuntimeConfig,
    build_fleet_scenario,
    build_topology_scenario,
    fit_cost_coef,
    forecast_gated_policy,
    optimize_routing,
    plan_fleet,
    plan_topology,
    policy_scan,
    replay_plan_topology,
    resolve_runtime_operands,
)
from repro_torch.kernels import ops

N_LINKS, HOURS = 8, 600
COST_RTOL = 1e-9
FIELDS = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
MIXED = (5, 1, 24, 1, 1, 37, 49, 12, 3, 30, 7)


def _noisy_forward_means(rng, demand):
    """Predictions as the reference's tests make them: regime-switching
    rows, scaled, with no tie to the demand (how they were derived is
    irrelevant to exactness)."""
    n, T = demand.shape
    d = np.empty((n, T))
    for i in range(n):
        row = np.full(T, rng.uniform(0, 400))
        for _ in range(int(rng.integers(1, 6))):
            a, b = np.sort(rng.integers(0, T, size=2))
            row[a:b] = rng.uniform(0, 4000)
        d[i] = row * rng.uniform(0.8, 1.2, size=T)
    return d * rng.uniform(0.3, 1.2)


def _stream(rt, demand, K, cci=None, swaps=()):
    """Stream (rows, T) through ``rt``: K an int (chunks of K, a per-tick tail;
    K = 1 per tick throughout) or a tuple of chunk lengths cycled; chunks end
    at every ``(hour, plan)`` of ``swaps``, where ``rt.reroute(plan)`` runs."""
    T = demand.shape[1]
    ks = (K,) if isinstance(K, int) else K
    blk = lambda a, b: None if cci is None else cci[:, a:b]
    swaps = dict(swaps)
    outs, t, i = [], 0, 0
    while t < T:
        if t in swaps:
            rt.reroute(swaps[t])
        nxt = min([s for s in swaps if s > t] + [T])
        k = min(ks[i % len(ks)], nxt - t)
        i += 1
        if k == 1:
            c = None if cci is None else cci[:, t]
            outs.append({k_: v[:, None] for k_, v in
                         rt.step(demand[:, t], cci_demand_t=c).items()})
        else:
            outs.append(rt.step_many(demand[:, t:t + k], cci_demand_block=blk(t, t + k)))
        t += k
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}


def _plan_fields(plan, h):
    """An offline plan in the stream's fields."""
    from repro_torch.core.togglecci import window_sums

    vpn, cci = plan["vpn_hourly"], plan["cci_hourly"]
    return {"x": plan["x"], "state": plan["state"], "vpn_cost": vpn, "cci_cost": cci,
            "r_vpn": window_sums(vpn, h), "r_cci": window_sums(cci, h),
            "cost": torch.where(plan["x"] == 1, cci, vpn)}


def _assert_bits(got, want, fields=FIELDS):
    for k in fields:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


# -- fleet mode ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fleet(seed):
    """The port's scenario and stacked arrays, the reactive plan's series, and
    the predictions with coefficients fitted on the stream's own series."""
    sc = build_fleet_scenario(N_LINKS, horizon=HOURS, seed=seed)
    arrays = sc.fleet.stack(torch.float64, CPU)
    base = plan_fleet(arrays, sc.demand, device="cpu")
    rng = np.random.default_rng(100 + seed)
    pred = _noisy_forward_means(rng, sc.demand)
    coef = fit_cost_coef(torch.from_numpy(pred), base["vpn_hourly"], base["cci_hourly"])
    margins = np.resize(np.array([0.05, 0.0, 0.15, 0.05, 0.3]), N_LINKS)
    return sc, arrays, pred, coef.numpy(), margins


def _fleet_policy(seed, *, margin=0.05, renew=False, pred=None):
    _, arrays, p, coef, _ = _fleet(seed)
    return forecast_gated_policy(arrays.toggle, p if pred is None else pred, margin=margin,
                                 cost_coef=coef, renew_in_chunks=renew)


FLEET_KS = [1, 2, 3, 4, 5, 6, 9, 24, 30, MIXED]
K_IDS = [f"K{k}" if isinstance(k, int) else "mixed" for k in FLEET_KS]


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("K", FLEET_KS, ids=K_IDS)
def test_fleet_stream_equals_plan_fleet(K, renew):
    """Per tick, in chunks of every K the card's two launch forms take, and
    mixed: every field bit for bit against the port's CPU plan_fleet of the
    same policy (per-row margins), which the gates change."""
    sc, arrays, _, _, margins = _fleet(0)
    pol = _fleet_policy(0, margin=margins, renew=renew)
    plan = plan_fleet(arrays, sc.demand, policy=pol, device="cpu")
    rt = FleetRuntime(arrays, policy=pol, device="cpu")
    assert rt.pred_source == "replay"
    got = _stream(rt, sc.demand, K)
    _assert_bits(got, _plan_fields(plan, arrays.toggle.h))
    reactive = plan_fleet(arrays, sc.demand, renew_in_chunks=renew, device="cpu")
    assert (got["x"] != reactive["x"].numpy()).any()


@pytest.mark.parametrize("K", [1, 5, 24], ids=lambda k: f"K{k}")
def test_fleet_stream_endogenous_equals_policy_scan(K):
    """Endogenous CCI demand (no offline planner prices it): the stream's
    cost series equal the reactive endogenous stream's, and its decisions
    and window sums equal ``policy_scan`` of the same policy on those series,
    bit for bit."""
    sc, arrays, pred, coef, _ = _fleet(1)
    cci = sc.demand * 1.5
    pol = _fleet_policy(1)
    got = _stream(FleetRuntime(arrays, policy=pol, device="cpu"), sc.demand, K, cci)
    base = _stream(FleetRuntime(arrays, device="cpu"), sc.demand, 24, cci)
    for k in ("vpn_cost", "cci_cost", "r_vpn", "r_cci"):
        np.testing.assert_array_equal(got[k], base[k], err_msg=k)
    want = policy_scan(pol, torch.from_numpy(got["vpn_cost"]), torch.from_numpy(got["cci_cost"]))
    np.testing.assert_array_equal(got["x"], want["x"].numpy())
    np.testing.assert_array_equal(got["state"], want["state"].numpy())
    np.testing.assert_array_equal(np.cumsum(got["cost"], axis=1)[:, -1],
                                  want["total_cost"].numpy())
    assert (got["x"] != base["x"]).any()


def test_fleet_margin_1e30_equals_reactive_stream():
    """A margin no prediction crosses: the gates neither fire nor veto, and
    every field equals the reactive stream's, bit for bit."""
    sc, arrays, _, _, _ = _fleet(0)
    got = _stream(FleetRuntime(arrays, policy=_fleet_policy(0, margin=1e30), device="cpu"),
                  sc.demand, MIXED)
    _assert_bits(got, _stream(FleetRuntime(arrays, device="cpu"), sc.demand, MIXED))


# -- port vs JAX, replay mode ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fleet(seed):
    jsc = jscen.build_fleet_scenario(N_LINKS, horizon=HOURS, seed=seed)
    assert np.array_equal(jsc.demand, _fleet(seed)[0].demand)
    return jsc


def _jax_stream(seed, pred, margin, K, cci=None, renew=False):
    jsc = _jax_fleet(seed)
    coef = _fleet(seed)[3]
    with enable_x64():
        arrays = jsc.fleet.stack(jnp.float64)
        pol = jpol.forecast_gated_policy(arrays.toggle, pred, margin=margin, cost_coef=coef,
                                         renew_in_chunks=renew)
    return _stream(JFleetRuntime(jsc.fleet, policy=pol), jsc.demand, K, cci)


def _assert_jax(got, want):
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("vpn_cost", "cci_cost", "r_vpn", "r_cci", "cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=COST_RTOL, atol=0, err_msg=k)


JAX_CASES = {   # seed, K, endogenous, renew, NaN rows, T_pred
    "K24": (0, 24, False, False, (), HOURS),
    "K7-chunks": (1, 7, False, True, (), HOURS),
    "K1": (1, 1, False, False, (), HOURS),
    "endogenous-K24": (0, 24, True, False, (), HOURS),
    "nan-predictions": (1, 24, False, False, (0, 5), HOURS),
    "past-T_pred": (0, 24, False, False, (), 400),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_fleet_stream_matches_jax_replay_mode(case):
    """Against the JAX runtime streaming the same policy in replay mode
    (per-row margins): a NaN prediction fires and vetoes nothing; a stream
    longer than T_pred reads its last column, as the JAX runtime's clipped
    column index does."""
    seed, K, endo, renew, nan_rows, T_pred = JAX_CASES[case]
    sc, arrays, pred, _, margins = _fleet(seed)
    pred = pred[:, :T_pred].copy()
    pred[list(nan_rows), 300:] = np.nan
    cci = sc.demand * 1.5 if endo else None
    pol = forecast_gated_policy(arrays.toggle, pred, margin=margins, cost_coef=_fleet(seed)[3],
                                renew_in_chunks=renew)
    got = _stream(FleetRuntime(arrays, policy=pol, device="cpu"), sc.demand, K, cci)
    _assert_jax(got, _jax_stream(seed, pred, margins, K, cci, renew))
    if nan_rows:
        st = got["state"][list(nan_rows), 300:]
        assert (st == st[:, :1]).all()              # no transition starts
    if T_pred < HOURS:   # the clamp: the last column repeated gives the same stream
        full = np.concatenate([pred, np.repeat(pred[:, -1:], HOURS - T_pred, 1)], 1)
        longer = _stream(FleetRuntime(arrays, policy=pol._replace(
            pred_demand=torch.from_numpy(full)), device="cpu"), sc.demand, K)
        for k in ("x", "state"):
            np.testing.assert_array_equal(got[k], longer[k], err_msg=k)


# -- topology mode -------------------------------------------------------------

TOPO_HOURS = 800


@functools.lru_cache(maxsize=None)
def _topology():
    """12 pairs on 6 ports over 800 h, the optimized routing and one with
    pairs moved to another candidate port, per-port predictions and
    coefficients fitted on the plan's port series."""
    sc = build_topology_scenario(12, n_facilities=3, ports_per_facility=2, horizon=TOPO_HOURS,
                                 families=("bursty", "mirage"), seed=6)
    r0 = optimize_routing(sc.topo, sc.demand)
    idx = np.asarray(r0.primary).copy()
    moved = 0
    for i, pr in enumerate(sc.topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others and moved < 3:
            idx[i], moved = others[0], moved + 1
    r1 = sc.topo.plan(idx)
    assert r1.paths != r0.paths
    arrays = sc.topo.stack(r0, torch.float64, CPU)
    base = plan_topology(arrays, sc.demand, device="cpu")
    rng = np.random.default_rng(7)
    pred = _noisy_forward_means(rng, base["port_demand"].numpy())
    coef = fit_cost_coef(torch.from_numpy(pred), base["vpn_hourly"], base["cci_hourly"])
    return sc, r0, r1, arrays, pred, coef.numpy()


@pytest.mark.parametrize("K", [1, 5, 24], ids=lambda k: f"K{k}")
@pytest.mark.parametrize("swap", [137, 400])
def test_topology_stream_with_reroute_equals_replay(swap, K):
    """A per-port policy streamed with ``reroute()`` at hour 137 or 400 (per
    tick, or chunks ending at the swap): every field bit for bit against the
    port's CPU ``replay_plan_topology`` of the two-segment schedule."""
    sc, r0, r1, arrays, pred, coef = _topology()
    pol = forecast_gated_policy(arrays.toggle, pred, margin=0.05, cost_coef=coef)
    rt = FleetRuntime(sc.topo, routing=r0, policy=pol, device="cpu")
    got = _stream(rt, sc.demand, K, swaps=[(swap, r1)])
    rep = replay_plan_topology(arrays, sc.demand, [(0, r0), (swap, r1)], policy=pol,
                               device="cpu")
    _assert_bits(got, _plan_fields(rep, arrays.toggle.h))
    plain = replay_plan_topology(arrays, sc.demand, [(0, r0), (swap, r1)], device="cpu")
    assert (got["x"] != plain["x"].numpy()).any()
    assert rt._gate[0].shape == (TOPO_HOURS, arrays.n_ports)


def test_topology_margin_1e30_equals_reactive_stream():
    sc, r0, r1, arrays, pred, coef = _topology()
    pol = forecast_gated_policy(arrays.toggle, pred, margin=1e30, cost_coef=coef)
    swaps = [(137, r1)]
    got = _stream(FleetRuntime(sc.topo, routing=r0, policy=pol, device="cpu"), sc.demand,
                  MIXED, swaps=swaps)
    want = _stream(FleetRuntime(sc.topo, routing=r0, device="cpu"), sc.demand, MIXED,
                   swaps=swaps)
    _assert_bits(got, want)


@pytest.mark.parametrize("K", [1, 24], ids=lambda k: f"K{k}")
def test_topology_stream_matches_jax_replay_mode(K):
    """Both runtimes in topology mode with the same per-port policy and the
    same reroute at hour 400; NaN predictions on one port from hour 500."""
    sc, r0, r1, arrays, pred, coef = _topology()
    pred = pred.copy()
    pred[1, 500:] = np.nan
    jsc = jscen.build_topology_scenario(12, n_facilities=3, ports_per_facility=2,
                                        horizon=TOPO_HOURS, families=("bursty", "mirage"),
                                        seed=6)
    assert np.array_equal(jsc.demand, sc.demand)
    j0 = jtop.optimize_routing(jsc.topo, jsc.demand)
    j1 = jsc.topo.plan(np.asarray(r1.primary))
    assert j0.paths == r0.paths and j1.paths == r1.paths
    with enable_x64():
        jarr = jsc.topo.stack(j0, jnp.float64)
        jp = jpol.forecast_gated_policy(jarr.toggle, pred, margin=0.05, cost_coef=coef)
    want = _stream(JFleetRuntime(jsc.topo, routing=j0, policy=jp), jsc.demand, K,
                   swaps=[(400, j1)])
    pol = forecast_gated_policy(arrays.toggle, pred, margin=0.05, cost_coef=coef)
    got = _stream(FleetRuntime(sc.topo, routing=r0, policy=pol, device="cpu"), sc.demand, K,
                  swaps=[(400, r1)])
    _assert_jax(got, want)


# -- resolution and refusals ------------------------------------------------------

def test_cost_coef_none_raises_the_reference_text():
    """The reference asserts; the port raises a ValueError with its text, from
    the constructor, ``from_config`` and the resolver."""
    sc, arrays, pred, _, _ = _fleet(0)
    jsc = _jax_fleet(0)
    with enable_x64():
        jarr = jsc.fleet.stack(jnp.float64)
        jp = jpol.forecast_gated_policy(jarr.toggle, pred)
    with pytest.raises(AssertionError) as want:
        JFleetRuntime(jsc.fleet, policy=jp)
    pol = forecast_gated_policy(arrays.toggle, pred)
    for make in (lambda: FleetRuntime(sc.fleet, policy=pol, device="cpu"),
                 lambda: FleetRuntime.from_config(sc.fleet, RuntimeConfig(policy=pol),
                                                  device="cpu"),
                 lambda: resolve_runtime_operands(sc.fleet, RuntimeConfig(policy=pol), "cpu")):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(want.value)


def test_pred_demand_of_the_wrong_shape_raises():
    """A prediction matrix per decision row, (M, T_pred >= 1): too few rows,
    per-pair rows in topology mode, one dimension or no hour are refused."""
    sc, arrays, pred, coef, _ = _fleet(0)
    for bad in (pred[:-1], pred[0], pred[:, :0]):
        pol = forecast_gated_policy(arrays.toggle, np.zeros((N_LINKS, 1)), cost_coef=coef)
        pol = pol._replace(pred_demand=torch.from_numpy(np.ascontiguousarray(bad)))
        with pytest.raises(ValueError, match="pred_demand"):
            FleetRuntime(sc.fleet, policy=pol, device="cpu")
    tsc, r0, _, tarr, tpred, tcoef = _topology()
    per_pair = np.zeros((tsc.n_pairs, TOPO_HOURS))
    assert tsc.n_pairs != tarr.n_ports
    pol = forecast_gated_policy(tarr.toggle, tpred, cost_coef=tcoef)
    with pytest.raises(ValueError, match="pred_demand"):
        FleetRuntime(tsc.topo, routing=r0, device="cpu",
                     policy=pol._replace(pred_demand=torch.from_numpy(per_pair)))


def test_resolver_streams_replay_mode_and_keeps_the_planes():
    """The resolver marks replay mode and moves the policy; ``from_config``
    streams what the keyword constructor streams; the predicted-cost planes
    are formed once, hour-major, and ``reset()`` keeps them; ``forecaster=``
    that is not a StreamingForecaster raises the reference's TypeError, with
    or without the policy; on the CPU no kernel launches."""
    sc, arrays, pred, coef, margins = _fleet(0)
    pol = _fleet_policy(0, margin=margins)
    r = resolve_runtime_operands(sc.fleet, RuntimeConfig(policy=pol), "cpu")
    assert r.pred_source == "replay" and r.policy.cost_coef is not None
    before = dict(ops.LAUNCHES)
    a = FleetRuntime.from_config(sc.fleet, RuntimeConfig(policy=pol), device="cpu")
    b = FleetRuntime(sc.fleet, policy=pol, device="cpu")
    got, want = _stream(a, sc.demand, 24), _stream(b, sc.demand, 24)
    _assert_bits(got, want)
    assert ops.LAUNCHES == before
    p_vpn, p_cci, m, T_pred = a._gate
    assert T_pred == HOURS and p_vpn.shape == (HOURS, N_LINKS) and p_vpn.is_contiguous()
    want_v, want_c = pol.features(None, torch.empty(0, dtype=torch.float64),
                                  torch.empty(0, dtype=torch.float64))
    assert torch.equal(p_vpn, want_v.T) and torch.equal(p_cci, want_c.T)
    assert torch.equal(m, torch.from_numpy(margins))
    planes = a._gate
    a.reset()
    assert a._gate is planes and a.t == 0
    _assert_bits(_stream(a, sc.demand, 24), want)
    for kw in (dict(forecaster=object()), dict(forecaster=object(), policy=pol)):
        with pytest.raises(TypeError, match="forecaster must be a StreamingForecaster"):
            FleetRuntime(sc.fleet, device="cpu", **kw)
    with pytest.raises(ValueError, match="forecast_gated_policy"):
        FleetRuntime(dataclasses.replace(sc.fleet, policy="forecast"), device="cpu")
