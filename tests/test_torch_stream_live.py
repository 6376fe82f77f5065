"""The forecast-gated policy streamed in live mode, port vs port and port vs JAX.

A :class:`ForecastGatedPolicy` with its ``cost_coef`` given, beside a
:class:`StreamingForecaster`, streams through the port's ``FleetRuntime`` in
live mode: the SSM forecaster's state rides on the device beside the FSM
carry, each hour's gates read the predicted mode costs of the forecast
carried into the hour, and after the hour the forecaster consumes the
hour's clipped demand (the port's fold of it in topology mode) and makes the
next forecast. On the CPU the runtime runs the chunk kernels' plain versions
(``stream_chunk_ref``, ``stream_chunk_routed_ref``) with their live
operands.

The forecast chain reads no decision, which gives two oracles:

* the live stream's forecast after hour t (``pred_next``) equals column
  ``H + t`` of ``demand_forecaster_predict`` over the history followed by
  the clipped stream, bit for bit;
* its decisions and costs equal the replay-mode stream and the offline plan
  fed those predictions (``pred[:, t]`` = column ``H − 1 + t``), bit for bit.

Held on small sizes (6 links x 400 h after 300 h of history; 12 pairs on 6
ports x 800 h after 300 h): per tick, in chunks of K = 1–5 (the card's tick
form), K = 6–30 (its chunk form) and mixed; endogenous CCI demand (where the
topology forecast folds the VPN-path demand) and ``renew_in_chunks`` on and
off; topology mode across ``reroute()`` at hour 137 or 400. Against JAX's
live ``FleetRuntime`` with a forecaster JAX trained for 30 steps, carried
across (``tree_from_reference`` and its numpy fields), fleet and topology:
decisions equal, forecasts within ``PRED_RTOL`` (the two packages'
transcendentals may differ in the last place), costs within ``rtol=1e-9``.
Edges: margin 1e30 against the reactive stream, a NaN demand hour, ``reset()``
and ``reroute()``; and the refusals.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU
from test_torch_stream_forecast import FIELDS, MIXED, _assert_bits, _plan_fields, _stream

import jax
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.fleet import runtime as jrt
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop

from repro_torch.fleet import (
    FleetRuntime,
    RuntimeConfig,
    StreamingForecaster,
    build_fleet_scenario,
    build_topology_scenario,
    fit_cost_coef,
    forecast_gated_policy,
    optimize_routing,
    plan_fleet,
    policy_scan,
    replay_plan_topology,
    resolve_runtime_operands,
    streaming_forecast_policy,
)
from repro_torch.fleet import engine as teng
from repro_torch.fleet.engine import routed_cost_series
from repro_torch.kernels import ops
from repro_torch.models.convert import tree_from_reference
from repro_torch.models.ssm import (
    demand_forecaster_init,
    demand_forecaster_predict,
    demand_forecaster_state,
)

N_LINKS, HOURS, HISTORY = 6, 400, 300
PRED_RTOL = 1e-5
COST_RTOL = 1e-9
FLEET_KS = [1, 2, 3, 4, 5, 6, 9, 24, 30, MIXED]
K_IDS = [f"K{k}" if isinstance(k, int) else "mixed" for k in FLEET_KS]


def _params(kind: str, S: int = 8):
    """The persistence init, or the init with a readout drawn from the seed."""
    p = demand_forecaster_init(None, S, device="cpu")
    if kind == "init":
        return p
    rng = np.random.default_rng(S)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return dict(p, w=f32(0.3 * rng.standard_normal(S)), bias=f32(0.05 * rng.standard_normal()))


# -- fleet mode ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fleet(seed: int = 0):
    """The port's scenario with history, its stacked arrays, the clipped
    history and stream, and cost coefficients fitted on the history's own
    cost series (as the reference's ``streaming_forecast_policy`` fits
    them)."""
    sc = build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=seed)
    arrays = sc.fleet.stack(torch.float64, CPU)
    cap = arrays.capacity.numpy()[:, None]
    hist, live = np.minimum(sc.history, cap), np.minimum(sc.demand, cap)
    s = routed_cost_series(arrays, sc.history, hours_per_month=730, device="cpu")
    coef = fit_cost_coef(s.row_demand, s.vpn, s.cci).numpy()
    margins = np.resize(np.array([0.05, 0.0, 0.15]), N_LINKS)
    return sc, arrays, hist, live, coef, margins


def _live_policy(arrays, coef, margin=0.05, renew=False):
    """The policy live mode streams: its ``pred_demand`` is not read."""
    return forecast_gated_policy(arrays.toggle, np.zeros(arrays.toggle.h.shape[0]),
                                 margin=margin, cost_coef=coef, renew_in_chunks=renew)


@functools.lru_cache(maxsize=None)
def _fleet_forecast(kind: str):
    """The forecaster warmed through the clipped history, and the port's
    predictions over history and clipped stream: (forecaster, y (N, H + T))."""
    _, _, hist, live, _, _ = _fleet()
    params = _params(kind)
    fc = StreamingForecaster.from_history(params, hist, device="cpu")
    y = demand_forecaster_predict(params, np.concatenate([hist, live], 1), fc.scale,
                                  device="cpu")
    return fc, y


def test_from_history_is_state_and_predict():
    """The warm-up (one scan) gives demand_forecaster_state's state and
    demand_forecaster_predict's last column, bit for bit, and the training's
    normaliser."""
    _, _, hist, _, _, _ = _fleet()
    params = _params("seeded")
    fc = StreamingForecaster.from_history(params, hist, device="cpu")
    scale = np.maximum(hist.mean(axis=1), 1e-9)
    np.testing.assert_array_equal(fc.scale, scale)
    u = torch.log1p((torch.from_numpy(hist) / torch.from_numpy(scale)[:, None]).float())
    assert torch.equal(fc.h0, demand_forecaster_state(params, u))
    assert torch.equal(fc.pred0, demand_forecaster_predict(params, hist, scale,
                                                           device="cpu")[:, -1])


@pytest.mark.parametrize("kind", ["seeded", "init"])
@pytest.mark.parametrize("K", FLEET_KS, ids=K_IDS)
def test_fleet_live_predictions_equal_predict_columns(K, kind):
    """(a) The forecast after each hour, per tick, in chunks and mixed:
    column H + t of demand_forecaster_predict over history and clipped
    stream, every bit; the runtime carries the last one."""
    sc, arrays, _, _, coef, _ = _fleet()
    fc, y = _fleet_forecast(kind)
    rt = FleetRuntime(arrays, policy=_live_policy(arrays, coef), forecaster=fc, device="cpu")
    assert rt.pred_source == "live"
    got = _stream(rt, sc.demand, K)
    assert torch.equal(torch.from_numpy(got["pred_next"]), y[:, HISTORY:])
    assert torch.equal(rt._state.pred_live, y[:, -1])


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("K", FLEET_KS, ids=K_IDS)
def test_fleet_live_stream_equals_replay_and_plan_fleet(K, renew):
    """(b) Decisions and costs: every field bit for bit against the port's
    replay-mode stream and CPU plan_fleet fed the predictions (pred[:, t] =
    column H − 1 + t), with per-row margins; the gates change decisions."""
    sc, arrays, _, _, coef, margins = _fleet()
    fc, y = _fleet_forecast("seeded")
    pol = _live_policy(arrays, coef, margins, renew)
    got = _stream(FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu"), sc.demand, K)
    replay = pol._replace(pred_demand=y[:, HISTORY - 1:HISTORY - 1 + HOURS].contiguous())
    plan = plan_fleet(arrays, sc.demand, policy=replay, device="cpu")
    _assert_bits(got, _plan_fields(plan, arrays.toggle.h))
    rstream = _stream(FleetRuntime(arrays, policy=replay, device="cpu"), sc.demand, K)
    _assert_bits(got, rstream)
    reactive = plan_fleet(arrays, sc.demand, renew_in_chunks=renew, device="cpu")
    assert (got["x"] != reactive["x"].numpy()).any()


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("K", [1, 5, 24, MIXED], ids=["K1", "K5", "K24", "mixed"])
def test_fleet_live_endogenous_equals_replay_stream(K, renew):
    """(b) Endogenous CCI demand: the forecast still reads the clipped
    VPN-path demand (its predictions are the same columns), and every field
    equals the replay-mode stream of the same CCI demand and the policy
    scan over the stream's own series, bit for bit."""
    sc, arrays, _, _, coef, _ = _fleet()
    fc, y = _fleet_forecast("seeded")
    cci = sc.demand * 1.5
    pol = _live_policy(arrays, coef, renew=renew)
    got = _stream(FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu"), sc.demand, K,
                  cci)
    assert torch.equal(torch.from_numpy(got["pred_next"]), y[:, HISTORY:])
    replay = pol._replace(pred_demand=y[:, HISTORY - 1:HISTORY - 1 + HOURS].contiguous())
    _assert_bits(got, _stream(FleetRuntime(arrays, policy=replay, device="cpu"), sc.demand, K,
                              cci))
    want = policy_scan(replay, torch.from_numpy(got["vpn_cost"]),
                       torch.from_numpy(got["cci_cost"]))
    np.testing.assert_array_equal(got["x"], want["x"].numpy())
    np.testing.assert_array_equal(got["state"], want["state"].numpy())


def test_fleet_live_run_equals_step_many():
    """``run`` (hour by hour) gives the chunked stream's every field,
    forecasts included."""
    sc, arrays, _, _, coef, _ = _fleet()
    fc, _ = _fleet_forecast("seeded")
    pol = _live_policy(arrays, coef)
    got = FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu").run(sc.demand[:, :100])
    want = _stream(FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu"),
                   sc.demand[:, :100], 24)
    _assert_bits(got, want, FIELDS + ("pred_next",))


# -- topology mode -------------------------------------------------------------

TOPO_HOURS = 800


def _port_demand(arrays, demand, schedule):
    """The clipped port demand a stream folds under a routing schedule:
    replay_plan_topology's route stage, segment by segment."""
    d_pair, vpn_pair = teng._pair_stage(arrays, torch.as_tensor(demand), hours_per_month=730)
    T, E = demand.shape[1], arrays.routing.n_legs
    starts = [s for s, _ in schedule] + [T]
    parts = []
    for (a, b), (_, plan) in zip(zip(starts, starts[1:]), schedule):
        op = plan.pad_to(E).operand(torch.float64, CPU)
        parts.append(teng._route_stage(arrays, op, d_pair[:, a:b], vpn_pair[:, a:b])[0])
    return torch.cat(parts, dim=1)


@functools.lru_cache(maxsize=None)
def _topology():
    """12 pairs on 6 ports over 800 h after 300 h of history, the optimized
    routing and one with three pairs moved, the port history under the
    first (``routed_cost_series``, as the reference aggregates a topology
    history), coefficients fitted on its series, and the forecaster warmed
    through it."""
    sc = build_topology_scenario(12, n_facilities=3, ports_per_facility=2, horizon=TOPO_HOURS,
                                 history_hours=HISTORY, families=("bursty", "mirage"), seed=6)
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
    s = routed_cost_series(arrays, sc.history, hours_per_month=730, device="cpu")
    coef = fit_cost_coef(s.row_demand, s.vpn, s.cci).numpy()
    params = _params("seeded")
    fc = StreamingForecaster.from_history(params, s.row_demand, device="cpu")
    return sc, r0, r1, arrays, coef, params, fc


def _topo_predictions(port_d):
    """The forecaster's predictions over the port history followed by the
    stream's port demand: y (M, H + T)."""
    sc, _, _, arrays, _, params, fc = _topology()
    s = routed_cost_series(arrays, sc.history, hours_per_month=730, device="cpu")
    return demand_forecaster_predict(params, torch.cat([s.row_demand, port_d], 1), fc.scale,
                                     device="cpu")


@pytest.mark.parametrize("endo", [False, True], ids=["exogenous", "endogenous"])
@pytest.mark.parametrize("K", [1, 5, 24, MIXED], ids=["K1", "K5", "K24", "mixed"])
@pytest.mark.parametrize("swap", [137, 400])
def test_topology_live_stream_with_reroute(swap, K, endo):
    """(c) A per-port live policy streamed with ``reroute()`` at hour 137 or
    400: its forecasts every bit of the predictions over the port demand
    folded under the two-segment schedule (the VPN-path demand with
    endogenous CCI demand); its fields every bit of the replay-mode stream
    fed them and, without endogenous demand, of replay_plan_topology."""
    sc, r0, r1, arrays, coef, _, fc = _topology()
    schedule = [(0, r0), (swap, r1)]
    pol = _live_policy(arrays, coef)
    cci = sc.demand * 1.5 if endo else None
    rt = FleetRuntime(sc.topo, routing=r0, policy=pol, forecaster=fc, device="cpu")
    got = _stream(rt, sc.demand, K, cci, swaps=[(swap, r1)])
    y = _topo_predictions(_port_demand(arrays, sc.demand, schedule))
    assert torch.equal(torch.from_numpy(got["pred_next"]), y[:, HISTORY:])
    replay = pol._replace(pred_demand=y[:, HISTORY - 1:HISTORY - 1 + TOPO_HOURS].contiguous())
    rstream = _stream(FleetRuntime(sc.topo, routing=r0, policy=replay, device="cpu"),
                      sc.demand, K, cci, swaps=[(swap, r1)])
    _assert_bits(got, rstream)
    if not endo:
        rep = replay_plan_topology(arrays, sc.demand, schedule, policy=replay, device="cpu")
        _assert_bits(got, _plan_fields(rep, arrays.toggle.h))
        plain = replay_plan_topology(arrays, sc.demand, schedule, device="cpu")
        assert (got["x"] != plain["x"].numpy()).any()


# -- port vs JAX, live mode --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fleet():
    """JAX's scenario, its live policy and forecaster from the reference's
    streaming_forecast_policy (trained 30 steps on the history), and the
    port's twins: the forecaster carried across, the same coefficients."""
    jsc = jscen.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=0)
    sc, arrays, _, _, _, margins = _fleet()
    assert np.array_equal(jsc.demand, sc.demand) and np.array_equal(jsc.history, sc.history)
    with enable_x64():
        jarr = jsc.fleet.stack(jnp.float64)
    jpol, jfc = jrt.streaming_forecast_policy(jarr, jsc.history, margin=margins, steps=30)
    fc = _carried(jfc)
    return jsc, jpol, jfc, _live_policy(arrays, np.asarray(jpol.cost_coef), margins), fc


def _carried(jfc):
    """A JAX StreamingForecaster carried across to the port."""
    return StreamingForecaster(params=tree_from_reference(jax.tree.map(np.asarray, jfc.params),
                                                          device=CPU),
                               scale=np.asarray(jfc.scale), h0=np.asarray(jfc.h0),
                               pred0=np.asarray(jfc.pred0))


def _jax_stream(rt, demand, K, swaps=()):
    """_stream over a JAX runtime, with its carried forecast after every
    chunk: (fields, [(hour, pred_live)])."""
    T = demand.shape[1]
    outs, preds, t = [], [], 0
    swaps = dict(swaps)
    while t < T:
        if t in swaps:
            rt.reroute(swaps[t])
        k = min(K, min([s for s in swaps if s > t] + [T]) - t)
        if k == 1:
            outs.append({k_: np.asarray(v)[:, None] for k_, v in rt.step(demand[:, t]).items()})
        else:
            outs.append({k_: np.asarray(v) for k_, v in rt.step_many(demand[:, t:t + k]).items()})
        t += k
        preds.append((t - 1, np.asarray(rt._state.pred_live)))
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}, preds


def _assert_jax(got, want, preds):
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("vpn_cost", "cci_cost", "r_vpn", "r_cci", "cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=COST_RTOL, atol=0, err_msg=k)
    for t, p in preds:
        np.testing.assert_allclose(got["pred_next"][:, t], p, rtol=PRED_RTOL, atol=0)


@pytest.mark.parametrize("K", [1, 24], ids=["step", "K24"])
def test_fleet_live_stream_matches_jax(K):
    """(d) Against JAX's live runtime (``step`` per tick, ``step_many`` in
    K = 24 chunks) with JAX's trained forecaster carried across and per-row
    margins: decisions equal, forecasts within PRED_RTOL, costs rtol 1e-9;
    the carried start is JAX's own."""
    jsc, jpol, jfc, pol, fc = _jax_fleet()
    sc, arrays = _fleet()[:2]
    want, preds = _jax_stream(jrt.FleetRuntime(jsc.fleet, policy=jpol, forecaster=jfc),
                              jsc.demand, K)
    rt = FleetRuntime(sc.fleet, policy=pol, forecaster=fc, device="cpu")
    np.testing.assert_array_equal(rt._state.pred_live.numpy(), np.asarray(jfc.pred0))
    got = _stream(rt, sc.demand, K)
    _assert_jax(got, want, preds)


@functools.lru_cache(maxsize=None)
def _jax_topology():
    """Both packages' topology scenario with history, routings r0/r1, and
    JAX's per-port live policy and forecaster (its history aggregated onto
    the ports under r0), carried across."""
    jsc = jscen.build_topology_scenario(12, n_facilities=3, ports_per_facility=2,
                                        horizon=TOPO_HOURS, history_hours=HISTORY,
                                        families=("bursty", "mirage"), seed=6)
    sc, r0, r1, arrays, _, _, _ = _topology()
    assert np.array_equal(jsc.demand, sc.demand) and np.array_equal(jsc.history, sc.history)
    j0 = jtop.optimize_routing(jsc.topo, jsc.demand)
    j1 = jsc.topo.plan(np.asarray(r1.primary))
    assert j0.paths == r0.paths and j1.paths == r1.paths
    with enable_x64():
        jarr = jsc.topo.stack(j0, jnp.float64)
    jpol, jfc = jrt.streaming_forecast_policy(jarr, jsc.history, steps=30)
    return jsc, j0, j1, jpol, jfc, _live_policy(arrays, np.asarray(jpol.cost_coef)), _carried(jfc)


@pytest.mark.parametrize("K", [1, 24], ids=["step", "K24"])
def test_topology_live_stream_matches_jax(K):
    """(d) Topology mode, both runtimes with the same per-port live policy
    and forecaster and the same reroute at hour 400."""
    jsc, j0, j1, jpol, jfc, pol, fc = _jax_topology()
    sc, r0, r1 = _topology()[:3]
    want, preds = _jax_stream(jrt.FleetRuntime(jsc.topo, routing=j0, policy=jpol,
                                               forecaster=jfc), jsc.demand, K, [(400, j1)])
    got = _stream(FleetRuntime(sc.topo, routing=r0, policy=pol, forecaster=fc, device="cpu"),
                  sc.demand, K, swaps=[(400, r1)])
    _assert_jax(got, want, preds)


# -- edges ---------------------------------------------------------------------

def test_live_margin_1e30_equals_reactive_stream():
    """(e) A margin no forecast crosses: every field of the reactive
    stream, fleet and topology (across a reroute), bit for bit."""
    sc, arrays, _, _, coef, _ = _fleet()
    fc, _ = _fleet_forecast("seeded")
    got = _stream(FleetRuntime(arrays, policy=_live_policy(arrays, coef, 1e30), forecaster=fc,
                               device="cpu"), sc.demand, MIXED)
    _assert_bits(got, _stream(FleetRuntime(arrays, device="cpu"), sc.demand, MIXED))
    tsc, r0, r1, tarr, tcoef, _, tfc = _topology()
    swaps = [(137, r1)]
    got = _stream(FleetRuntime(tsc.topo, routing=r0, policy=_live_policy(tarr, tcoef, 1e30),
                               forecaster=tfc, device="cpu"), tsc.demand, MIXED, swaps=swaps)
    _assert_bits(got, _stream(FleetRuntime(tsc.topo, routing=r0, device="cpu"), tsc.demand,
                              MIXED, swaps=swaps))


def test_live_nan_demand_hour_poisons_its_row():
    """(e) A NaN demand hour makes its row's forecasts NaN from that hour on
    (as JAX's, ``tests/test_torch_forecast.py``), leaves the other rows
    finite, and from then on no request or release fires in the row; the
    stream equals the replay stream fed those forecasts."""
    sc, arrays, hist, live, coef, _ = _fleet()
    fc, _ = _fleet_forecast("seeded")
    demand = sc.demand.copy()
    demand[2, 150] = np.nan
    pol = _live_policy(arrays, coef)
    got = _stream(FleetRuntime(arrays, policy=pol, forecaster=fc, device="cpu"), demand, 24)
    pred = got["pred_next"]
    assert np.isnan(pred[2, 150:]).all() and np.isfinite(pred[2, :150]).all()
    assert np.isfinite(np.delete(pred, 2, 0)).all()
    s = got["state"][2, 151:]
    prev = got["state"][2, 150:-1]
    assert not ((prev == 0) & (s == 1)).any() and not ((prev == 2) & (s == 0)).any()
    y = demand_forecaster_predict(_params("seeded"), np.concatenate(
        [hist, np.minimum(demand, arrays.capacity.numpy()[:, None])], 1), fc.scale, device="cpu")
    assert np.array_equal(pred, y[:, HISTORY:].numpy(), equal_nan=True)
    replay = pol._replace(pred_demand=y[:, HISTORY - 1:HISTORY - 1 + HOURS].contiguous())
    want = _stream(FleetRuntime(arrays, policy=replay, device="cpu"), demand, 24)
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_live_reset_restores_the_forecaster():
    """(e) ``reset()`` puts the forecaster back at ``h0`` and ``pred0``, and
    the stream after it repeats the first, every field."""
    sc, arrays, _, _, coef, _ = _fleet()
    fc, _ = _fleet_forecast("seeded")
    rt = FleetRuntime(arrays, policy=_live_policy(arrays, coef), forecaster=fc, device="cpu")
    first = _stream(rt, sc.demand[:, :200], 24)
    assert not torch.equal(rt._state.ssm_h, fc.h0)
    rt.reset()
    assert rt.t == 0
    assert torch.equal(rt._state.ssm_h, fc.h0) and torch.equal(rt._state.pred_live, fc.pred0)
    _assert_bits(_stream(rt, sc.demand[:, :200], 24), first, FIELDS + ("pred_next",))


def test_live_reroute_leaves_the_forecaster_untouched():
    """(e) ``reroute()`` carries the forecaster's state and forecast across
    as they are (the same tensors)."""
    sc, r0, r1, arrays, coef, _, fc = _topology()
    rt = FleetRuntime(sc.topo, routing=r0, policy=_live_policy(arrays, coef), forecaster=fc,
                      device="cpu")
    rt.step_many(sc.demand[:, :48])
    h, pred = rt._state.ssm_h, rt._state.pred_live
    rt.reroute(r1)
    assert rt._state.ssm_h is h and rt._state.pred_live is pred


# -- refusals ------------------------------------------------------------------

def test_live_refusals_match_the_reference():
    """(f) A forecaster that is not a StreamingForecaster raises the
    reference's TypeError; a forecaster beside a reactive policy its
    ValueError (the same text when no policy is given, where the reference
    asserts); a forecaster of the wrong row count, state size or parameter
    size raises; the trained forecaster (``fit``, ``streaming_forecast_policy``,
    item 6c) is accepted beside its policy and streams."""
    sc, arrays, hist, _, coef, _ = _fleet()
    fc, _ = _fleet_forecast("seeded")
    with pytest.raises(TypeError) as want:
        jrt.RuntimeConfig(forecaster=object()).validate()
    for make in (lambda: FleetRuntime(sc.fleet, forecaster=object(), device="cpu"),
                 lambda: RuntimeConfig(forecaster=object()).validate()):
        with pytest.raises(TypeError) as got:
            make()
        assert str(got.value) == str(want.value)
    jfc = jrt.StreamingForecaster(params=None, scale=None, h0=None, pred0=None)
    with enable_x64():
        jarr = jscen.build_fleet_scenario(N_LINKS, horizon=HOURS, seed=0).fleet.stack(
            jnp.float64)
    from repro.fleet import policy as jpol
    with pytest.raises(ValueError) as want:
        jrt.RuntimeConfig(forecaster=jfc, policy=jpol.reactive_policy(jarr.toggle)).validate()
    reactive = arrays.toggle
    from repro_torch.fleet import reactive_policy
    for kw in (dict(policy=reactive_policy(reactive)), dict()):
        with pytest.raises(ValueError) as got:
            FleetRuntime(arrays, forecaster=fc, device="cpu", **kw)
        assert str(got.value) == str(want.value)
    pol = _live_policy(arrays, coef)
    for bad in (dataclasses.replace(fc, scale=fc.scale[:-1]),
                dataclasses.replace(fc, h0=fc.h0[:-1]),
                dataclasses.replace(fc, pred0=np.zeros(N_LINKS + 1)),
                dataclasses.replace(fc, h0=torch.zeros((N_LINKS, 17))),
                dataclasses.replace(fc, params=_params("seeded", 4))):
        with pytest.raises(ValueError, match="forecaster|states"):
            FleetRuntime(arrays, policy=pol, forecaster=bad, device="cpu")
    with pytest.raises(ValueError, match="cost_coef"):
        FleetRuntime(arrays, policy=pol._replace(cost_coef=None), forecaster=fc, device="cpu")
    tfc = StreamingForecaster.fit(hist, 24, steps=3, device="cpu")
    lpol, lfc = streaming_forecast_policy(arrays, sc.history, steps=3, device="cpu")
    for f in (tfc, lfc):
        out = FleetRuntime(arrays, policy=lpol, forecaster=f, device="cpu").step_many(
            sc.demand[:, :24])
        assert out["pred_next"].shape == (N_LINKS, 24)


def test_live_resolver_marks_live_mode_and_launches_nothing_on_the_cpu():
    """The resolver marks live mode and forms the operands once on the
    device (``a`` by the host's sigmoid); ``from_config`` streams what the
    keyword constructor streams; on the CPU no kernel launches."""
    sc, arrays, _, _, coef, _ = _fleet()
    fc, _ = _fleet_forecast("seeded")
    pol = _live_policy(arrays, coef)
    r = resolve_runtime_operands(sc.fleet, RuntimeConfig(policy=pol, forecaster=fc), "cpu")
    assert r.pred_source == "live" and len(r.live) == 7 and len(r.live0) == 2
    a, oma, w, bias, scale, c, m = r.live
    assert a.dtype == torch.float32 and scale.dtype == torch.float64 and c.shape == (N_LINKS, 4)
    assert torch.equal(a, torch.sigmoid(fc.params["raw_a"])) and torch.equal(oma, 1.0 - a)
    before = dict(ops.LAUNCHES)
    x = FleetRuntime.from_config(sc.fleet, RuntimeConfig(policy=pol, forecaster=fc),
                                 device="cpu")
    y = FleetRuntime(sc.fleet, policy=pol, forecaster=fc, device="cpu")
    _assert_bits(_stream(x, sc.demand, 24), _stream(y, sc.demand, 24), FIELDS + ("pred_next",))
    assert ops.LAUNCHES == before
