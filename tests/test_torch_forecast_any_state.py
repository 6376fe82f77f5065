"""The demand forecaster past 16 states, port vs JAX package, on the CPU.

The JAX package takes any ``state_dim`` (``demand_forecaster_init``,
``train_demand_forecaster``, the factories that train, the live runtime);
so does the port. Here at S = 17 and 33 (past the kernels' compile-time
instances, 1..16, and past one and two passes of the live chunk form's 16
states): the training, the offline planners' forecast policies and the live
stream in fleet and topology mode (per tick and in K = 24 chunks, across a
``reroute()``), each beside JAX's on the same seeded inputs, with
JAX-trained forecasters carried across for the streams.

Tolerances are the existing ones, for the same reasons
(``tests/test_torch_forecast_train.py``, ``tests/test_torch_stream_live.py``):
training and factory predictions ``rtol=1e-3`` (XLA orders its float32 sums
otherwise), cost coefficients ``rtol=1e-9``; decisions equal, except at an
hour where a gate lies within the two packages' forecast difference of its
threshold (counted and printed); the live stream's forecasts ``rtol=1e-5``
and costs ``rtol=1e-9`` against JAX's live runtime, decisions equal; and
the port's live forecasts every bit of its own ``demand_forecaster_predict``.
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU
from test_torch_forecast_train import (PRED_RTOL, TRAIN_RTOL, _jax_train, _rel, _series,
                                       _ties)
from test_torch_stream_forecast import _stream
from test_torch_stream_live import (HISTORY, HOURS, N_LINKS, _assert_jax, _carried, _fleet,
                                    _jax_stream, _live_policy, _topology)

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.fleet import engine as jeng
from repro.fleet import policy as jpol
from repro.fleet import runtime as jrt
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop

from repro_torch.fleet import FleetRuntime, StreamingForecaster
from repro_torch.fleet import policy as tpol
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import topology as ttop
from repro_torch.fleet.engine import plan_fleet, plan_topology
from repro_torch.fleet.policy import predicted_mode_costs
from repro_torch.kernels import ops
from repro_torch.kernels.forecaster import FAST_STATE
from repro_torch.models import ssm as tssm
from repro_torch.models.ssm import demand_forecaster_predict

STATES = [FAST_STATE + 1, 2 * FAST_STATE + 1]
COEF_RTOL = 1e-9
STEPS = 10


@pytest.mark.parametrize("S", STATES)
def test_training_matches_jax_past_the_compile_time_states(S):
    """Every step's loss and the final parameters against JAX's training
    (20 steps on five series of 400 hours, window 48), on the CPU with no
    launch."""
    series = _series(S, 5, 400)
    want, jlosses = _jax_train(series, 48, S, 20)
    before = dict(ops.LAUNCHES)
    losses = []
    got, scale = tssm.train_demand_forecaster(series, 48, state_dim=S, steps=20, device="cpu",
                                              losses=losses)
    assert ops.LAUNCHES == before
    np.testing.assert_allclose([float(x) for x in losses], jlosses, rtol=TRAIN_RTOL)
    for k in want:
        assert got[k].shape == np.shape(want[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TRAIN_RTOL,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("S", STATES)
def test_forecast_fleet_policy_matches_jax_past_the_compile_time_states(S):
    """forecast_fleet_policy(state_dim=S): predictions within PRED_RTOL,
    cost coefficients within COEF_RTOL, plan_fleet's decisions equal JAX's up
    to printed gate ties."""
    n, T, H = 8, 800, 400
    jsc = jscen.build_fleet_scenario(n, horizon=T, history_hours=H, seed=2)
    tsc = tscen.build_fleet_scenario(n, horizon=T, history_hours=H, seed=2)
    margin = tpol.family_margins([l.family for l in tsc.fleet.links])
    with enable_x64():
        jarr = jsc.fleet.stack(jnp.float64)
        jp = jpol.forecast_fleet_policy(jarr, jsc.demand, jsc.history, margin=margin,
                                        steps=STEPS, state_dim=S)
        jplan = jeng.plan_fleet(jarr, jsc.demand, policy=jp, hours_per_month=730)
    tarr = tsc.fleet.stack(torch.float64, CPU)
    tp = tpol.forecast_fleet_policy(tarr, tsc.demand, tsc.history, margin=margin, steps=STEPS,
                                    state_dim=S, device="cpu")
    np.testing.assert_allclose(tp.pred_demand.numpy(), np.asarray(jp.pred_demand), rtol=PRED_RTOL)
    np.testing.assert_allclose(tp.cost_coef.numpy(), np.asarray(jp.cost_coef), rtol=COEF_RTOL,
                               atol=1e-12)
    got = plan_fleet(tarr, tsc.demand, policy=tp, device="cpu")
    p_vpn, p_cci = predicted_mode_costs(tp.pred_demand, tp.cost_coef, torch.float64)
    tol = 2 * _rel(tp.pred_demand.numpy(), np.asarray(jp.pred_demand))
    tg = tarr.toggle
    _ties(got, jplan, tg.theta1.numpy(), tg.theta2.numpy(), tp.margin.numpy(), p_vpn.numpy(),
          p_cci.numpy(), tol, f"forecast_fleet_policy S = {S}")


@pytest.mark.parametrize("S", STATES)
def test_forecast_topology_policy_matches_jax_past_the_compile_time_states(S):
    """forecast_topology_policy(state_dim=S): per-port predictions, cost
    coefficients and plan_topology's decisions against JAX's."""
    build = lambda m: m.build_topology_scenario(
        12, n_facilities=3, ports_per_facility=2, horizon=800, history_hours=400,
        families=("bursty", "mirage"), seed=6)
    jsc, tsc = build(jscen), build(tscen)
    jr, tr = jtop.optimize_routing(jsc.topo, jsc.demand), ttop.optimize_routing(tsc.topo,
                                                                               tsc.demand)
    assert jr.paths == tr.paths
    with enable_x64():
        jarr = jsc.topo.stack(jr, jnp.float64)
        jp = jpol.forecast_topology_policy(jarr, jsc.demand, jsc.history, steps=STEPS,
                                           state_dim=S)
        jplan = jeng.plan_topology(jarr, jsc.demand, policy=jp, hours_per_month=730)
    tarr = tsc.topo.stack(tr, torch.float64, CPU)
    tp = tpol.forecast_topology_policy(tarr, tsc.demand, tsc.history, steps=STEPS, state_dim=S,
                                       device="cpu")
    np.testing.assert_allclose(tp.pred_demand.numpy(), np.asarray(jp.pred_demand), rtol=PRED_RTOL)
    np.testing.assert_allclose(tp.cost_coef.numpy(), np.asarray(jp.cost_coef), rtol=COEF_RTOL,
                               atol=1e-12)
    got = plan_topology(tarr, tsc.demand, policy=tp, device="cpu")
    p_vpn, p_cci = predicted_mode_costs(tp.pred_demand, tp.cost_coef, torch.float64)
    tol = 2 * _rel(tp.pred_demand.numpy(), np.asarray(jp.pred_demand))
    tg = tarr.toggle
    _ties(got, jplan, tg.theta1.numpy(), tg.theta2.numpy(), tp.margin.numpy(), p_vpn.numpy(),
          p_cci.numpy(), tol, f"forecast_topology_policy S = {S}")


@functools.lru_cache(maxsize=None)
def _jax_live(mode: str, S: int):
    """JAX's live policy and S-state forecaster from its
    streaming_forecast_policy (STEPS training steps on the history), fleet or
    topology (routing r0), and the port's twins: the forecaster carried
    across, the same coefficients."""
    if mode == "fleet":
        jsc = jscen.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=0)
        sc, arrays, _, _, _, margins = _fleet()
        with enable_x64():
            jarr = jsc.fleet.stack(jnp.float64)
        jp, jfc = jrt.streaming_forecast_policy(jarr, jsc.history, margin=margins, steps=STEPS,
                                                state_dim=S)
        return jsc, None, jp, jfc, _live_policy(arrays, np.asarray(jp.cost_coef), margins)
    sc, r0, r1, arrays = _topology()[:4]
    jsc = jscen.build_topology_scenario(12, n_facilities=3, ports_per_facility=2,
                                        horizon=sc.demand.shape[1], history_hours=HISTORY,
                                        families=("bursty", "mirage"), seed=6)
    j0 = jtop.optimize_routing(jsc.topo, jsc.demand)
    j1 = jsc.topo.plan(np.asarray(r1.primary))
    assert j0.paths == r0.paths and j1.paths == r1.paths
    with enable_x64():
        jarr = jsc.topo.stack(j0, jnp.float64)
    jp, jfc = jrt.streaming_forecast_policy(jarr, jsc.history, steps=STEPS, state_dim=S)
    return jsc, (j0, j1), jp, jfc, _live_policy(arrays, np.asarray(jp.cost_coef))


@pytest.mark.parametrize("K", [1, 24], ids=["step", "K24"])
@pytest.mark.parametrize("mode", ["fleet", "topology"])
@pytest.mark.parametrize("S", STATES)
def test_live_stream_matches_jax_past_the_compile_time_states(S, mode, K):
    """The live stream with JAX's S-state forecaster carried across, per
    tick and in K = 24 chunks (topology: a reroute at hour 400), beside
    JAX's live runtime: decisions equal, forecasts within PRED_RTOL, costs
    rtol 1e-9; and (fleet mode) the port's stream with the forecaster warmed
    by its own scan: forecasts every bit of its demand_forecaster_predict
    over the history and the clipped stream."""
    jsc, routes, jp, jfc, pol = _jax_live(mode, S)
    fc = _carried(jfc)
    assert fc.h0.shape[1] == S
    if mode == "fleet":
        sc = _fleet()[0]
        want, preds = _jax_stream(jrt.FleetRuntime(jsc.fleet, policy=jp, forecaster=jfc),
                                  jsc.demand, K)
        got = _stream(FleetRuntime(sc.fleet, policy=pol, forecaster=fc, device="cpu"),
                      sc.demand, K)
        _, _, hist, live = _fleet()[:4]
        own = StreamingForecaster.from_history(fc.params, hist, device="cpu")
        y = demand_forecaster_predict(fc.params, np.concatenate([hist, live], 1), own.scale,
                                      device="cpu")
        mine = _stream(FleetRuntime(sc.fleet, policy=pol, forecaster=own, device="cpu"),
                       sc.demand, K)
        assert torch.equal(torch.from_numpy(mine["pred_next"]), y[:, HISTORY:])
    else:
        sc, r0, r1 = _topology()[:3]
        j0, j1 = routes
        want, preds = _jax_stream(jrt.FleetRuntime(jsc.topo, routing=j0, policy=jp,
                                                   forecaster=jfc), jsc.demand, K, [(400, j1)])
        got = _stream(FleetRuntime(sc.topo, routing=r0, policy=pol, forecaster=fc,
                                   device="cpu"), sc.demand, K, swaps=[(400, r1)])
    _assert_jax(got, want, preds)
