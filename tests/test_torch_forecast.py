"""Port vs JAX package for the forecast-gated policy on the offline planners.

The demand forecaster (:mod:`repro_torch.models.ssm`) runs JAX-trained
parameters (``train_demand_forecaster(steps=30)``) carried across with
``tree_from_reference``; the forecast-gated policy
(:mod:`repro_torch.fleet.policy`) goes through ``policy_scan``,
``plan_fleet``, ``plan_topology`` and ``replay_plan_topology`` on the CPU,
beside the JAX package's (under ``enable_x64``) on the same inputs, made
with numpy from a seed.

Tolerances: the forecaster's ``y`` and ``h`` (log1p space) within
``atol=1e-6, rtol=4e-7`` (about three float32 ulps) and its predictions
within ``rtol=1e-5``: XLA:CPU orders and fuses the float32 update and
readout otherwise than the port's unfused ops in the JAX order, and the
slowest EMA (τ = 512 h) carries each hour's rounding for hundreds of hours
(on the fleet case below 44-49 % of ``y`` is bit-equal and the largest
difference is 2 ulps of a ``y`` of ~20, 3.8e-6); the log-space cost fit within ``rtol=1e-9``
(reductions in another order) and the predicted mode costs within
``rtol=1e-12`` (``exp``/``log1p`` may differ in the last place). Decisions
(``x``, ``state``) are equal element for element, costs within
``rtol=1e-9``. Inside the port the forecaster's batch and step forms, and
its plain scan against a numpy float32 replay in its order, agree bit for
bit. The reference's own forecast tests (``tests/test_policy.py:205-270``)
fail at collection on JAX 0.9.0 and are mirrored here.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU, jax_fleet_dict

import jax
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.core.costmodel import hourly_cost_series as jhourly
from repro.core.pricing import CostParams as JCostParams, flat_rate as jflat
from repro.core.togglecci import ToggleParams as JToggle
from repro.fleet import engine as jeng
from repro.fleet import policy as jpol
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.spec import fleet_from_params as jfleet_from_params
from repro.models import ssm as jssm

from repro_torch.core.costmodel import hourly_cost_series
from repro_torch.core.pricing import CostParams, flat_rate
from repro_torch.core.togglecci import OFF, ToggleParams
from repro_torch.fleet import engine as teng
from repro_torch.fleet import plan as tplan
from repro_torch.fleet import policy as tpol
from repro_torch.fleet import runtime as trt
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import stream as tstream
from repro_torch.fleet import topology as ttop
from repro_torch.fleet.spec import fleet_arrays_from_numpy, fleet_from_params
from repro_torch.kernels import ops, ref
from repro_torch.kernels.forecaster import BWD_TILE
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import tree_from_reference

Y_ATOL, Y_RTOL = 1e-6, 4e-7
PRED_RTOL = 1e-5
COEF_RTOL = 1e-9
COST_RTOL = 1e-9


# -- the forecaster ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _trained(S: int):
    """A seasonal and a trending family of series, and the JAX forecaster
    trained on them for 30 steps (numpy leaves)."""
    rng = np.random.default_rng(10 + S)
    t = np.arange(600)
    series = np.concatenate([
        50 * (1 + 0.5 * np.sin(2 * np.pi * t / 168)) + rng.normal(0, 4, (3, t.size)),
        30 * (1 + t / 600) + rng.normal(0, 3, (2, t.size)),
    ]).clip(min=0.0)
    params, scale = jssm.train_demand_forecaster(series, 48, state_dim=S, steps=30, seed=0)
    return series, np.asarray(scale), jax.tree.map(np.asarray, params)


def _u(series, scale):
    return np.log1p((series / scale[:, None]).astype(np.float32))


@pytest.mark.parametrize("S", [1, 8, 16])
def test_forecaster_init_matches_jax(S):
    """The persistence init. ``raw_a`` within ``atol=1e-5``: JAX forms the
    logit ``log(a) − log1p(−a)`` in float32, which loses up to ~5e-6 near
    a = 1 (S = 16); the port forms it in float64 and rounds once."""
    want = jax.tree.map(np.asarray, jssm.demand_forecaster_init(None, S))
    got = tssm.demand_forecaster_init(None, S, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=1e-5, err_msg=k)
    assert not got["w"].any() and float(got["bias"]) == 0.0


@pytest.mark.parametrize("S", [1, 8, 16])
def test_forecaster_forms_match_jax(S):
    """apply, state, step and predict with JAX-trained parameters."""
    series, scale, jp = _trained(S)
    tp = tree_from_reference(jp, device=CPU)
    u = _u(series, scale)
    y = tssm.demand_forecaster_apply(tp, torch.from_numpy(u))
    np.testing.assert_allclose(y.numpy(), np.asarray(jssm.demand_forecaster_apply(jp, u)),
                               rtol=Y_RTOL, atol=Y_ATOL)
    h = tssm.demand_forecaster_state(tp, torch.from_numpy(u))
    np.testing.assert_allclose(h.numpy(), np.asarray(jssm.demand_forecaster_state(jp, u)),
                               rtol=Y_RTOL, atol=Y_ATOL)
    k = 400
    h_k = np.array(jssm.demand_forecaster_state(jp, u[:, :k]))
    jh, jy = jssm.demand_forecaster_step(jp, jnp.asarray(h_k), jnp.asarray(u[:, k]))
    th, ty = tssm.demand_forecaster_step(tp, torch.from_numpy(h_k), torch.from_numpy(u[:, k]))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=Y_RTOL, atol=Y_ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=Y_RTOL, atol=Y_ATOL)
    pred = tssm.demand_forecaster_predict(tp, series, scale, device="cpu")
    assert pred.dtype == torch.float64 and pred.device == CPU and bool((pred >= 0).all())
    np.testing.assert_allclose(pred.numpy(), jssm.demand_forecaster_predict(jp, series, scale),
                               rtol=PRED_RTOL, atol=0)


@pytest.mark.parametrize("S", [1, 8, 16])
def test_forecaster_checkpoints_match_jax_state(S):
    """The plain scan's checkpoint output: tile j holds JAX's
    ``demand_forecaster_state`` over the prefix ``u[:, :64 j]`` (zeros at
    j = 0), at the forecaster's tolerances; ``y`` and ``h`` are those of
    the scan without it, bit for bit."""
    series, scale, jp = _trained(S)
    tp = tree_from_reference(jp, device=CPU)
    u = _u(series, scale)
    ut = torch.from_numpy(u)
    ops_args = (ut, *tssm._operands(tp, CPU))
    ckpt = ops.forecaster_checkpoints(ut, S)
    y, h = ops.forecaster_scan(*ops_args, ckpt=ckpt)
    y0, h0 = ops.forecaster_scan(*ops_args)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    assert ckpt.shape == (-(-u.shape[1] // BWD_TILE), u.shape[0], S)
    assert not ckpt[0].any()
    for j in range(1, ckpt.shape[0]):
        want = np.asarray(jssm.demand_forecaster_state(jp, u[:, :BWD_TILE * j]))
        np.testing.assert_allclose(ckpt[j].numpy(), want, rtol=Y_RTOL, atol=Y_ATOL,
                                   err_msg=f"tile {j}")


def test_forecaster_nan_hour_poisons_its_row_as_in_jax():
    """One NaN hour makes the row's EMA state NaN for ever, in both packages;
    the other rows are untouched."""
    series, scale, jp = _trained(8)
    series = series.copy()
    series[1, 250] = np.nan
    want = jssm.demand_forecaster_predict(jp, series, scale)
    got = tssm.demand_forecaster_predict(tree_from_reference(jp, device=CPU), series, scale,
                                         device="cpu").numpy()
    assert np.isnan(got[1, 250:]).all() and np.isnan(want[1, 250:]).all()
    assert np.isfinite(got[1, :250]).all() and np.isfinite(np.delete(got, 1, 0)).all()
    np.testing.assert_allclose(got, want, rtol=PRED_RTOL, atol=0)


def test_forecaster_apply_equals_repeated_step():
    """The batch form and T steps of the tick form, bit for bit."""
    series, scale, jp = _trained(8)
    tp = tree_from_reference(jp, device=CPU)
    u = torch.from_numpy(_u(series, scale)[:, :60])
    y = tssm.demand_forecaster_apply(tp, u)
    h = torch.zeros((u.shape[0], 8), dtype=torch.float32)
    for t in range(u.shape[1]):
        h, y_t = tssm.demand_forecaster_step(tp, h, u[:, t])
        assert torch.equal(y_t, y[:, t]), t
    assert torch.equal(h, tssm.demand_forecaster_state(tp, u))


def _numpy_replay(u, a, oma, w, bias, h0):
    """The forecaster scan in numpy float32, hour by hour, in the kernel's
    order: h = a·h + (1−a)·u_t; p = (h − u_t)·w folded left; (u_t + acc) + b."""
    N, T = u.shape
    h = h0.copy()
    y = np.empty((N, T), np.float32)
    for t in range(T):
        ut = u[:, t:t + 1]
        h = a * h + oma * ut
        p = (h - ut) * w
        acc = p[:, 0].copy()
        for s in range(1, p.shape[1]):
            acc = acc + p[:, s]
        y[:, t] = (u[:, t] + acc) + bias
    return y, h


@pytest.mark.parametrize("h0_kind", ["zero", "seeded"])
@pytest.mark.parametrize("S", [1, 3, 8, 16])
def test_forecaster_plain_scan_equals_numpy_replay(S, h0_kind):
    rng = np.random.default_rng(S)
    N, T = 7, 90
    u = rng.normal(0.5, 0.4, (N, T)).astype(np.float32)
    u[2, 17] = np.nan
    raw_a = rng.normal(0, 2, S).astype(np.float32)
    a = torch.sigmoid(torch.from_numpy(raw_a))
    oma = 1.0 - a
    w = rng.normal(0, 0.1, S).astype(np.float32)
    bias = np.float32(rng.normal(0, 0.01))
    h0 = (np.zeros((N, S), np.float32) if h0_kind == "zero"
          else rng.normal(0.3, 0.2, (N, S)).astype(np.float32))
    want_y, want_h = _numpy_replay(u, a.numpy(), oma.numpy(), w, bias, h0)
    t = torch.from_numpy
    got_y, got_h = ops.forecaster_scan(t(u), a, oma, t(w), torch.tensor(bias), t(h0))
    assert got_y.dtype == got_h.dtype == torch.float32
    np.testing.assert_array_equal(got_y.numpy(), want_y)      # NaN in the same places
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    assert np.isnan(want_y[2, 17:]).all() and np.isfinite(np.delete(want_y, 2, 0)).all()
    none_y, state = ref.forecaster_scan_ref(t(u), a, oma, t(w), torch.tensor(bias), t(h0),
                                            write_y=False)
    assert none_y is None
    np.testing.assert_array_equal(state.numpy(), want_h)
    one_y, one_h = ops.forecaster_scan(t(u[:, :1]), a, oma, t(w), torch.tensor(bias), t(h0))
    np.testing.assert_array_equal(one_y[:, 0].numpy(), want_y[:, 0])
    assert one_h.shape == (N, S)


# -- the cost fit and the gates ------------------------------------------------

def _fit_inputs(seed, n=6, T=301):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 400, (n, T))
    d[1] = 120.0                                  # constant demand: slope 0
    vpn = 0.4 + 0.08 * d ** 0.9 * rng.uniform(0.95, 1.05, (n, T))
    cci = 1.2 + 0.02 * d
    vpn[2], cci[2] = 0.0, 0.0                     # an idle row
    return d, vpn, cci


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_cost_coef_and_predicted_costs_match_jax(seed):
    d, vpn, cci = _fit_inputs(seed)
    with enable_x64():
        want = np.array(jpol.fit_cost_coef(*(jnp.asarray(a) for a in (d, vpn, cci))))
    got = tpol.fit_cost_coef(*(torch.from_numpy(a) for a in (d, vpn, cci)))
    assert got.shape == (6, 4) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=COEF_RTOL, atol=1e-12)
    assert got[1, 1] == 0.0 and got[1, 3] == 0.0          # constant demand: slope 0
    pred = np.random.default_rng(seed + 7).uniform(0, 500, (6, 301))
    pred[3, 40:] = np.nan
    with enable_x64():
        jv, jc = (np.asarray(a) for a in jax.vmap(
            lambda p, c: jpol.predicted_mode_costs(p, c, jnp.float64))(
                jnp.asarray(pred), jnp.asarray(want)))
    tv, tc = tpol.predicted_mode_costs(torch.from_numpy(pred), torch.from_numpy(want),
                                       torch.float64)
    for g, w in ((tv, jv), (tc, jc)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=0)   # NaN where JAX's


def _step_case():
    """tests/test_policy.py's sustained regime shift, in both packages."""
    kw = dict(D=48, T_cci=96, h=96)
    T, t0 = 1500, 600
    d = np.full(T, 10.0)
    d[t0:] = 2000.0
    return (CostParams(2.0, 0.1, 0.02, 0.1, flat_rate(0.1), **kw),
            JCostParams(2.0, 0.1, 0.02, 0.1, jflat(0.1), **kw), d)


def _true_forward_mean(d, W):
    cs = np.concatenate([[0.0], np.cumsum(d)])
    T = d.shape[0]
    hi = np.minimum(np.arange(T) + W, T)
    return (cs[hi] - cs[np.arange(T)]) / np.maximum(hi - np.arange(T), 1)


def _one_row_scans(params, jparams, d, pred, margin):
    """The reactive and gated scans of one link in the port (rows of one) and
    the JAX gated scan, on the same cost series."""
    costs = hourly_cost_series(params, d)
    vpn, cci = (torch.from_numpy(np.asarray(a))[None] for a in (costs.vpn, costs.cci))
    tp = ToggleParams(*(t.reshape(1) for t in ToggleParams.from_cost_params(params)))
    ra = tpol.policy_scan(tpol.reactive_policy(tp), vpn, cci)
    fo = tpol.policy_scan(tpol.forecast_gated_policy(tp, pred[None], margin=margin), vpn, cci,
                          demand=torch.from_numpy(d)[None])
    with enable_x64():
        jc = jhourly(jparams, d)
        want = jpol.policy_scan(
            jpol.forecast_gated_policy(JToggle.from_cost_params(jparams), pred, margin=margin),
            jnp.asarray(jc.vpn), jnp.asarray(jc.cci), demand=jnp.asarray(d))
        want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(fo["x"][0].numpy(), want["x"])
    np.testing.assert_array_equal(fo["state"][0].numpy(), want["state"])
    np.testing.assert_allclose(fo["total_cost"].numpy(), want["total_cost"], rtol=COST_RTOL)
    return ra, fo


def test_forecast_policy_fires_early_on_sustained_regime_shift():
    """Mirror of tests/test_policy.py: with a perfect demand forecast the gated
    policy requests before the reactive window can, and ends up cheaper; its
    decisions equal JAX's."""
    params, jparams, d = _step_case()
    pred = _true_forward_mean(d, params.D + params.T_cci)
    ra, fo = _one_row_scans(params, jparams, d, pred, 0.05)
    first_req = lambda out: int(np.argmax(out["state"][0].numpy() != OFF))
    assert first_req(fo) < first_req(ra), "forecast must fire earlier"
    assert float(fo["total_cost"]) < float(ra["total_cost"])


def test_forecast_policy_suppresses_transient_spike():
    """Mirror of tests/test_policy.py: a 15-hour spike trips the reactive
    request; the forecast gate suppresses it."""
    kw = dict(D=24, T_cci=200, h=12)
    params = CostParams(2.0, 0.1, 0.02, 0.1, flat_rate(0.1), **kw)
    jparams = JCostParams(2.0, 0.1, 0.02, 0.1, jflat(0.1), **kw)
    d = np.full(1200, 5.0)
    d[300:315] = 300.0
    pred = _true_forward_mean(d, params.D + params.T_cci)
    ra, fo = _one_row_scans(params, jparams, d, pred, 0.05)
    assert int(ra["x"].sum()) > 0, "reactive takes the bait"
    assert int(fo["x"].sum()) == 0, "forecast suppresses the spike"
    assert float(fo["total_cost"]) < float(ra["total_cost"])


@pytest.mark.parametrize("coef", ["in_scan", "explicit"])
def test_forecast_policy_through_plan_fleet(coef):
    """Mirror of tests/test_policy.py: per-link predictions through plan_fleet
    beat reactive on the step trace; the plan equals JAX's, with the cost
    fit inside the scan and baked in."""
    params, jparams, d = _step_case()
    demand = np.stack([d, d])
    pred = np.stack([_true_forward_mean(row, params.D + params.T_cci) for row in demand])
    fleet = fleet_from_params([params, params])
    arrays = fleet.stack(torch.float64, CPU)
    with enable_x64():
        jarrays = jfleet_from_params([jparams, jparams]).stack(jnp.float64)
        c = None
        if coef == "explicit":
            s = jeng.routed_cost_series(jarrays, jnp.asarray(demand), hours_per_month=730)
            c = np.asarray(jpol.fit_cost_coef(s.row_demand, s.vpn, s.cci))
        jpolicy = jpol.forecast_gated_policy(jarrays.toggle, pred, margin=0.05, cost_coef=c)
    want = jeng.plan_fleet(jarrays, demand, policy=jpolicy, hours_per_month=730)
    got = teng.plan_fleet(arrays, demand, device="cpu", policy=tpol.forecast_gated_policy(
        arrays.toggle, pred, margin=0.05, cost_coef=c))
    _assert_plan(got, want)
    rplan = teng.plan_fleet(fleet, demand, device="cpu")
    assert bool((got["toggle_cost"] < rplan["toggle_cost"]).all())


def _assert_plan(got, want):
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("toggle_cost", "static_vpn", "static_cci"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=COST_RTOL,
                                   err_msg=k)


# -- a fleet scenario: the forecaster, the fit and the plan ---------------------

N_LINKS, HOURS, HISTORY = 8, 1000, 500


@functools.lru_cache(maxsize=None)
def _fleet_case(seed: int):
    """One fleet with history in both packages, the JAX forecaster trained on
    the clipped history, and each package's predictions over the history
    followed by the horizon (``pred[:, t] = y[:, H − 1 + t]``), as
    ``forecast_fleet_policy`` builds them."""
    jsc = jscen.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=seed)
    tsc = tscen.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=seed)
    assert np.array_equal(tsc.demand, jsc.demand) and np.array_equal(tsc.history, jsc.history)
    cap = np.array([l.capacity_gb_hr for l in jsc.fleet.links])[:, None]
    hist, live = np.minimum(jsc.history, cap), np.minimum(jsc.demand, cap)
    window = 144
    params, scale = jssm.train_demand_forecaster(hist, window, steps=30, seed=0)
    jp = jax.tree.map(np.asarray, params)
    full = np.concatenate([hist, live], axis=1)
    cut = lambda y: np.asarray(y)[:, HISTORY - 1:HISTORY - 1 + HOURS]
    jpred = cut(jssm.demand_forecaster_predict(jp, full, scale))
    tpred = cut(tssm.demand_forecaster_predict(tree_from_reference(jp, device=CPU), full,
                                               np.asarray(scale), device="cpu"))
    np.testing.assert_allclose(tpred, jpred, rtol=PRED_RTOL, atol=0)
    with enable_x64():
        d = jax_fleet_dict(jsc.fleet.stack(jnp.float64))
    return jsc, tsc, jpred, tpred, fleet_arrays_from_numpy(d, CPU)


def _jax_fleet_plan(jsc, pred, margin, coef, renew):
    with enable_x64():
        arrays = jsc.fleet.stack(jnp.float64)
        c = None
        if coef:
            s = jeng.routed_cost_series(arrays, jnp.asarray(jsc.demand), hours_per_month=730)
            c = np.asarray(jpol.fit_cost_coef(s.row_demand, s.vpn, s.cci))
        pol = jpol.forecast_gated_policy(arrays.toggle, pred, margin=margin, cost_coef=c,
                                         renew_in_chunks=renew)
    return jeng.plan_fleet(arrays, jsc.demand, policy=pol, hours_per_month=730), c


def _port_fleet_plan(tsc, arrays, pred, margin, coef, renew):
    c = None
    if coef:
        s = teng.routed_cost_series(arrays, tsc.demand, hours_per_month=730, device="cpu")
        c = tpol.fit_cost_coef(s.row_demand, s.vpn, s.cci)
    pol = tpol.forecast_gated_policy(arrays.toggle, pred, margin=margin, cost_coef=c,
                                     renew_in_chunks=renew)
    return teng.plan_fleet(arrays, tsc.demand, policy=pol, device="cpu"), c


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("coef", [False, True], ids=["in_scan", "explicit"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forecast_fleet_plan_matches_jax(seed, coef, renew):
    """The whole policy with each package's own predictions and cost fit,
    per-family margins."""
    jsc, tsc, jpred, tpred, arrays = _fleet_case(seed)
    margin = tpol.family_margins([l.family for l in tsc.fleet.links])
    want, jc = _jax_fleet_plan(jsc, jpred, margin, coef, renew)
    got, tc = _port_fleet_plan(tsc, arrays, tpred, margin, coef, renew)
    if coef:
        np.testing.assert_allclose(tc.numpy(), jc, rtol=COEF_RTOL, atol=1e-12)
    _assert_plan(got, want)
    assert 0 < int(got["x"].sum()) < got["x"].numel()


@pytest.mark.parametrize("margin", [0.0, 1e30])
def test_forecast_margins_zero_and_infinite(margin):
    """Margin 0 (the forecast confirms or vetoes every trigger) equals JAX;
    margin 1e30 (it can neither fire nor veto) is the reactive plan, bit for
    bit."""
    jsc, tsc, jpred, tpred, arrays = _fleet_case(0)
    want, _ = _jax_fleet_plan(jsc, jpred, margin, True, False)
    got, _ = _port_fleet_plan(tsc, arrays, tpred, margin, True, False)
    _assert_plan(got, want)
    if margin == 1e30:
        reactive = teng.plan_fleet(arrays, tsc.demand, device="cpu")
        for k in reactive:
            assert torch.equal(got[k], reactive[k]), k
    else:
        assert not torch.equal(got["x"], teng.plan_fleet(arrays, tsc.demand, device="cpu")["x"])


def test_forecast_nan_predictions_match_jax():
    """Rows whose predictions turn NaN: from then on the gates neither fire
    nor veto anything, in both packages."""
    jsc, tsc, jpred, tpred, arrays = _fleet_case(1)
    jpred, tpred = jpred.copy(), tpred.copy()
    jpred[[0, 5], 300:] = np.nan
    tpred[[0, 5], 300:] = np.nan
    want, _ = _jax_fleet_plan(jsc, jpred, 0.05, True, False)
    got, _ = _port_fleet_plan(tsc, arrays, tpred, 0.05, True, False)
    _assert_plan(got, want)
    st = got["state"].numpy()
    assert (st[[0, 5], 300:] == st[[0, 5], 300:301]).all()    # no transition starts


# -- the gated scan's operands: the prediction and the cost coefficients ---------
#
# policy_scan hands the dispatcher the predicted demand, the cost coefficients
# and the margins (the card's kernel forms the predicted mode costs itself);
# held against JAX's policy_scan on rows that are not a multiple of the
# kernel's 16, at tile edges (T of 1, 63, 64, 65), with predictions that are
# NaN, -1 (log1p gives -inf) and below -1 (NaN).

GATE_N = 19
GATE_MARGINS = {"0": 0.0, "0.05": 0.05, "1e30": 1e30,
                "mixed": np.resize([0.0, 0.05, 0.15, 1e30], GATE_N)}
_JRUN = jax.jit(jeng._run_policies)


@functools.lru_cache(maxsize=None)
def _gate_case(T: int):
    """Demand in 8-hour regimes and its hourly costs (a VPN bill concave in
    demand, a CCI bill affine in it, so the cost ratio crosses the
    thresholds), toggle parameters (windows from 1 hour to past T),
    predictions near the demand with row 2 NaN from T // 3, an hour of -1 in
    row 4 and one below -1 in row 5, and the cost coefficients fitted on the
    realized series; all numpy."""
    rng = np.random.default_rng(T)
    d = np.repeat(rng.uniform(0, 400, (GATE_N, T // 8 + 1)), 8, axis=1)[:, :T]
    d = d * rng.uniform(0.9, 1.1, (GATE_N, T))
    vpn = 0.4 + 0.08 * d ** 0.9 * rng.uniform(0.95, 1.05, (GATE_N, T))
    cci = 1.2 + 0.02 * d
    tog = dict(theta1=rng.uniform(0.85, 0.95, GATE_N), theta2=rng.uniform(1.05, 1.2, GATE_N),
               h=1 + (np.arange(GATE_N) * (T + 2)) // (GATE_N - 1),
               D=np.resize([0, 3, 10, 1], GATE_N), T_cci=np.resize([1, 5, 24, 12, 2], GATE_N))
    pred = d * rng.uniform(0.5, 1.5, (GATE_N, T))
    pred[2, T // 3:] = np.nan
    pred[4, T // 2] = -1.0
    pred[5, T // 2] = -1.5
    coef = tpol.fit_cost_coef(*(torch.from_numpy(a) for a in (d, vpn, cci))).numpy()
    return d, vpn, cci, tog, pred, coef


def _gate_policies(T, margin, coef, renew):
    """The port's and JAX's forecast-gated policies of :func:`_gate_case`."""
    d, vpn, cci, tog, pred, c = _gate_case(T)
    c = c if coef else None
    ttog = ToggleParams(*(torch.tensor(tog[k], dtype=torch.float64 if k.startswith("theta")
                                       else torch.int32)
                          for k in ("theta1", "theta2", "h", "D", "T_cci")))
    tp = tpol.forecast_gated_policy(ttog, pred, margin=GATE_MARGINS[margin], cost_coef=c,
                                    renew_in_chunks=renew)
    with enable_x64():
        jtog = JToggle(*(jnp.asarray(tog[k], jnp.float64 if k.startswith("theta") else jnp.int32)
                         for k in ("theta1", "theta2", "h", "D", "T_cci")))
        jp = jpol.forecast_gated_policy(jtog, pred, margin=GATE_MARGINS[margin], cost_coef=c,
                                        renew_in_chunks=renew)
    return tp, jp


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("coef", [True, False], ids=["given", "fitted"])
@pytest.mark.parametrize("T", [1, 63, 64, 65])
def test_gated_policy_scan_pred_and_coef_match_jax(T, coef, renew):
    """The port's policy_scan (its gate the prediction, the coefficients,
    given or fitted on ``demand``, and the margins) against JAX's
    policy_scan under vmap, at margins 0, 0.05, 1e30 and mixed by row:
    decisions equal, costs rtol 1e-9."""
    d, vpn, cci = _gate_case(T)[:3]
    for margin in GATE_MARGINS:
        tp, jp = _gate_policies(T, margin, coef, renew)
        got = tpol.policy_scan(tp, *(torch.from_numpy(a) for a in (vpn, cci)),
                               demand=torch.from_numpy(d))
        with enable_x64():
            want = _JRUN(jp, *(jnp.asarray(a) for a in (d, vpn, cci)))
        for k in ("x", "state"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k}, margin {margin}")
        np.testing.assert_allclose(got["total_cost"].numpy(), np.asarray(want["total_cost"]),
                                   rtol=COST_RTOL, err_msg=f"margin {margin}")


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("T", [1, 63, 64, 65])
def test_gated_plain_form_equals_the_planes_path(T, renew):
    """The plain version's gate form (prediction, coefficients, margins)
    against the path it replaced (the policy's predicted-cost planes from
    ``features``, then the gating on them), every output bit, fitted and
    given coefficients, each margin."""
    d, vpn, cci = (torch.from_numpy(a) for a in _gate_case(T)[:3])
    for coef in (True, False):
        for margin in GATE_MARGINS:
            tp, _ = _gate_policies(T, margin, coef, renew)
            got = tpol.policy_scan(tp, vpn, cci, demand=d)
            one = torch.ones(GATE_N, dtype=torch.int32)
            want = ref.fsm_scan_planes_ref(vpn, cci, *tp.toggle, one, one, renew_in_chunks=renew,
                                           planes=tp.features(d, vpn, cci) + (tp.margin,))
            for k in ("x", "state", "total_cost"):
                assert torch.equal(got[k], want[k]), (k, coef, margin)
    assert int(got["x"].sum()) > 0


# -- per-port policies: plan_topology and its replay ----------------------------

@functools.lru_cache(maxsize=None)
def _topology_case():
    build = lambda m: m.build_topology_scenario(
        12, n_facilities=3, ports_per_facility=2, horizon=800, history_hours=400,
        families=("bursty", "mirage"), seed=6)
    jsc, tsc = build(jscen), build(tscen)
    jr, tr = jtop.optimize_routing(jsc.topo, jsc.demand), ttop.optimize_routing(tsc.topo,
                                                                               tsc.demand)
    assert jr.paths == tr.paths
    with enable_x64():
        jarrays = jsc.topo.stack(jr, jnp.float64)
    tarrays = tsc.topo.stack(tr, torch.float64, CPU)
    # each port's aggregate, as forecast_topology_policy builds it
    op = jarrays.routing
    M, P = tarrays.n_ports, tsc.n_pairs
    R = np.zeros((M, P))
    np.add.at(R, (np.asarray(op.leg_port), np.asarray(op.leg_pair)),
              np.asarray(op.attach_w, np.float64))
    pair_cap = np.asarray(jarrays.pair_capacity)[:, None]
    port_cap = np.asarray(jarrays.port_capacity)[:, None]
    agg = lambda d: np.minimum(R @ np.minimum(d, pair_cap), port_cap)
    hist, live = agg(jsc.history), agg(jsc.demand)
    params, scale = jssm.train_demand_forecaster(hist, 200, steps=30, seed=0)
    jp = jax.tree.map(np.asarray, params)
    full = np.concatenate([hist, live], axis=1)
    cut = lambda y: np.asarray(y)[:, 399:399 + 800]
    jpred = cut(jssm.demand_forecaster_predict(jp, full, scale))
    tpred = cut(tssm.demand_forecaster_predict(tree_from_reference(jp, device=CPU), full,
                                               np.asarray(scale), device="cpu"))
    np.testing.assert_allclose(tpred, jpred, rtol=PRED_RTOL, atol=0)
    return jsc, tsc, jr, tr, jarrays, tarrays, jpred, tpred


@pytest.mark.parametrize("coef", [False, True], ids=["in_scan", "explicit"])
def test_forecast_plan_topology_and_replay_match_jax(coef):
    """A per-port policy through plan_topology and a one-segment
    replay_plan_topology, against JAX's; the replay equals the plan bit for
    bit."""
    jsc, tsc, jr, tr, jarrays, tarrays, jpred, tpred = _topology_case()
    margin = 0.05
    with enable_x64():
        c = None
        if coef:
            s = jeng.routed_cost_series(jarrays, jnp.asarray(jsc.demand), hours_per_month=730)
            c = np.asarray(jpol.fit_cost_coef(s.row_demand, s.vpn, s.cci))
        jpolicy = jpol.forecast_gated_policy(jarrays.toggle, jpred, margin=margin, cost_coef=c)
    want = jeng.plan_topology(jarrays, jsc.demand, policy=jpolicy, hours_per_month=730)
    jreplay = jeng.replay_plan_topology(jarrays, jsc.demand, [(0, jr)], policy=jpolicy)
    tc = None
    if coef:
        s = teng.routed_cost_series(tarrays, tsc.demand, hours_per_month=730, device="cpu")
        tc = tpol.fit_cost_coef(s.row_demand, s.vpn, s.cci)
        np.testing.assert_allclose(tc.numpy(), c, rtol=COEF_RTOL, atol=1e-12)
    policy = tpol.forecast_gated_policy(tarrays.toggle, tpred, margin=margin, cost_coef=tc)
    got = teng.plan_topology(tarrays, tsc.demand, policy=policy, device="cpu")
    replay = teng.replay_plan_topology(tarrays, tsc.demand, [(0, tr)], policy=policy,
                                       device="cpu")
    _assert_plan(got, want)
    _assert_plan(replay, jreplay)
    for k in replay:
        assert torch.equal(replay[k], got[k]), k
    assert 0 < int(got["x"].sum()) < got["x"].numel()


# -- the tables, the window and the errors -------------------------------------

def test_family_margins_and_forecast_horizon_match_jax():
    assert tpol.FAMILY_MARGINS == jpol.FAMILY_MARGINS
    assert tplan.FAMILY_MARGINS is tpol.FAMILY_MARGINS
    fams = ["mirage", "bursty", "unknown", "puffer", "constant"]
    for kw in ({}, dict(default=0.07, overrides={"bursty": 0.2})):
        got, want = tpol.family_margins(fams, **kw), jpol.family_margins(fams, **kw)
        assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)
    jsc, _, _, _, arrays = _fleet_case(0)
    with enable_x64():
        jtoggle = jsc.fleet.stack(jnp.float64).toggle
    assert tpol.forecast_horizon_hours(arrays.toggle) == jpol.forecast_horizon_hours(jtoggle)


def test_forecast_gated_policy_fields_and_checks():
    jsc, tsc, jpred, tpred, arrays = _fleet_case(0)
    pol = tpol.forecast_gated_policy(arrays.toggle, tpred, margin=0.1)
    assert pol.kind == "forecast" and pol.cost_coef is None and not pol.renew_in_chunks
    assert pol.margin.shape == (N_LINKS,) and pol.margin.dtype == torch.float64
    assert pol.pred_demand.dtype == torch.float64 and pol.pred_demand.shape == (N_LINKS, HOURS)
    s = teng.routed_cost_series(arrays, tsc.demand, hours_per_month=730, device="cpu")
    with pytest.raises(ValueError, match="demand series"):
        tpol.policy_scan(pol, s.vpn, s.cci)
    with pytest.raises(ValueError, match="pred_demand"):
        tpol.policy_scan(pol._replace(pred_demand=pol.pred_demand[:, :10]), s.vpn, s.cci,
                         demand=s.row_demand)
    before = dict(ops.LAUNCHES)
    tpol.policy_scan(pol, s.vpn, s.cci, demand=s.row_demand)
    assert ops.LAUNCHES == before                  # the CPU runs the plain versions


def test_forecast_kind_and_training_raise_as_documented():
    """make_policy("forecast") raises JAX's ValueError text; the factories
    that train run (item 6c is ported): ``train_demand_forecaster`` and
    ``forecast_port_demand`` against JAX's on a short history (parameters
    and predictions within 1e-3), ``forecast_fleet_policy`` and
    ``forecast_topology_policy`` return a forecast policy with its cost
    coefficients, the streaming forecaster's ``fit`` and
    ``streaming_forecast_policy`` a trained forecaster (the parity of each
    with JAX is ``tests/test_torch_forecast_train.py``); the LM mixers raise
    naming item 11; the runtime refuses a policy without its cost
    coefficients with the reference's text and streams one that has them;
    nothing accepts the policy and runs it as something else."""
    toggle = ToggleParams(*(torch.zeros(1, dtype=dt) for dt in (torch.float64,) * 2
                            + (torch.int32,) * 3))
    with pytest.raises(ValueError) as got:
        tpol.make_policy("forecast", toggle)
    with pytest.raises(ValueError) as want:
        jpol.make_policy("forecast", None)
    assert str(got.value) == str(want.value)
    series, _, _ = _trained(1)
    got, scale = tssm.train_demand_forecaster(series[:, :200], 24, state_dim=1, steps=5,
                                              device="cpu")
    want, jscale = jssm.train_demand_forecaster(series[:, :200], 24, state_dim=1, steps=5)
    np.testing.assert_array_equal(scale, np.asarray(jscale))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-3, atol=1e-6)
    pred = tpol.forecast_port_demand(series[:, :200], series[:, 200:], 24, steps=5,
                                     device="cpu")
    np.testing.assert_allclose(pred.numpy(), jpol.forecast_port_demand(
        series[:, :200], series[:, 200:], 24, steps=5), rtol=1e-3)
    for fn in (tssm.mamba_apply, tssm.mlstm_decode, tssm.slstm_init):
        with pytest.raises(NotImplementedError, match="item 11"):
            fn(None)
    _, tsc, _, tpred, arrays = _fleet_case(0)
    pol = tpol.forecast_gated_policy(arrays.toggle, tpred)
    with pytest.raises(ValueError, match="needs explicit demand->cost coefficients"):
        trt.FleetRuntime(tsc.fleet, policy=pol, device="cpu")
    s = teng.routed_cost_series(arrays, tsc.demand, hours_per_month=730, device="cpu")
    pol = pol._replace(cost_coef=tpol.fit_cost_coef(s.row_demand, s.vpn, s.cci))
    assert trt.RuntimeConfig(policy=pol).validate().policy is pol
    streamed = trt.FleetRuntime(tsc.fleet, policy=pol, device="cpu").step_many(tsc.demand[:, :48])
    planned = teng.plan_fleet(arrays, tsc.demand, policy=pol, device="cpu")
    np.testing.assert_array_equal(streamed["x"], planned["x"][:, :48].numpy())
    fpol = tpol.forecast_fleet_policy(arrays, tsc.demand, tsc.history, steps=2, device="cpu")
    assert fpol.kind == "forecast" and fpol.cost_coef.shape == (N_LINKS, 4)
    assert fpol.pred_demand.shape == tsc.demand.shape
    _, tsc_t, _, _, _, tarrays, _, _ = _topology_case()
    tpol_t = tpol.forecast_topology_policy(tarrays, tsc_t.demand, tsc_t.history, steps=2,
                                           device="cpu")
    assert tpol_t.pred_demand.shape == (tarrays.n_ports, tsc_t.demand.shape[1])
    fc = tstream.StreamingForecaster.fit(tsc.history, 24, steps=2, device="cpu")
    assert fc.h0.shape == (N_LINKS, 8) and fc.pred0.shape == (N_LINKS,)
    lpol, lfc = tstream.streaming_forecast_policy(arrays, tsc.history, steps=2, device="cpu")
    assert lpol.cost_coef.shape == (N_LINKS, 4) and lfc.h0.shape == (N_LINKS, 8)
    with pytest.raises(ValueError, match="forecast_gated_policy"):
        teng.plan_fleet(dataclasses.replace(tsc.fleet, policy="forecast"), tsc.demand,
                        device="cpu")
