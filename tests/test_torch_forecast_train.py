"""Training the demand forecaster: port vs JAX package, on the CPU.

The port's AdamW (:mod:`repro_torch.optim.adamw`), the forecaster's
backward pass (``ops.forecaster_scan_bwd``: its plain version here, under
the ``torch.autograd.Function`` of ``models/ssm.py``), its training
(``train_demand_forecaster``) and the factories that train
(``forecast_port_demand``, ``forecast_fleet_policy``,
``forecast_topology_policy``, ``StreamingForecaster.fit``,
``streaming_forecast_policy``), each beside the JAX package's on the same
seeded numpy inputs.

Tolerances, and why:

* AdamW ``rtol=1e-6``: the same elementwise update in the same order; the
  global norm's sums and ``b^step`` may round otherwise than XLA's
  (bfloat16 moments: within one bfloat16 step of JAX's, where the float32
  moment before the cast differs in its last place).
* Gradients ``rtol=1e-4, atol=1e-6`` against ``jax.grad`` of the
  reference's loss and against float64 torch autograd through an unrolled
  step loop: XLA orders its float32 sums otherwise (and JAX's sigmoid
  gradient is ``g·ans·(1 − ans)``); float64 differs by float32's rounding.
* Training ``rtol=1e-3`` on every step's loss and the final parameters:
  each step carries the one before it's rounding, and the targets' prefix
  sums (XLA's ``cumsum`` against the port's sequential float32 prefix)
  differ in the last places.
* Factories: predictions ``rtol=1e-3`` (trained parameters at 1e-3),
  cost coefficients ``rtol=1e-9`` (fitted on float64 series, reductions in
  another order). Decisions equal, except at an hour where a gate lies
  within the two packages' forecast difference of its threshold; such
  hours are counted and printed.

The reference's own training tests (``tests/test_policy.py:273-320``) fail
at collection on JAX 0.9.0 and are mirrored here for the port.
"""
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU
from test_torch_stream_live import _fleet as _live_fleet
from test_torch_stream_live import _jax_fleet, _jax_stream
from test_torch_stream_forecast import _stream

import jax
import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.fleet import engine as jeng
from repro.fleet import policy as jpol
from repro.fleet import runtime as jrt
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.models import ssm as jssm
from repro.optim import adamw as jadamw

from repro_torch.fleet import FleetRuntime, StreamingForecaster, streaming_forecast_policy
from repro_torch.fleet import policy as tpol
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import topology as ttop
from repro_torch.fleet.engine import plan_fleet, plan_topology
from repro_torch.fleet.policy import predicted_mode_costs
from repro_torch.kernels import ops
from repro_torch.models import ssm as tssm
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm

ADAM_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
TRAIN_RTOL = 1e-3
PRED_RTOL = 1e-3
COEF_RTOL = 1e-9


def _np(tree):
    return {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v, np.float32)
            for k, v in tree.items()}


# -- AdamW -----------------------------------------------------------------------

def _adam_case(seed: int, steps: int, grad_scale: float):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 1, 3).astype(np.float32),
              "s": np.float32(rng.normal())}
    grads = [{k: (grad_scale * rng.normal(0, 1, np.shape(v))).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("steps", [1, 10])
def test_adamw_matches_jax(steps, clip, wd, moments):
    """Parameters, both moments, the step, grad_norm and clip_scale after 1
    and 10 updates, clipping active (norm ~4 against 1) and inactive (~0.04),
    weight decay 0 and 0.1, float32 and bfloat16 moments, lr_scale 0.5."""
    params, grads = _adam_case(steps, steps, 1.0 if clip == "active" else 0.01)
    cfg = AdamWConfig(lr=2e-2, weight_decay=wd, moment_dtype=moments)
    jcfg = jadamw.AdamWConfig(lr=2e-2, weight_decay=wd, moment_dtype=moments)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = adamw_init(tp, cfg), jadamw.adamw_init(jp, jcfg)
    for g in grads:
        tp, ts, tm = adamw_update(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, cfg,
                                  lr_scale=0.5)
        jp, js, jm = jadamw.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                                         jcfg, lr_scale=0.5)
    assert ts["step"] == int(js["step"]) == steps
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=ADAM_RTOL, err_msg=k)
        for mom in ("m", "v"):
            got, want = ts[mom][k], np.asarray(js[mom][k])
            assert str(got.dtype).endswith(moments)
            got, want = got.float().numpy(), want.astype(np.float32)
            # one bfloat16 step (2^-8 relative) where the float32 moments differ last
            tol = ADAM_RTOL if moments == "float32" else 2.0 ** -7
            np.testing.assert_allclose(got, want, rtol=tol, err_msg=f"{mom}[{k}]")
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=ADAM_RTOL)
    np.testing.assert_allclose(float(tm["clip_scale"]), float(jm["clip_scale"]), rtol=ADAM_RTOL)
    assert (float(tm["clip_scale"]) < 1.0) == (clip == "active")


def test_global_norm_folds_in_a_fixed_order():
    """The pairwise halving fold of each leaf, then the leaves left in sorted
    key order: equal to a numpy replay of that order bit for bit, close to
    JAX's, and 0-dim on the leaves' device; no leaves is an error."""
    rng = np.random.default_rng(3)
    tree = {"z": rng.normal(size=(7, 5)).astype(np.float32),
            "a": rng.normal(size=13).astype(np.float32), "m": np.float32(2.5)}

    def halving(x):
        x = (x.reshape(-1).astype(np.float32)) ** 2
        while x.size > 1:
            h = x.size // 2
            x = np.concatenate([x[:h] + x[h:2 * h], x[2 * h:]])
        return x[0]

    acc = np.float32(0.0)
    for i, k in enumerate(sorted(tree)):
        acc = halving(np.asarray(tree[k])) if i == 0 else np.float32(acc + halving(
            np.asarray(tree[k])))
    got = global_norm({k: torch.tensor(v) for k, v in tree.items()})
    assert got.shape == () and got.dtype == torch.float32
    assert got.numpy().tobytes() == np.sqrt(acc).tobytes()
    np.testing.assert_allclose(float(got), float(jadamw.global_norm(tree)), rtol=ADAM_RTOL)
    with pytest.raises(ValueError, match="no leaves"):
        global_norm({})
    with pytest.raises(ValueError, match="moment_dtype"):
        adamw_init({"a": torch.zeros(2)}, AdamWConfig(moment_dtype="float16"))


def test_adamw_without_clipping_matches_jax():
    """clip_norm 0: no clipping, clip_scale 1.0, as in the reference."""
    params, grads = _adam_case(7, 3, 5.0)
    cfg, jcfg = AdamWConfig(clip_norm=0.0), jadamw.AdamWConfig(clip_norm=0.0)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = adamw_init(tp, cfg), jadamw.adamw_init(jp, jcfg)
    for g in grads:
        tp, ts, tm = adamw_update(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, cfg)
        jp, js, jm = jadamw.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
    assert tm["clip_scale"] == jm["clip_scale"] == 1.0
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=ADAM_RTOL, err_msg=k)


# -- the gradients -----------------------------------------------------------------

def _series(seed: int, n: int, H: int) -> np.ndarray:
    """Seasonal and trending demand with noise (the reference's test traces)."""
    rng = np.random.default_rng(seed)
    t = np.arange(H)
    k = n // 2
    return np.concatenate([
        50 * (1 + 0.5 * np.sin(2 * np.pi * t / 168)) + rng.normal(0, 4, (k, H)),
        30 * (1 + t / max(H, 1)) + rng.normal(0, 3, (n - k, H)),
    ]).clip(min=0.0)


def _jax_loss_fn(series, window):
    """The reference's loss (``src/repro/models/ssm.py:549-576``), as a
    function of the parameters."""
    s = np.asarray(series, np.float64)
    scale = np.maximum(s.mean(axis=1), 1e-9)
    u_lin = jnp.asarray(s / scale[:, None], jnp.float32)
    u = jnp.log1p(u_lin)
    N, H = u.shape
    W = int(max(1, min(window, H - 1)))
    csum = jnp.concatenate([jnp.zeros((N, 1), jnp.float32), jnp.cumsum(u_lin, axis=1)], axis=1)
    t_idx = jnp.arange(H)
    hi = jnp.minimum(t_idx + 1 + W, H)
    target = jnp.log1p((csum[:, hi] - csum[:, t_idx + 1]) / W)
    mask = (t_idx + 1 + W <= H).astype(jnp.float32)[None, :]
    denom = jnp.maximum(jnp.sum(mask), 1.0) * N

    def loss_fn(p):
        err = (jssm.demand_forecaster_apply(p, u) - target) ** 2 * mask
        return jnp.sum(err) / denom

    return loss_fn


def _point(kind: str, S: int):
    """The persistence init, or a seeded point (timescales moved, a readout
    and a bias drawn), as float32 numpy leaves."""
    p = _np(tssm.demand_forecaster_init(None, S, device="cpu"))
    if kind == "seeded":
        rng = np.random.default_rng(S)
        p = {"raw_a": (p["raw_a"] + rng.normal(0, 0.3, S)).astype(np.float32),
             "w": rng.normal(0, 0.2, S).astype(np.float32),
             "bias": np.float32(rng.normal(0, 0.05))}
    return p


def _port_grads(series, window, point):
    s = np.asarray(series, np.float64)
    _, u, target, dy_weight = tssm._training_inputs(s, window)
    loss, g = tssm._loss_and_grads({k: torch.tensor(v) for k, v in point.items()}, u, target,
                                   dy_weight)
    return float(loss), _np(g)


def _f64_grads(series, window, point):
    """float64 torch autograd through an unrolled step loop, the loss the
    reference's in float64."""
    s = np.asarray(series, np.float64)
    scale = np.maximum(s.mean(axis=1), 1e-9)
    u_lin = torch.tensor(s / scale[:, None])
    u = torch.log1p(u_lin)
    N, H = u.shape
    W = int(max(1, min(window, H - 1)))
    csum = torch.cat([torch.zeros((N, 1), dtype=torch.float64), torch.cumsum(u_lin, 1)], 1)
    t = torch.arange(H)
    hi = torch.clamp(t + 1 + W, max=H)
    target = torch.log1p((csum[:, hi] - csum[:, t + 1]) / W)
    mask = (t + 1 + W <= H).double()
    p = {k: torch.tensor(np.asarray(v, np.float64), requires_grad=True) for k, v in point.items()}
    a = torch.sigmoid(p["raw_a"])
    h = torch.zeros((N, a.shape[0]), dtype=torch.float64)
    ys = []
    for j in range(H):
        h = a * h + (1 - a) * u[:, j, None]
        ys.append(u[:, j] + (h - u[:, j, None]) @ p["w"] + p["bias"])
    y = torch.stack(ys, 1)
    loss = (((y - target) ** 2) * mask).sum() / (max(float(mask.sum()), 1.0) * N)
    loss.backward()
    return {k: v.grad.numpy() for k, v in p.items()}


@pytest.mark.parametrize("point", ["init", "seeded"])
@pytest.mark.parametrize("window", ["short", "at", "past"])
@pytest.mark.parametrize("H", [2, 65, 300])
@pytest.mark.parametrize("S", [1, 8, 16])
def test_gradients_match_jax_grad_and_float64_autograd(S, H, window, point):
    """The port's gradients (the Function's plain backward, autograd through
    the host's sigmoid) against ``jax.grad`` of the reference's loss and
    float64 autograd, windows of 24 hours, ``H − 1`` and past the horizon
    (both ``W = H − 1``: one masked-in hour), at the persistence init (where
    ``raw_a``'s gradient is 0) and at a seeded point."""
    series = _series(10 * S + H, 5, H)
    win = {"short": 24, "at": H - 1, "past": H + 7}[window]
    p = _point(point, S)
    loss, got = _port_grads(series, win, p)
    jloss, jg = jax.value_and_grad(_jax_loss_fn(series, win))({k: jnp.asarray(v)
                                                               for k, v in p.items()})
    f64 = _f64_grads(series, win, p)
    np.testing.assert_allclose(loss, float(jloss), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for k in p:
        np.testing.assert_allclose(got[k], np.asarray(jg[k]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"jax {k}")
        np.testing.assert_allclose(got[k], f64[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"float64 {k}")
    if point == "init":
        assert not got["raw_a"].any()


def test_training_inputs_match_the_reference_formulas():
    """u, the windowed targets (within float32 rounding of JAX's XLA
    cumsum) and the mask/denominator at H = 2 (one masked-in hour), a window
    past the horizon and an ordinary one; the prefix is the sequential
    float32 one."""
    for H, window in ((2, 5), (40, 100), (300, 24)):
        s = _series(H, 3, H)
        scale, u, target, dy_weight = tssm._training_inputs(s, window)
        W = max(1, min(window, H - 1))
        u_lin = (s / scale[:, None]).astype(np.float32)
        np.testing.assert_array_equal(u.numpy(), torch.log1p(torch.from_numpy(u_lin)).numpy())
        csum = np.zeros((3, H + 1), np.float32)
        for j in range(H):
            csum[:, j + 1] = csum[:, j] + u_lin[:, j]
        t = np.arange(H)
        mask = (t + 1 + W <= H)
        want = np.log1p((csum[:, np.minimum(t + 1 + W, H)] - csum[:, t + 1]) / np.float32(W))
        np.testing.assert_allclose(target.numpy(), want, rtol=1e-6)
        denom = np.float32(max(mask.sum(), 1) * 3)
        assert np.array_equal(dy_weight.numpy(), np.broadcast_to(
            np.where(mask, np.float32(1) / denom, np.float32(0)), (3, H)))
        if H == 2:
            assert mask.sum() == 1


def test_nan_hour_makes_loss_and_parameters_nan_as_in_jax():
    """A NaN hour in the history: the loss is NaN and, after one step, every
    parameter, in both packages (``NaN · 0`` in the mask); no masking of the
    port's own."""
    s = _series(4, 4, 120)
    s[1, 50] = np.nan
    losses = []
    got, _ = tssm.train_demand_forecaster(s, 24, steps=1, device="cpu", losses=losses)
    want, _ = jssm.train_demand_forecaster(s, 24, steps=1)
    assert np.isnan(float(losses[0]))
    for k in want:
        assert np.isnan(got[k].numpy()).all() and np.isnan(np.asarray(want[k])).all(), k


# -- training ----------------------------------------------------------------------

def _jax_train(series, window, S, steps):
    """The reference's training loop (``src/repro/models/ssm.py:567-583``),
    keeping every step's loss."""
    loss_fn = _jax_loss_fn(series, window)
    params = jssm.demand_forecaster_init(None, S)
    cfg = jadamw.AdamWConfig(lr=2e-2, weight_decay=0.0, clip_norm=1.0)
    opt = jadamw.adamw_init(params, cfg)

    @jax.jit
    def step(params, opt):
        loss, g = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = jadamw.adamw_update(params, g, opt, cfg)
        return params, opt, loss

    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("S", [1, 8])
def test_training_matches_jax(S):
    """Every step's loss and the final parameters against JAX's training
    (40 steps on five series of 400 hours, window 48); the loop that keeps
    JAX's losses ends where the reference's ``train_demand_forecaster``
    does; one forward and one backward scan a step (the plain versions
    here: no kernel launch on the CPU)."""
    series = _series(S, 5, 400)
    steps = 40
    want, jlosses = _jax_train(series, 48, S, steps)
    ref_params, ref_scale = jssm.train_demand_forecaster(series, 48, state_dim=S, steps=steps)
    for k in want:
        np.testing.assert_allclose(np.asarray(want[k]), np.asarray(ref_params[k]), rtol=1e-6)
    before = dict(ops.LAUNCHES)
    losses = []
    got, scale = tssm.train_demand_forecaster(series, 48, state_dim=S, steps=steps, device="cpu",
                                              losses=losses)
    assert ops.LAUNCHES == before
    assert isinstance(scale, np.ndarray) and scale.dtype == np.float64
    np.testing.assert_array_equal(scale, np.asarray(ref_scale))
    np.testing.assert_allclose([float(x) for x in losses], jlosses, rtol=TRAIN_RTOL)
    assert losses[-1] < losses[0]
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].shape == np.shape(want[k])
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=TRAIN_RTOL,
                                   atol=1e-6, err_msg=k)


def test_training_refuses_short_series_and_leaves_seed_unused():
    """Fewer than 2 hours is refused; ``seed`` changes nothing (the init is
    deterministic, as in the reference)."""
    with pytest.raises(ValueError, match="H >= 2"):
        tssm.train_demand_forecaster(np.ones((3, 1)), 24, device="cpu")
    s = _series(2, 2, 50)
    a, _ = tssm.train_demand_forecaster(s, 12, steps=3, seed=0, device="cpu")
    b, _ = tssm.train_demand_forecaster(s, 12, steps=3, seed=9, device="cpu")
    for k in a:
        assert torch.equal(a[k], b[k])


def test_scan_function_refuses_a_gradient_for_its_input():
    """The Function forms no gradient with respect to u: asking for one is
    an error, not zeros."""
    p = {k: v.requires_grad_(True) for k, v in tssm.demand_forecaster_init(
        None, 4, device="cpu").items()}
    u = torch.rand((2, 10), requires_grad=True)
    with pytest.raises(ValueError, match="no gradient with respect to u"):
        tssm.demand_forecaster_apply(p, u)
    y = tssm.demand_forecaster_apply(p, u.detach())
    assert y.requires_grad
    with torch.no_grad():
        assert not tssm.demand_forecaster_apply(p, u.detach()).requires_grad


def test_mirror_training_improves_on_persistence():
    """Mirror of ``tests/test_policy.py:273-302``: 200 steps beat the
    persistence init's MSE by 10 % on a seasonal and a trending series."""
    rng = np.random.default_rng(0)
    t = np.arange(1200)
    series = np.stack([
        50 * (1 + 0.5 * np.sin(2 * np.pi * t / 168)) + rng.normal(0, 2, t.size),
        30 * (1 + t / 1200) + rng.normal(0, 2, t.size),
    ]).clip(min=0.0)
    W = 100
    params, scale = tssm.train_demand_forecaster(series, W, steps=200, seed=0, device="cpu")
    u = torch.log1p(torch.tensor(series / scale[:, None], dtype=torch.float32))
    cs = np.concatenate([np.zeros((2, 1)), np.cumsum(series / scale[:, None], axis=1)], axis=1)
    T = series.shape[1]
    target = np.log1p((cs[:, W + 1:] - cs[:, 1:T - W + 1]) / W)
    valid = slice(0, T - W)

    def mse(p):
        y = tssm.demand_forecaster_apply(p, u).numpy().astype(np.float64)
        return float(np.mean((y[:, valid] - target) ** 2))

    init = tssm.demand_forecaster_init(None, device="cpu")
    assert mse(params) < mse(init) * 0.9


def test_mirror_forecast_port_demand_is_causal():
    """Mirror of ``tests/test_policy.py:305-320``: perturbing live demand
    after hour k leaves the predictions at hours <= k unchanged; without a
    history, hour 0 predicts the fit's mean."""
    rng = np.random.default_rng(3)
    hist = rng.uniform(10, 100, size=(3, 300))
    live = rng.uniform(10, 100, size=(3, 200))
    k = 120
    live2 = live.copy()
    live2[:, k:] *= 7.0
    a = tpol.forecast_port_demand(hist, live, 50, steps=10, seed=0, device="cpu")
    b = tpol.forecast_port_demand(hist, live2, 50, steps=10, seed=0, device="cpu")
    np.testing.assert_array_equal(a[:, :k + 1].numpy(), b[:, :k + 1].numpy())
    assert a.shape == live.shape and bool((a >= 0).all()) and a.dtype == torch.float64
    c = tpol.forecast_port_demand(None, live, 50, steps=5, device="cpu")
    want = jpol.forecast_port_demand(None, live, 50, steps=5, seed=0)
    np.testing.assert_allclose(c.numpy(), want, rtol=PRED_RTOL)
    np.testing.assert_array_equal(c[:, 0].numpy(), np.maximum(live[:, :100].mean(axis=1), 1e-9))


# -- the factories -------------------------------------------------------------------

def _ties(got, want, theta1, theta2, margin, p_vpn, p_cci, tol, label) -> int:
    """Hours where the two packages' decisions differ. Each row's first such
    hour must hold a gate within ``tol`` relative of its threshold (the
    port's predicted costs); later hours of that row then follow from a
    different state. Returns the rows that differ, printed."""
    gx, wx = np.asarray(got["x"]), np.asarray(want["x"])
    gs, ws = np.asarray(got["state"]), np.asarray(want["state"])
    bad = ((gx != wx) | (gs != ws))
    rows = np.nonzero(bad.any(axis=1))[0]
    for n in rows:
        t = int(np.nonzero(bad[n])[0][0])
        th = np.array([theta1[n] - margin[n], theta1[n] + margin[n], theta2[n] + margin[n],
                       theta2[n] - margin[n]])
        k = th * p_vpn[n, t]
        near = np.abs(p_cci[n, t] - k) <= tol * np.maximum(np.abs(p_cci[n, t]), np.abs(k))
        assert near.any(), f"{label}: row {n} hour {t} decides otherwise than JAX, no gate near"
    print(f"{label}: {len(rows)} rows decide otherwise than JAX, each at a gate within "
          f"{tol:.2e} of its threshold")
    return len(rows)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isfinite(a) & np.isfinite(b)
    return float((np.abs(a - b)[ok] / np.maximum(np.abs(b[ok]), 1e-300)).max())


N_LINKS, HOURS, HISTORY, STEPS = 8, 800, 400, 30


@functools.lru_cache(maxsize=None)
def _fleet_factory():
    jsc = jscen.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=2)
    tsc = tscen.build_fleet_scenario(N_LINKS, horizon=HOURS, history_hours=HISTORY, seed=2)
    assert np.array_equal(tsc.demand, jsc.demand) and np.array_equal(tsc.history, jsc.history)
    margin = tpol.family_margins([l.family for l in tsc.fleet.links])
    with enable_x64():
        jarr = jsc.fleet.stack(jnp.float64)
        jp = jpol.forecast_fleet_policy(jarr, jsc.demand, jsc.history, margin=margin,
                                        steps=STEPS)
        jplan = jeng.plan_fleet(jarr, jsc.demand, policy=jp, hours_per_month=730)
    tarr = tsc.fleet.stack(torch.float64, CPU)
    tp = tpol.forecast_fleet_policy(tarr, tsc.demand, tsc.history, margin=margin, steps=STEPS,
                                    device="cpu")
    return tsc, tarr, jp, jplan, tp


def test_forecast_fleet_policy_matches_jax():
    """Trained on the clipped history, predictions over the horizon within
    PRED_RTOL, cost coefficients within COEF_RTOL, per-family margins, and
    plan_fleet's decisions equal JAX's up to printed gate ties."""
    tsc, tarr, jp, jplan, tp = _fleet_factory()
    assert tp.pred_demand.shape == (N_LINKS, HOURS) and tp.pred_demand.dtype == torch.float64
    np.testing.assert_allclose(tp.pred_demand.numpy(), np.asarray(jp.pred_demand), rtol=PRED_RTOL)
    np.testing.assert_allclose(tp.cost_coef.numpy(), np.asarray(jp.cost_coef), rtol=COEF_RTOL,
                               atol=1e-12)
    np.testing.assert_array_equal(tp.margin.numpy(), np.asarray(jp.margin))
    got = plan_fleet(tarr, tsc.demand, policy=tp, device="cpu")
    s = plan_fleet(tarr, tsc.demand, device="cpu")
    p_vpn, p_cci = predicted_mode_costs(tp.pred_demand, tp.cost_coef, torch.float64)
    tol = 2 * _rel(tp.pred_demand.numpy(), np.asarray(jp.pred_demand))
    tg = tarr.toggle
    _ties(got, jplan, tg.theta1.numpy(), tg.theta2.numpy(), tp.margin.numpy(), p_vpn.numpy(),
          p_cci.numpy(), tol, "forecast_fleet_policy")
    assert (got["x"] != s["x"]).any()


def test_forecast_topology_policy_matches_jax():
    """Per-port: pair demand through the multi-hot membership matrix and the
    capacity clips, trained and predicted per port; predictions, cost
    coefficients and plan_topology's decisions against JAX's."""
    build = lambda m: m.build_topology_scenario(
        12, n_facilities=3, ports_per_facility=2, horizon=HOURS, history_hours=HISTORY,
        families=("bursty", "mirage"), seed=6)
    jsc, tsc = build(jscen), build(tscen)
    jr, tr = jtop.optimize_routing(jsc.topo, jsc.demand), ttop.optimize_routing(tsc.topo,
                                                                               tsc.demand)
    assert jr.paths == tr.paths
    with enable_x64():
        jarr = jsc.topo.stack(jr, jnp.float64)
        jp = jpol.forecast_topology_policy(jarr, jsc.demand, jsc.history, steps=STEPS)
        jplan = jeng.plan_topology(jarr, jsc.demand, policy=jp, hours_per_month=730)
    tarr = tsc.topo.stack(tr, torch.float64, CPU)
    tp = tpol.forecast_topology_policy(tarr, tsc.demand, tsc.history, steps=STEPS, device="cpu")
    assert tp.pred_demand.shape == (tarr.n_ports, HOURS)
    np.testing.assert_allclose(tp.pred_demand.numpy(), np.asarray(jp.pred_demand), rtol=PRED_RTOL)
    np.testing.assert_allclose(tp.cost_coef.numpy(), np.asarray(jp.cost_coef), rtol=COEF_RTOL,
                               atol=1e-12)
    got = plan_topology(tarr, tsc.demand, policy=tp, device="cpu")
    p_vpn, p_cci = predicted_mode_costs(tp.pred_demand, tp.cost_coef, torch.float64)
    tol = 2 * _rel(tp.pred_demand.numpy(), np.asarray(jp.pred_demand))
    tg = tarr.toggle
    _ties(got, jplan, tg.theta1.numpy(), tg.theta2.numpy(), tp.margin.numpy(), p_vpn.numpy(),
          p_cci.numpy(), tol, "forecast_topology_policy")


def test_streaming_forecaster_fit_matches_jax_and_from_history():
    """fit = training, then from_history with the trained parameters: h0
    and pred0 bit-equal to from_history's; scale equal to JAX's; parameters,
    h0 and pred0 within TRAIN_RTOL / PRED_RTOL of JAX's fit; a history of 1
    hour refused with the reference's text."""
    _, _, hist, _, _, _ = _live_fleet()
    fc = StreamingForecaster.fit(hist, 144, steps=STEPS, device="cpu")
    jfc = jrt.StreamingForecaster.fit(hist, 144, steps=STEPS)
    again = StreamingForecaster.from_history(fc.params, hist, device="cpu")
    assert torch.equal(fc.h0, again.h0) and torch.equal(fc.pred0, again.pred0)
    np.testing.assert_array_equal(fc.scale, np.asarray(jfc.scale))
    for k in jfc.params:
        np.testing.assert_allclose(fc.params[k].numpy(), np.asarray(jfc.params[k]),
                                   rtol=TRAIN_RTOL, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(fc.h0.numpy(), np.asarray(jfc.h0), rtol=TRAIN_RTOL, atol=1e-6)
    np.testing.assert_allclose(fc.pred0.numpy(), np.asarray(jfc.pred0), rtol=PRED_RTOL)
    with pytest.raises(AssertionError) as want:
        jrt.StreamingForecaster.fit(hist[:, :1], 144)
    with pytest.raises(ValueError) as got:
        StreamingForecaster.fit(hist[:, :1], 144, device="cpu")
    assert str(got.value) == str(want.value.args[0])


def test_streaming_forecast_policy_matches_jax_live():
    """The live-mode factory: cost coefficients fitted on the history's cost
    series (JAX's factory wraps them outside its ``enable_x64`` block, so
    with x64 off they come back rounded to float32: held at ``rtol=1e-7``;
    the port keeps float64), the forecaster trained on the history's
    clipped demand; streamed live (K = 24) beside JAX's live runtime with
    its own factory's policy and forecaster, stepped hour by hour:
    forecasts within PRED_RTOL,
    decisions equal up to printed gate ties (the tie tolerance twice the
    two packages' largest difference of a predicted mode cost)."""
    sc, arrays, _, _, _, margins = _live_fleet()
    jsc, jp, jfc, _, _ = _jax_fleet()
    pol, fc = streaming_forecast_policy(arrays, sc.history, margin=margins, steps=30,
                                        device="cpu")
    assert pol.pred_demand.shape == (arrays.n_links,) and not pol.pred_demand.any()
    assert pol.cost_coef.dtype == torch.float64
    np.testing.assert_allclose(pol.cost_coef.numpy(), np.asarray(jp.cost_coef), rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(fc.pred0.numpy(), np.asarray(jfc.pred0), rtol=PRED_RTOL)
    want, preds = _jax_stream(jrt.FleetRuntime(jsc.fleet, policy=jp, forecaster=jfc),
                              jsc.demand, 1)
    got = _stream(FleetRuntime(sc.fleet, policy=pol, forecaster=fc, device="cpu"), sc.demand, 24)
    jnext = np.stack([p for _, p in preds], axis=1)              # JAX's forecast after each hour
    np.testing.assert_allclose(got["pred_next"], jnext, rtol=PRED_RTOL)
    used = np.concatenate([fc.pred0.numpy()[:, None], got["pred_next"][:, :-1]], axis=1)
    jused = np.concatenate([np.asarray(jfc.pred0)[:, None], jnext[:, :-1]], axis=1)
    p_vpn, p_cci = predicted_mode_costs(torch.from_numpy(used), pol.cost_coef, torch.float64)
    j_vpn, j_cci = predicted_mode_costs(torch.from_numpy(jused),
                                        torch.from_numpy(np.asarray(jp.cost_coef, np.float64)),
                                        torch.float64)
    tol = 2 * max(_rel(p_vpn, j_vpn), _rel(p_cci, j_cci))
    tg = arrays.toggle
    _ties(got, want, tg.theta1.numpy(), tg.theta2.numpy(), pol.margin.numpy(), p_vpn.numpy(),
          p_cci.numpy(), tol, "streaming_forecast_policy")
