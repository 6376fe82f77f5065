"""Port vs JAX package: cost model, window sums and the ToggleCCI entry points.

The same seeded numpy inputs go through the JAX function and its PyTorch
counterpart on the CPU. Tolerances: tiered pricing and window sums keep the
JAX package's order of operations and are held bit for bit; XLA:CPU's
float64 cumsum is not a sequential sum, so ``monthly_cumsum`` is held to
``rtol=1e-12, atol=1e-9``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import CPU, seeded_costs, seeded_tiers

import jax
import jax.numpy as jnp

from repro.core import costmodel as jcm
from repro.core import togglecci as jtc
from repro.core.pricing import make_scenario as jax_make_scenario

from repro_torch.core import costmodel as tcm
from repro_torch.core import togglecci as ttc
from repro_torch.core.pricing import make_scenario


def _t(a):
    return torch.as_tensor(a, device=CPU)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_tiered_tables_bit_equal_to_jax(jit):
    cum, d, b, r = seeded_tiers(0, 8, 300)
    fn = jax.jit(jcm.tiered_marginal_cost_tables) if jit else jcm.tiered_marginal_cost_tables
    with jax.enable_x64():
        want = np.asarray(fn(*(jnp.asarray(a) for a in (cum, d, b, r))))
    got = tcm.tiered_marginal_cost_tables(_t(cum), _t(d), _t(b), _t(r)).numpy()
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("hpm", [730, 100])
def test_monthly_cumsum_matches_jax(hpm):
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 500.0, size=(6, 2000))
    with jax.enable_x64():
        want = np.asarray(jcm.monthly_cumsum(jnp.asarray(d), hpm))
    got = tcm.monthly_cumsum(_t(d), hpm).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    # On the CPU torch.cumsum is sequential: equal to numpy's month prefix.
    full = np.concatenate([np.zeros((6, 1)), np.cumsum(d, axis=1)], axis=1)
    month_start = (np.arange(2000) // hpm) * hpm
    assert np.array_equal(got, full[:, :-1] - full[:, month_start])


@pytest.mark.parametrize("h", [1, 24, 168, 5000])
def test_window_sums_bit_equal_to_jax_numpy_path(h):
    vpn, _ = seeded_costs(2, 3, 1500)
    with jax.enable_x64():
        want = np.stack([np.asarray(jtc.window_sums(row, h)) for row in vpn])
    got = ttc.window_sums(_t(vpn), h).numpy()
    assert np.array_equal(got, want)
    per_row = ttc.window_sums(_t(vpn), torch.tensor([h, h, h], dtype=torch.int32)).numpy()
    assert np.array_equal(per_row, want)


def test_hourly_cost_series_copy_matches_jax():
    p, jp = make_scenario("aws", "gcp"), jax_make_scenario("aws", "gcp")
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    d = np.random.default_rng(3).uniform(0.0, 300.0, size=(1500, 2))
    a, b = tcm.hourly_cost_series(p, d), jcm.hourly_cost_series(jp, d)
    assert np.array_equal(a.vpn, b.vpn) and np.array_equal(a.cci, b.cci)


@pytest.mark.parametrize("renew", [False, True])
def test_run_togglecci_scan_matches_reference(renew):
    """The batched torch entry point (CPU plain path) against the JAX
    package's numpy reference and its lax.scan entry point."""
    jp = jax_make_scenario("gcp", "aws", D=24, T_cci=48, h=72)
    p = make_scenario("gcp", "aws", D=24, T_cci=48, h=72)
    vpn, cci = seeded_costs(4, 2, 1200)
    out = ttc.run_togglecci_scan(p, _t(vpn), _t(cci), renew_in_chunks=renew)
    zeros = np.zeros(1200)
    with jax.enable_x64():
        for i in range(2):
            costs = jcm.HourlyCosts(zeros, vpn[i], zeros, cci[i])
            ref = jtc.run_togglecci(jp, None, costs=costs, renew_in_chunks=renew)
            scan = jtc.run_togglecci_scan(jp, jnp.asarray(vpn[i]), jnp.asarray(cci[i]),
                                          renew_in_chunks=renew)
            np.testing.assert_array_equal(out["x"][i].numpy(), ref.x)
            np.testing.assert_array_equal(out["state"][i].numpy(), ref.state)
            np.testing.assert_array_equal(out["x"][i].numpy(), np.asarray(scan["x"]))
            np.testing.assert_allclose(out["total_cost"][i].item(), ref.total_cost,
                                       rtol=1e-12)
