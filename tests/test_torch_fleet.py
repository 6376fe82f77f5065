"""Port vs JAX package for the fleet planning slice end to end.

One fleet is built and stacked by the JAX package, carried across with
``fleet_arrays_from_numpy`` and planned by both packages on the CPU.
Decisions (``x``, ``state``) must be equal element for element; costs agree
within ``rtol=1e-9`` (the tolerance of ``tests/test_fleet.py``), hourly
series within ``rtol=1e-9, atol=1e-9``: XLA's float64 cumsum and fused
adds are not the sequential, unfused arithmetic of PyTorch on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import CPU, jax_fleet_dict

import jax
import jax.numpy as jnp

from repro.fleet import engine as jeng
from repro.fleet import scenario as jscen

from repro_torch.fleet import engine as teng
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet.spec import fleet_arrays_from_numpy


@functools.lru_cache(maxsize=None)
def _scenarios(n, seed):
    return (jscen.build_fleet_scenario(n, horizon=2000, seed=seed),
            tscen.build_fleet_scenario(n, horizon=2000, seed=seed))


def _carried(jsc, kind):
    with jax.enable_x64():
        d = jax_fleet_dict(jsc.fleet.stack(jnp.float64))
    return dataclasses.replace(jsc.fleet, policy=kind), fleet_arrays_from_numpy(d, CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scenario_parity(seed):
    jsc, tsc = _scenarios(16, seed)
    assert np.array_equal(tsc.demand, jsc.demand)
    assert tsc.summary() == jsc.summary() == {f: 4 for f in tscen.FAMILIES}
    for a, b in zip(tsc.fleet.links, jsc.fleet.links):
        assert (a.name, a.family, a.capacity_gb_hr) == (b.name, b.family, b.capacity_gb_hr)
        assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)


def test_fleet_arrays_round_trip():
    jsc, tsc = _scenarios(8, 0)
    _, arrays = _carried(jsc, "reactive")
    own = tsc.fleet.stack(torch.float64, CPU)
    for name, a, b in zip(arrays._fields, arrays, own):
        for x, y in (zip(a, b) if name == "toggle" else [(a, b)]):
            assert x.dtype == y.dtype and torch.equal(x, y), name
    with jax.enable_x64():
        d = jax_fleet_dict(jsc.fleet.stack(jnp.float64))
    back = {k: v.numpy() for k, v in arrays._asdict().items() if k != "toggle"}
    back.update({k: v.numpy() for k, v in arrays.toggle._asdict().items()})
    assert d.keys() == back.keys()
    assert all(np.array_equal(d[k], back[k]) and d[k].dtype == back[k].dtype for k in d)


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [8, 16])
def test_plan_fleet_matches_jax(n, seed, kind, renew):
    jsc, _ = _scenarios(n, seed)
    fleet, arrays = _carried(jsc, kind)
    want = jeng.plan_fleet(fleet, jsc.demand, renew_in_chunks=renew)
    got = teng.plan_fleet(
        arrays, jsc.demand, policy=teng.make_policy(kind, arrays.toggle,
                                                    renew_in_chunks=renew),
        hours_per_month=fleet.hours_per_month, device="cpu",
    )
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_array_equal(got["state"].numpy(), np.asarray(want["state"]))
    for k in ("toggle_cost", "static_vpn", "static_cci"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9, err_msg=k)
    for k in ("vpn_hourly", "cci_hourly"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_array_equal(got["demand"].numpy(), np.asarray(want["demand"]))
    if kind == "reactive":
        ref = jeng.plan_fleet_reference(jsc.fleet, jsc.demand, renew_in_chunks=renew)
        np.testing.assert_array_equal(got["x"].numpy(), ref["x"])
        np.testing.assert_array_equal(got["state"].numpy(), ref["state"])
        np.testing.assert_allclose(got["toggle_cost"].numpy(), ref["toggle_cost"],
                                   rtol=1e-9)


def test_port_scenario_plans_like_its_own_reference():
    """The port end to end on its own scenario: spec in, decisions equal to
    the port's per-link numpy reference."""
    _, tsc = _scenarios(16, 1)
    for renew in (False, True):
        got = teng.plan_fleet(tsc.fleet, tsc.demand, renew_in_chunks=renew, device="cpu")
        ref = teng.plan_fleet_reference(tsc.fleet, tsc.demand, renew_in_chunks=renew)
        np.testing.assert_array_equal(got["x"].numpy(), ref["x"])
        np.testing.assert_array_equal(got["state"].numpy(), ref["state"])
        np.testing.assert_allclose(got["toggle_cost"].numpy(), ref["toggle_cost"], rtol=1e-9)


def test_use_pallas_path_matches_jax():
    """float32 tier pricing, as the JAX package's use_pallas=True selects."""
    jsc, _ = _scenarios(8, 0)
    fleet, arrays = _carried(jsc, "reactive")
    want = jeng.plan_fleet(fleet, jsc.demand, use_pallas=True)
    got = teng.plan_fleet(arrays, jsc.demand, use_pallas=True, device="cpu")
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    np.testing.assert_allclose(got["toggle_cost"].numpy(), np.asarray(want["toggle_cost"]),
                               rtol=1e-3)


def test_forecast_policy_is_not_ported():
    _, tsc = _scenarios(8, 0)
    with pytest.raises(ValueError, match="forecast"):
        teng.plan_fleet(dataclasses.replace(tsc.fleet, policy="forecast"),
                        tsc.demand, device="cpu")


def test_static_cci_pays_provisioning_delay():
    """A hand-built one-link fleet (``fleet_from_params``): ALWAYS-CCI rides
    VPN for the first D hours, in both packages."""
    from repro.core.pricing import CostParams as JCostParams, flat_rate as jflat
    from repro.fleet.spec import fleet_from_params as jfleet

    from repro_torch.core.pricing import CostParams, flat_rate
    from repro_torch.fleet.spec import fleet_from_params

    kw = dict(D=10, T_cci=5, h=6)
    d = np.full((1, 200), 100.0)
    got = teng.plan_fleet(fleet_from_params([CostParams(1.0, 0.1, 0.02, 0.5, flat_rate(0.5), **kw)]),
                          d, device="cpu")
    want = jeng.plan_fleet(jfleet([JCostParams(1.0, 0.1, 0.02, 0.5, jflat(0.5), **kw)]), d)
    vpn, cci = got["vpn_hourly"][0], got["cci_hourly"][0]
    assert got["static_cci"][0].item() == pytest.approx(
        (vpn[:10].sum() + cci[10:].sum()).item(), rel=1e-12)
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("static_cci", "static_vpn", "toggle_cost"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9)
