"""Port vs JAX package for the streaming runtime in fleet mode.

On the CPU the port's ``FleetRuntime`` runs the plain versions of its two
kernels (``tiered_cost_calendar``, ``fsm_chunk``). It is held against:

* the JAX ``FleetRuntime.run`` on the same scenarios: ``x``, ``state``,
  ``vpn_cost`` and ``r_vpn`` equal bit for bit; ``cci_cost``, ``r_cci`` and
  ``cost`` at ``rtol=1e-12`` (XLA contracts ``c·d + (L+V)`` into a fused
  multiply-add; one ulp was measured);
* the port's own CPU ``plan_fleet``: every field bit for bit (both sum
  sequentially in float64 and never fuse);
* itself: ``step_many`` over any chunking, with a per-tick ragged tail,
  equals per-tick ``step`` bit for bit, in the outputs and in the carried
  host prefixes.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (aliases enable_x64 before repro imports)

import jax
import jax.numpy as jnp

from repro.core.pricing import CostParams as JCostParams, TieredRate as JTieredRate
from repro.fleet import scenario as jscen
from repro.fleet.spec import fleet_from_params as jfleet_from_params
from repro.fleet.stream import FleetRuntime as JFleetRuntime

from repro_torch.core.pricing import CostParams, TieredRate
from repro_torch.core.togglecci import window_sums
from repro_torch.fleet import (
    FleetRuntime,
    RuntimeConfig,
    build_fleet_scenario,
    make_policy,
    plan_fleet,
)
from repro_torch.fleet import stream
from repro_torch.fleet.spec import fleet_from_params

FIELDS = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
SIZES = [(8, 600), (16, 2000)]
CASES = [
    (n, T, seed, kind, renew)
    for n, T in SIZES for seed in (0, 1, 2)
    for kind in ("reactive", "hysteresis") for renew in (False, True)
]
IDS = [f"{n}x{T}-s{seed}-{kind}-{'chunks' if renew else 'continuous'}"
       for n, T, seed, kind, renew in CASES]


@functools.lru_cache(maxsize=None)
def _scenario(n, T, seed):
    return build_fleet_scenario(n, horizon=T, seed=seed)


@functools.lru_cache(maxsize=None)
def _port_run(n, T, seed, kind, renew):
    sc = _scenario(n, T, seed)
    fleet = dataclasses.replace(sc.fleet, policy=kind)
    return FleetRuntime(fleet, renew_in_chunks=renew, device="cpu").run(sc.demand)


@pytest.mark.parametrize("n,T,seed,kind,renew", CASES, ids=IDS)
def test_runtime_matches_jax_runtime(n, T, seed, kind, renew):
    jsc = jscen.build_fleet_scenario(n, horizon=T, seed=seed)
    assert np.array_equal(jsc.demand, _scenario(n, T, seed).demand)
    want = JFleetRuntime(dataclasses.replace(jsc.fleet, policy=kind),
                         renew_in_chunks=renew).run(jsc.demand)
    got = _port_run(n, T, seed, kind, renew)
    assert 0 < want["x"].sum() < want["x"].size        # the links do toggle
    for k in ("x", "state", "vpn_cost", "r_vpn"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("cci_cost", "r_cci", "cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("n,T,seed,kind,renew", CASES, ids=IDS)
def test_runtime_matches_port_plan_fleet(n, T, seed, kind, renew):
    sc = _scenario(n, T, seed)
    plan = plan_fleet(dataclasses.replace(sc.fleet, policy=kind), sc.demand,
                      renew_in_chunks=renew, device="cpu")
    got = _port_run(n, T, seed, kind, renew)
    vpn, cci = plan["vpn_hourly"], plan["cci_hourly"]
    h = sc.fleet.stack(device="cpu").toggle.h
    want = {
        "x": plan["x"], "state": plan["state"], "vpn_cost": vpn, "cci_cost": cci,
        "r_vpn": window_sums(vpn, h), "r_cci": window_sums(cci, h),
        "cost": torch.where(plan["x"] == 1, cci, vpn),
    }
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k].numpy(), err_msg=k)


def _random_fleet(seed, n, h_max):
    """Hand-built links (both packages) with windows up to ``h_max`` hours,
    delays and commitments that make the FSMs move within a few hundred
    hours."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        bounds = tuple(np.sort(rng.uniform(50, 5000, size=k))[:-1]) + (np.inf,)
        rates = tuple(np.sort(rng.uniform(0.02, 0.2, size=k))[::-1])
        specs.append(dict(
            L_cci=float(rng.uniform(0.5, 8.0)), V_cci=float(rng.uniform(0.05, 0.5)),
            c_cci=float(rng.uniform(0.005, 0.05)), L_vpn=float(rng.uniform(0.05, 0.5)),
            D=int(rng.integers(0, 30)), T_cci=int(rng.integers(1, 60)),
            h=int(rng.integers(1, h_max + 1)),
            theta1=float(rng.uniform(0.8, 1.0)), theta2=float(rng.uniform(1.0, 1.25)),
            tier=(bounds, rates),
        ))
    port = fleet_from_params([
        CostParams(vpn_tier=TieredRate(*s["tier"]),
                   **{k: v for k, v in s.items() if k != "tier"}) for s in specs])
    ref = jfleet_from_params([
        JCostParams(vpn_tier=JTieredRate(*s["tier"]),
                    **{k: v for k, v in s.items() if k != "tier"}) for s in specs])
    return port, ref


def _random_demand(seed, n, T):
    """Regime-switching rows so the FSMs actually transition."""
    rng = np.random.default_rng(seed + 500)
    levels = rng.uniform(0, 400, size=(n, T // 30 + 1))
    d = np.repeat(levels, 30, axis=1)[:, :T]
    return d * rng.uniform(0.8, 1.2, size=(n, T))


def _stream(rt, demand, K):
    """Chunks of K, then a per-tick ragged tail."""
    T = demand.shape[1]
    outs, t = [], 0
    while t + K <= T:
        outs.append(rt.step_many(demand[:, t:t + K]))
        t += K
    while t < T:
        o = rt.step(demand[:, t])
        outs.append({f: o[f][:, None] for f in FIELDS})
        t += 1
    return {f: np.concatenate([o[f] for o in outs], axis=1) for f in FIELDS}


@pytest.mark.parametrize("K", [1, 7, 24])
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
@pytest.mark.parametrize("h_max", [5, 60], ids=["short-windows", "long-windows"])
def test_step_many_chunking_bit_exact(K, kind, h_max):
    """Chunked equals per-tick, fields and carried prefixes, for K below and
    above the ring size (short windows make K = 24 > hbuf), across month
    boundaries (hours_per_month 48) and with a ragged tail."""
    fleet, _ = _random_fleet(3, 6, h_max)
    demand = _random_demand(3, 6, 221)
    arrays = fleet.stack(device="cpu")
    policy = make_policy(kind, arrays.toggle)

    def runtime():
        return FleetRuntime(arrays, policy=policy, hours_per_month=48, device="cpu")

    rt = runtime()
    ref = [rt.step(demand[:, t]) for t in range(demand.shape[1])]
    want = {f: np.stack([o[f] for o in ref], axis=1) for f in FIELDS}
    assert 0 < want["x"].sum() < want["x"].size
    rt2 = runtime()
    got = _stream(rt2, demand, K)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"K={K} {f}")
    for name in ("dcum", "dcum_month", "vpn_pref", "cci_pref", "ring_vpn", "ring_cci"):
        np.testing.assert_array_equal(getattr(rt2._state, name), getattr(rt._state, name),
                                      err_msg=name)
    assert torch.equal(rt2._state.fsm, rt._state.fsm)
    assert rt2.t == rt.t == demand.shape[1]
    plan = plan_fleet(arrays, demand, policy=policy, hours_per_month=48, device="cpu")
    np.testing.assert_array_equal(got["x"], plan["x"].numpy())
    np.testing.assert_array_equal(got["vpn_cost"], plan["vpn_hourly"].numpy())


def test_month_boundary_streaming():
    """Short billing months force several tier resets inside the stream; the
    streamed tier state matches the offline monthly_cumsum exactly, and the
    JAX runtime's decisions and VPN costs. Pre-stacked arrays: with a spec
    the spec's calendar (730 h) wins over the keyword."""
    fleet, jfleet = _random_fleet(7, 3, 60)
    demand = _random_demand(7, 3, 260)
    arrays = fleet.stack(device="cpu")
    rt = FleetRuntime(arrays, hours_per_month=48, device="cpu")
    assert rt.hours_per_month == 48
    out = rt.run(demand)
    plan = plan_fleet(arrays, demand, hours_per_month=48, device="cpu")
    np.testing.assert_array_equal(out["x"], plan["x"].numpy())
    np.testing.assert_array_equal(out["vpn_cost"], plan["vpn_hourly"].numpy())
    np.testing.assert_array_equal(out["cci_cost"], plan["cci_hourly"].numpy())
    with jax.enable_x64():
        jarrays = jfleet.stack(jnp.float64)
    want = JFleetRuntime(jarrays, hours_per_month=48).run(demand)
    np.testing.assert_array_equal(out["x"], want["x"])
    np.testing.assert_array_equal(out["vpn_cost"], want["vpn_cost"])
    # The boundary really is exercised: tier positions reset at 48/96/...
    assert np.any(np.diff(out["vpn_cost"][:, 47:49], axis=1) != 0)


def test_endogenous_cci_demand_matches_jax():
    """``cci_demand_t`` prices the CCI counterfactual on its own volume."""
    jsc = jscen.build_fleet_scenario(8, horizon=300, seed=4)
    sc = _scenario(8, 300, 4)
    cci_d = sc.demand * 1.5
    jrt, rt = JFleetRuntime(jsc.fleet), FleetRuntime(sc.fleet, device="cpu")
    for t in range(sc.demand.shape[1]):
        want = jrt.step(jsc.demand[:, t], cci_demand_t=cci_d[:, t])
        got = rt.step(sc.demand[:, t], cci_demand_t=cci_d[:, t])
        for k in ("x", "state", "vpn_cost", "r_vpn"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} at {t}")
        np.testing.assert_allclose(got["cci_cost"], want["cci_cost"], rtol=1e-12, atol=0)
    rt2 = FleetRuntime(sc.fleet, device="cpu")
    chunk = rt2.step_many(sc.demand[:, :24], cci_demand_block=cci_d[:, :24])
    rt.reset()
    ticks = [rt.step(sc.demand[:, t], cci_demand_t=cci_d[:, t]) for t in range(24)]
    for k in FIELDS:
        np.testing.assert_array_equal(chunk[k], np.stack([o[k] for o in ticks], 1))


def test_reset_and_from_config_replay_the_stream():
    sc = _scenario(8, 600, 0)
    rt = FleetRuntime(sc.fleet, device="cpu")
    a = rt.step_many(sc.demand[:, :100])
    assert rt.t == 100
    rt.reset()
    assert rt.t == 0
    b = rt.step_many(sc.demand[:, :100])
    c = FleetRuntime.from_config(sc.fleet, RuntimeConfig(), device="cpu").run(
        sc.demand[:, :100])
    for k in FIELDS:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])


def test_modes_maps_states_to_collective_modes():
    sc = _scenario(8, 600, 1)
    rt = FleetRuntime(sc.fleet, device="cpu")
    out = rt.step_many(sc.demand[:, :400])
    last = {k: v[:, -1] for k, v in out.items()}
    modes = rt.modes(last)
    assert modes == ["hierarchical" if s == 2 else "compressed" for s in last["state"]]
    assert {"hierarchical", "compressed"} <= set(
        m for t in range(400) for m in rt.modes({"state": out["state"][:, t]}))
    assert rt.modes(last, mode_fn=lambda s: f"s{s}") == [f"s{s}" for s in last["state"]]


def test_out_of_scope_paths_raise_not_implemented():
    """The slices not ported yet raise naming their ROADMAP item (the LM
    substrate past GQA with dense or MoE FFNs, item 11); the gateway (item 9)
    builds and ticks on the CPU; observability (item 8) is ported: ``obs=True`` attaches
    an observer to the runtime and the elastic planner, and an ``obs`` with
    no drain cadence is the reference's TypeError; training the streaming
    forecaster (item 6c) runs: ``fit`` refuses a history of fewer than 2 hours with the
    reference's text and trains on one of 2, and ``streaming_forecast_policy``
    returns a live policy and forecaster; the topology-mode inputs that used
    to raise now behave as the JAX resolver does: a routing beside a
    FleetSpec is not read (fleet mode), a non-spec is a TypeError and a
    fleet-mode reroute is refused; a forecaster that is not a
    StreamingForecaster is the reference's TypeError (live mode is ported).
    A spec of the ``"forecast"`` kind with no policy object goes through
    ``make_policy``, which raises JAX's ValueError (the policy is built from
    predictions)."""
    sc = _scenario(8, 600, 0)
    assert FleetRuntime(sc.fleet, device="cpu", obs=True).obs.cadence == 64
    with pytest.raises(TypeError, match="obs must be None, a bool, or an ObsConfig-like"):
        FleetRuntime(sc.fleet, device="cpu", obs=object())
    with pytest.raises(TypeError, match="forecaster must be a StreamingForecaster, got object"):
        FleetRuntime(sc.fleet, device="cpu", forecaster=object())
    routed = FleetRuntime(sc.fleet, device="cpu", routing=[0] * 8)
    assert not routed.topology and routed.n_demand_rows == routed.n_rows == 8
    np.testing.assert_array_equal(routed.step_many(sc.demand[:, :48])["x"],
                                  _port_run(8, 600, 0, "reactive", False)["x"][:, :48])
    with pytest.raises(ValueError, match="forecast_gated_policy"):
        FleetRuntime(dataclasses.replace(sc.fleet, policy="forecast"), device="cpu")
    with pytest.raises(TypeError, match="FleetSpec"):
        FleetRuntime(object(), device="cpu")
    with pytest.raises(ValueError, match="topology"):
        FleetRuntime(sc.fleet, device="cpu").reroute([0] * 8)
    with pytest.raises(ValueError, match="needs a \\(rows, H>=2\\) history block"):
        stream.StreamingForecaster.fit(sc.demand[:, :1], 24, device="cpu")
    fc = stream.StreamingForecaster.fit(sc.demand[:, :2], 24, steps=2, device="cpu")
    assert fc.h0.shape == (8, 8) and bool(torch.isfinite(fc.pred0).all())
    pol, lfc = stream.streaming_forecast_policy(sc.fleet.stack(torch.float64, "cpu"),
                                                sc.demand[:, :100], steps=2, device="cpu")
    assert pol.kind == "forecast" and lfc.h0.shape == (8, 8)
    pl = stream.ElasticFleetPlanner(sc.fleet, device="cpu", routing=[0] * 8)
    assert not pl.topology
    np.testing.assert_array_equal(pl.sync_groups(), np.arange(8))
    assert stream.ElasticFleetPlanner(sc.fleet, device="cpu", obs=True).runtime.obs is not None
    from repro_torch.configs import get_config
    from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec
    from repro_torch.models.lm import check_supported

    gw = FleetGateway(GatewayConfig(slots_per_bucket=2), device="cpu")   # item 9 is ported
    assert gw.join("t", TenantSpec(spec=sc.fleet, demand=sc.demand)).status == "active"
    assert gw.tick()["t"]["x"].shape == (8,) and gw.n_buckets == 1
    check_supported(get_config("mixtral-8x7b"))                       # item 11a is ported
    with pytest.raises(NotImplementedError, match="item 11"):       # the next unported path
        check_supported(get_config("jamba-v0.1-52b"))


def test_runtime_raises_without_cuda(monkeypatch):
    sc = _scenario(8, 600, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FleetRuntime(sc.fleet)


def test_step_checks_its_input():
    sc = _scenario(8, 600, 0)
    rt = FleetRuntime(sc.fleet, device="cpu")
    with pytest.raises(ValueError, match="demand_t"):
        rt.step(sc.demand[:4, 0])
    with pytest.raises(ValueError, match="demand_block"):
        rt.step_many(sc.demand[:, :0])
    assert rt.t == 0
