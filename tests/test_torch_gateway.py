"""Port vs JAX package for the multi-tenant gateway.

On the CPU (``device="cpu"``) the port's ``FleetGateway`` steps each bucket
with the plain versions of the pooled chunk kernels (per-row clocks). One
counterpart for each test of ``tests/test_gateway.py``, each holding the
port's gateway:

* against each tenant's own standalone port ``FleetRuntime`` (same device,
  same demand, same config): every step field bit for bit, whatever the
  neighbours do (join, leave, reroute, resize), and ``tick_many(K)`` against
  K ``tick()`` calls bit for bit, billing totals included;
* against JAX's ``FleetGateway`` on the same tenants (both packages build
  the scenarios from one seed and route them with their own
  ``optimize_routing``): ``x`` and ``state`` equal, costs and billing at
  ``rtol=1e-12`` (the runtime's tolerance: XLA contracts the CCI plane's
  ``c·d + lease`` into a fused multiply-add), drained window counts equal and
  their sums at ``rtol=1e-9``, and the same SLO violations by monitor and
  tenant.

The drained windows are also held against each tenant's standalone runtime
with observability on: counts equal, sums at ``rtol=1e-12`` (the pooled ring
sums each slot over its padded rows, the standalone over its real rows).
"""
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import test_torch_support  # noqa: F401  (aliases enable_x64 before repro imports)

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.dist.collectives import sync_domain_label as jsync_domain_label
from repro.fleet import policy as jpol
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.runtime import RuntimeConfig as JRuntimeConfig
from repro.gateway import FleetGateway as JFleetGateway
from repro.gateway import GatewayConfig as JGatewayConfig
from repro.gateway import TenantSLO as JTenantSLO
from repro.gateway import TenantSpec as JTenantSpec

from repro_torch.dist import collectives as coll
from repro_torch.fleet import (
    FleetRuntime,
    RuntimeConfig,
    build_fleet_scenario,
    build_topology_scenario,
    fit_cost_coef,
    forecast_gated_policy,
    hysteresis_policy,
    optimize_routing,
    resolve_runtime_operands,
)
from repro_torch.gateway import (
    AdmissionError,
    FleetGateway,
    GatewayConfig,
    TenantSLO,
    TenantSpec,
    bucket_key_for,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs import ObsConfig

STEP_FIELDS = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
EXACT = ("x", "state")
CLOSE = ("r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
COUNTS = ("ticks", "requests", "activations", "releases", "lease_on", "cost_hist")
SUMS = ("cci_gb", "realized_cost", "vpn_cost", "cci_cost", "billed_gb", "forecast_abs_err",
        "pred_total", "demand_total", "tier_gb")
CPU = "cpu"


def _assert_step_equal(got, want, ctx):
    for f in STEP_FIELDS:
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]),
                                      err_msg=f"{ctx}:{f}")


def _assert_step_close(got, want, ctx):
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(got[f]), np.asarray(want[f]),
                                      err_msg=f"{ctx}:{f}")
    for f in CLOSE:
        np.testing.assert_allclose(np.asarray(got[f]), np.asarray(want[f]), rtol=1e-12,
                                   atol=0, err_msg=f"{ctx}:{f}")


def _assert_windows(got, want, rtol, ctx):
    """Drained windows: the same hours and counts, sums at ``rtol``."""
    assert [d.hour for d in got] == [d.hour for d in want], ctx
    for g, w in zip(got, want):
        for f in COUNTS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                                          err_msg=f"{ctx}@{g.hour}:{f}")
        for f in SUMS:
            np.testing.assert_allclose(np.asarray(getattr(g, f)), np.asarray(getattr(w, f)),
                                       rtol=rtol, atol=1e-9, err_msg=f"{ctx}@{g.hour}:{f}")


def _assert_billing(gw, jgw, names):
    for name in names:
        got, want = gw.billing(name), jgw.billing(name)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=name)


def _violations(vs):
    return sorted((v.monitor, v.details.get("tenant"), v.details.get("metric"),
                   "rate" in v.details) for v in vs)


class Tenant:
    """One tenant in both packages: the port's and JAX's ``TenantSpec`` and
    scenarios, and a factory of the port's standalone runtime."""

    def __init__(self, spec, jspec, sc, jsc):
        self.spec, self.jspec, self.sc, self.jsc = spec, jspec, sc, jsc

    def runtime(self, obs=None):
        c = self.spec.config
        return FleetRuntime(self.spec.spec, routing=c.routing, policy=c.policy, obs=obs,
                            device=CPU)


def _fleet_tenant(n, T, seed, *, horizon=None, slo=None, jslo=None):
    sc = build_fleet_scenario(n, horizon=T, seed=seed)
    jsc = jscen.build_fleet_scenario(n, horizon=T, seed=seed)
    assert np.array_equal(sc.demand, jsc.demand)
    return Tenant(TenantSpec(spec=sc.fleet, demand=sc.demand, horizon=horizon, slo=slo),
                  JTenantSpec(spec=jsc.fleet, demand=jsc.demand, horizon=horizon, slo=jslo),
                  sc, jsc)


def _topology_tenant(n_pairs, T, seed, kind, rng):
    """A topology tenant of ``kind`` in both packages; the policy's integer
    holds, predictions and cost coefficients are drawn once (numpy) and
    given to both (``tests/test_gateway.py:48-78``'s construction)."""
    kw = dict(n_facilities=2, ports_per_facility=2, horizon=T, seed=seed)
    sc, jsc = build_topology_scenario(n_pairs, **kw), jscen.build_topology_scenario(n_pairs, **kw)
    assert np.array_equal(sc.demand, jsc.demand)
    routing, jrouting = optimize_routing(sc.topo, sc.demand), jtop.optimize_routing(
        jsc.topo, jsc.demand)
    assert routing.paths == jrouting.paths
    policy = jpolicy = None
    if kind != "reactive":
        tp = sc.topo.stack(routing, torch.float64, CPU).toggle
        with enable_x64():
            jtp = jsc.topo.stack(jrouting, jnp.float64).toggle
            if kind == "hysteresis":
                up, down = int(rng.integers(1, 6)), int(rng.integers(1, 6))
                policy = hysteresis_policy(tp, up_hold=up, down_hold=down)
                jpolicy = jpol.hysteresis_policy(jtp, up_hold=up, down_hold=down)
            else:
                base = FleetRuntime(sc.topo, routing=routing, device=CPU).run(sc.demand)
                pred = np.maximum(rng.uniform(0.3, 1.2) * base["vpn_cost"], 0.0)
                t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
                coef = fit_cost_coef(t(pred), t(base["vpn_cost"]), t(base["cci_cost"])).numpy()
                policy = forecast_gated_policy(tp, pred, margin=0.05, cost_coef=coef)
                jpolicy = jpol.forecast_gated_policy(jtp, jnp.asarray(pred), margin=0.05,
                                                     cost_coef=jnp.asarray(coef))
    cfg = RuntimeConfig(routing=routing, policy=policy)
    jcfg = JRuntimeConfig(routing=jrouting, policy=jpolicy)
    return Tenant(TenantSpec(spec=sc.topo, demand=sc.demand, config=cfg),
                  JTenantSpec(spec=jsc.topo, demand=jsc.demand, config=jcfg), sc, jsc)


def _alt_routing(topo, jtopo, r0, rng):
    idx = np.asarray(r0.primary).copy()
    moved = 0
    for i, pr in enumerate(topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others and rng.random() < 0.8:
            idx[i] = int(rng.choice(others))
            moved += 1
    return topo.plan(idx), jtopo.plan(idx), moved


def _gateways(cfg):
    """The port's gateway on the CPU and JAX's, of one configuration."""
    return FleetGateway(GatewayConfig(**cfg), device=CPU), JFleetGateway(JGatewayConfig(**cfg))


def _counted(step):
    """``step()`` and the number of chunk calls it made (the pooled kernels
    on a card, their plain versions here), each with per-row clocks."""
    with mock.patch.object(ops, "stream_chunk", wraps=ops.stream_chunk) as a, \
            mock.patch.object(ops, "stream_chunk_routed", wraps=ops.stream_chunk_routed) as b:
        out = step()
    calls = a.call_args_list + b.call_args_list
    assert all(torch.is_tensor(c.kwargs["clocks"][1]) for c in calls)   # a clock per row
    return out, len(calls)


def _join(gw, jgw, name, tenant):
    h, jh = gw.join(name, tenant.spec), jgw.join(name, tenant.jspec)
    assert h.status == jh.status
    return h


# ---------------------------------------------------------------------------
# The tentpole property: pooled == standalone, bit for bit; JAX by tolerance
# ---------------------------------------------------------------------------


@given(seed=st.integers(0, 10_000))
@settings(max_examples=4, deadline=None)
def test_gateway_matches_standalone_and_jax(seed):
    """Heterogeneous tenants across the three policies, sharing pools: every
    tick of every tenant equals its standalone port runtime bit for bit, and
    JAX's gateway by the tolerances, including one tenant re-routing
    mid-stream and one leaving mid-stream."""
    rng = np.random.default_rng(seed)
    T = int(rng.integers(60, 120))
    gw, jgw = _gateways(dict(slots_per_bucket=4, cadence=16))
    tenants = {}
    for i, kind in enumerate(("reactive", "hysteresis", "forecast")):
        tenants[f"t{i}-{kind}"] = _topology_tenant(int(rng.integers(3, 7)), T, seed + i, kind,
                                                  rng)
    tenants["fleet"] = _fleet_tenant(int(rng.integers(2, 5)), T, seed)
    refs = {}
    for name, ten in tenants.items():
        _join(gw, jgw, name, ten)
        refs[name] = ten.runtime()
    rname = "t0-reactive"
    rt = tenants[rname]
    r1, jr1, moved = _alt_routing(rt.sc.topo, rt.jsc.topo, rt.spec.config.routing, rng)
    s_reroute = int(rng.integers(T // 4, T // 2))
    leaver, s_leave = "t1-hysteresis", int(rng.integers(T // 2, T - 10))
    compiles_after_first_tick = None
    n_live = n_calls = 0
    for t in range(T):
        if t == s_reroute and moved:
            gw.reroute(rname, r1)
            jgw.reroute(rname, jr1)
            refs[rname].reroute(r1)
        if t == s_leave:
            gw.leave(leaver)
            jgw.leave(leaver)
        n_live += len(gw._live_buckets())
        (outs, n), jouts = _counted(gw.tick), jgw.tick()
        n_calls += n
        if compiles_after_first_tick is None:
            compiles_after_first_tick = gw.compiles
        for name, ten in tenants.items():
            if name == leaver and t >= s_leave:
                assert name not in outs
                continue
            _assert_step_equal(outs[name], refs[name].step(ten.sc.demand[:, t]), f"{name}@{t}")
            _assert_step_close(outs[name], jouts[name], f"jax:{name}@{t}")
    # One pooled chunk call a non-empty bucket a tick.
    assert n_calls == n_live
    # Churn (the departure) and the reroute prepared nothing new.
    assert gw.compiles == compiles_after_first_tick
    assert gw.check() == [] and jgw.check() == []
    _assert_billing(gw, jgw, tenants)
    for name in tenants:
        _assert_windows(gw.metrics(name), jgw.metrics(name), 1e-9, f"jax:{name}")


@given(seed=st.integers(0, 10_000))
@settings(max_examples=3, deadline=None)
def test_tick_many_matches_per_tick(seed):
    """``tick_many(K)`` equals K ``tick()`` calls bit for bit for every
    pooled tenant (stacked (rows, K) outputs, float64 billing totals, drained
    windows), with a reroute at a chunk boundary and a per-tick ragged tail;
    the per-tick port gateway equals JAX's by the tolerances."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(2, 9))
    n_chunks = max(5, -(-28 // K))  # scenario builders need horizon >= 24
    tail = int(rng.integers(1, 4))
    T = K * n_chunks + tail
    tenants = {f"t{i}-{kind}": _topology_tenant(int(rng.integers(3, 7)), T, seed + i, kind, rng)
               for i, kind in enumerate(("reactive", "hysteresis", "forecast"))}
    tenants["fleet"] = _fleet_tenant(3, T, seed)
    gw_a, jgw = _gateways(dict(slots_per_bucket=4, cadence=2 * K))
    gw_b = FleetGateway(GatewayConfig(slots_per_bucket=4, cadence=2 * K), device=CPU)
    for name, ten in tenants.items():
        _join(gw_a, jgw, name, ten)
        gw_b.join(name, ten.spec)
    rname = "t0-reactive"
    rt = tenants[rname]
    r1, jr1, moved = _alt_routing(rt.sc.topo, rt.jsc.topo, rt.spec.config.routing, rng)
    s = 2 * K  # a chunk boundary on the chunked side
    per_tick = {name: [] for name in tenants}
    for t in range(T):
        if t == s and moved:
            gw_a.reroute(rname, r1)
            jgw.reroute(rname, jr1)
        outs, jouts = gw_a.tick(), jgw.tick()
        for name in tenants:
            per_tick[name].append(outs[name])
            _assert_step_close(outs[name], jouts[name], f"jax:{name}@{t}")
    t = 0
    for _ in range(n_chunks):
        if t == s and moved:
            gw_b.reroute(rname, r1)
        outs, n = _counted(lambda: gw_b.tick_many(K))
        assert n == gw_b.n_buckets
        for name in tenants:
            for k in range(K):
                got = {f: np.asarray(outs[name][f])[:, k] for f in STEP_FIELDS}
                _assert_step_equal(got, per_tick[name][t + k], f"{name}@chunk-hour{t + k}")
        t += K
    while t < T:  # ragged tail: chunked and per-tick interleave freely
        outs = gw_b.tick()
        for name in tenants:
            _assert_step_equal(outs[name], per_tick[name][t], f"{name}@tail-hour{t}")
        t += 1
    assert gw_b.hours == gw_a.hours == T
    for name in tenants:
        assert gw_a.billing(name) == gw_b.billing(name), name
    assert gw_a.check() == [] and gw_b.check() == [] and jgw.check() == []
    _assert_billing(gw_a, jgw, tenants)
    for name in tenants:
        a, b = gw_a.metrics(name), gw_b.metrics(name)
        _assert_windows(b, a, 0.0, f"chunked:{name}")
        _assert_windows(a, jgw.metrics(name), 1e-9, f"jax:{name}")


def test_one_launch_steps_256_heterogeneous_tenants():
    """ONE bucket, ONE pooled launch a tick, 256 heterogeneous tenants
    (distinct prices, thresholds, calendars and demands), every output bit
    for bit against 256 standalone runtimes and by the tolerances against
    JAX's gateway; one launch shape prepared (JAX compiles two: its drain
    variant)."""
    N, T = 256, 6
    cfg = dict(slots_per_bucket=N, cadence=T, obs=True)
    gw, jgw = _gateways(cfg)
    refs = {}
    want_key, i, seed = None, 0, 0
    while i < N:
        seed += 1
        ten = _fleet_tenant(2, 24, 7000 + seed, horizon=T)
        key = bucket_key_for(resolve_runtime_operands(ten.sc.fleet, RuntimeConfig(), CPU))
        want_key = key if want_key is None else want_key
        if key != want_key:
            continue
        _join(gw, jgw, f"t{i}", ten)
        refs[f"t{i}"] = (ten.runtime(), ten.sc)
        i += 1
    assert gw.n_buckets == jgw.n_buckets == 1 and gw.n_active == N
    for t in range(T):
        (outs, n), jouts = _counted(gw.tick), jgw.tick()
        assert n == 1
        for name, (rt, sc) in refs.items():
            _assert_step_equal(outs[name], rt.step(sc.demand[:, t]), name)
            _assert_step_close(outs[name], jouts[name], f"jax:{name}")
    assert gw.compiles == 1 and jgw.compiles == 2
    assert gw.check() == [] and jgw.check() == []
    _assert_billing(gw, jgw, refs)


# ---------------------------------------------------------------------------
# Churn: join/leave/rejoin/resize inside known shapes prepares nothing new
# ---------------------------------------------------------------------------


def test_churn_prepares_no_new_launch_shape():
    """Once a bucket's launch shape is prepared, leaves, joins into freed
    slots, a rejoin and a resize into a known shape leave ``compiles``
    frozen; every tenant stays equal to JAX's."""
    T = 40
    gw, jgw = _gateways(dict(slots_per_bucket=3, cadence=8))
    names = []
    for i in range(3):
        _join(gw, jgw, f"t{i}", _fleet_tenant(2, T, i))
        names.append(f"t{i}")

    def ticks(n):
        for _ in range(n):
            outs, jouts = gw.tick(), jgw.tick()
            assert outs.keys() == jouts.keys()
            for name in outs:
                _assert_step_close(outs[name], jouts[name], name)

    ticks(10)
    frozen = gw.compiles
    gw.leave("t1")
    jgw.leave("t1")
    _join(gw, jgw, "t3", _fleet_tenant(2, T, 77))     # the freed slot
    ticks(10)
    assert gw.compiles == frozen
    gw.leave("t0")
    jgw.leave("t0")
    _join(gw, jgw, "t0", _fleet_tenant(2, T, 78))     # a rejoin of a departed name
    ticks(10)
    assert gw.compiles == frozen
    big = _fleet_tenant(2, T, 79)                     # a resize into the same shape
    gw.resize("t2", big.spec)
    jgw.resize("t2", big.jspec)
    ticks(5)
    assert gw.compiles == frozen
    assert gw.check() == [] and jgw.check() == []
    _assert_billing(gw, jgw, ["t0", "t1", "t2", "t3"])


def test_resize_moves_buckets_and_carries_billing():
    """Grow a tenant across capacity buckets: billing accumulates across the
    incarnations, the new shape starts a fresh stream at its hour 0 (bit for
    bit against a fresh standalone runtime), and the old slot frees."""
    T = 30
    gw, jgw = _gateways(dict(slots_per_bucket=2, cadence=8))
    _join(gw, jgw, "acme", _fleet_tenant(2, T, 5))
    for _ in range(12):
        gw.tick()
        jgw.tick()
    before = gw.billing("acme")
    assert before["realized"] > 0
    big = _fleet_tenant(5, T, 6)
    h, jh = gw.resize("acme", big.spec), jgw.resize("acme", big.jspec)
    assert h.status == jh.status == "active"
    assert h.key.rows_cap == jh.key.rows_cap == 8   # 5 links -> pow2 bucket, distinct from 2
    ref = big.runtime()
    for t in range(10):
        out, jout = gw.tick()["acme"], jgw.tick()["acme"]
        _assert_step_equal(out, ref.step(big.sc.demand[:, t]), f"resized@t{t}")
        _assert_step_close(out, jout, f"jax:resized@t{t}")
    assert gw.billing("acme")["realized"] > before["realized"]
    _assert_billing(gw, jgw, ["acme"])
    assert gw.check() == [] and jgw.check() == []
    _assert_windows(gw.metrics("acme"), jgw.metrics("acme"), 1e-9, "jax:acme")


# ---------------------------------------------------------------------------
# Admission control: bounded queue, typed rejection, no device work
# ---------------------------------------------------------------------------


def test_backpressure_bounded_queue_and_typed_rejection():
    """A join burst past pool headroom queues FIFO up to the limit, then
    raises AdmissionError('queue_full') and prepares nothing; departures
    drain the queue in order, and a queued tenant starts its own hour 0."""
    T = 24
    gw, jgw = _gateways(dict(slots_per_bucket=2, max_buckets=1, queue_limit=2, cadence=8))
    base = _fleet_tenant(2, T, 0)

    def mk(seed):
        d = base.sc.demand * (1.0 + 0.1 * seed)
        return (TenantSpec(spec=base.sc.fleet, demand=d),
                JTenantSpec(spec=base.jsc.fleet, demand=d))

    for name, seed, want in (("a", 0, "active"), ("b", 1, "active"), ("c", 2, "queued"),
                             ("d", 3, "queued")):
        spec, jspec = mk(seed)
        assert gw.join(name, spec).status == jgw.join(name, jspec).status == want
    compiles_before = gw.compiles
    spec, jspec = mk(4)
    with pytest.raises(AdmissionError) as ei:
        gw.join("e", spec)
    assert ei.value.reason == "queue_full"
    with pytest.raises(Exception) as jei:
        jgw.join("e", jspec)
    assert jei.value.reason == "queue_full"
    assert gw.compiles == compiles_before == 0    # rejection prepared nothing
    assert gw.n_queued == jgw.n_queued == 2
    gw.tick()
    jgw.tick()
    for leaver, now_active, still_queued in (("a", "c", "d"), ("b", "d", None)):
        gw.leave(leaver)
        jgw.leave(leaver)
        assert gw.handle(now_active).status == jgw.handle(now_active).status == "active"
        if still_queued:
            assert gw.handle(still_queued).status == "queued"
    assert gw.n_queued == jgw.n_queued == 0
    spec, _ = mk(2)
    ref = FleetRuntime(spec.spec, device=CPU)
    out, jout = gw.tick()["c"], jgw.tick()["c"]
    _assert_step_equal(out, ref.step(spec.demand[:, 0]), "late-start")
    _assert_step_close(out, jout, "jax:late-start")


def test_too_large_tenant_rejected_typed():
    gw, jgw = _gateways(dict(max_rows=4))
    ten = _fleet_tenant(6, 24, 0)   # pads to 8 > 4
    with pytest.raises(AdmissionError) as ei:
        gw.join("huge", ten.spec)
    with pytest.raises(Exception) as jei:
        jgw.join("huge", ten.jspec)
    assert ei.value.reason == jei.value.reason == "too_large"
    assert gw.n_buckets == 0 and gw.compiles == 0


def test_live_mode_tenant_refused_in_the_reference_words():
    """The gateway pools replay-mode forecast tenants only: a live-mode
    tenant (a forecaster beside the policy) is refused before any pool."""
    from repro_torch.fleet import StreamingForecaster, streaming_forecast_policy

    sc = build_fleet_scenario(2, horizon=96, seed=0)
    arrays = sc.fleet.stack(torch.float64, CPU)
    pol, fc = streaming_forecast_policy(arrays, sc.demand[:, :48], steps=2, device=CPU)
    assert isinstance(fc, StreamingForecaster)
    gw = FleetGateway(GatewayConfig(), device=CPU)
    with pytest.raises(ValueError, match="live SSM forecasting is not poolable"):
        gw.join("live", TenantSpec(spec=sc.fleet, demand=sc.demand,
                                   config=RuntimeConfig(policy=pol, forecaster=fc)))
    assert gw.n_buckets == 0 and gw.n_active == 0


# ---------------------------------------------------------------------------
# Tenant-axis metrics: SLO breaches typed and attributed; honest runs silent
# ---------------------------------------------------------------------------


def test_tenant_slo_breach_is_typed_and_attributed():
    """An impossible budget breaches for its tenant only, as in JAX; the
    drained windows equal the standalone runtime's with observability on
    (counts exact, sums at rtol=1e-12) and JAX's (rtol=1e-9)."""
    T = 24
    gw, jgw = _gateways(dict(slots_per_bucket=2, cadence=8))
    cheap = _fleet_tenant(2, T, 3, slo=TenantSLO(max_hourly_cost=1e-9),
                          jslo=JTenantSLO(max_hourly_cost=1e-9))
    honest = _fleet_tenant(2, T, 4)
    _join(gw, jgw, "cheap", cheap)
    _join(gw, jgw, "honest", honest)
    refs = {n: t.runtime(obs=ObsConfig(cadence=8, hist_bins=8))
            for n, t in (("cheap", cheap), ("honest", honest))}
    for t in range(T):
        gw.tick()
        jgw.tick()
        for n, ten in (("cheap", cheap), ("honest", honest)):
            refs[n].step(ten.sc.demand[:, t])
    violations = gw.check()
    assert violations, "impossible SLO must breach"
    assert all(v.monitor == "tenant_slo" for v in violations)
    assert {v.details["tenant"] for v in violations} == {"cheap"}
    assert all("rate" in v.details for v in violations)
    assert _violations(violations) == _violations(jgw.check())
    assert sum(dm.ticks for dm in gw.metrics("cheap")) == T
    for n, rt in refs.items():
        rt._flush_obs()
        _assert_windows(gw.metrics(n), rt.obs.drained, 1e-12, f"standalone:{n}")
        _assert_windows(gw.metrics(n), jgw.metrics(n), 1e-9, f"jax:{n}")


def test_sync_groups_feed_fleet_sync_grads_with_the_tenant_label():
    """Per-tenant sync domains: the routed primary ports (JAX's), fed to the
    port's ``fleet_sync_grads(..., tenant=name)`` on a one-rank mesh, whose
    profiler ranges carry the tenant-tagged label JAX formats."""
    T = 24
    gw, jgw = _gateways(dict(slots_per_bucket=2))
    kw = dict(n_facilities=2, ports_per_facility=2, horizon=T, seed=0)
    sc, jsc = build_topology_scenario(4, **kw), jscen.build_topology_scenario(4, **kw)
    routing, jrouting = optimize_routing(sc.topo, sc.demand), jtop.optimize_routing(
        jsc.topo, jsc.demand)
    gw.join("acme/eu?1", TenantSpec(spec=sc.topo, demand=sc.demand,
                                    config=RuntimeConfig(routing=routing)))
    jgw.join("acme/eu?1", JTenantSpec(spec=jsc.topo, demand=jsc.demand,
                                      config=JRuntimeConfig(routing=jrouting)))
    out = gw.tick()["acme/eu?1"]
    jgw.tick()
    groups = gw.sync_groups("acme/eu?1")
    assert groups == jgw.sync_groups("acme/eu?1") == [int(g) for g in routing.primary]
    modes = gw.modes("acme/eu?1", out)
    assert len(modes) == len(groups)
    grads = [{"w": torch.full((2, 3), float(i + 1))} for i in range(len(groups))]
    try:
        mesh = make_host_mesh(data=1, model=1, device=CPU)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            synced, _, billed = coll.fleet_sync_grads(grads, mesh, modes, groups=groups,
                                                      tenant="acme/eu?1")
    finally:
        torch.distributed.destroy_process_group()
    for g, s in zip(grads, synced):
        assert torch.equal(g["w"], s["w"])
    assert len(billed) == len(groups)
    names = {e.key for e in prof.key_averages()}
    want = {jsync_domain_label(g, m, tenant="acme/eu?1") for g, m in zip(groups, modes)}
    assert want <= names and all(w.startswith("syncdom_t.acme-eu-1.g") for w in want)
    assert {coll.sync_domain_label(g, m, tenant="acme/eu?1") for g, m in zip(groups, modes)} \
        == want
    fleet = _fleet_tenant(3, T, 1)
    gw.join("f", fleet.spec)
    gw.tick()
    assert gw.sync_groups("f") == [0, 1, 2]
