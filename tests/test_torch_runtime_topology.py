"""Port vs JAX package for the streaming runtime in topology mode.

Region pairs fold onto shared ports over the routing's leg list; on the CPU
the port's ``FleetRuntime`` runs the plain version of its routed chunk
kernel (``stream_chunk_routed_ref``). It is held against:

* the JAX ``FleetRuntime`` in topology mode on the same scenarios (built by
  both packages from one seed, routed by both packages' ``optimize_routing``),
  per tick and in ``step_many`` chunks of K in {1, 7, 24}: ``x``, ``state``,
  ``vpn_cost`` and ``r_vpn`` equal bit for bit; ``cci_cost``, ``r_cci`` and
  ``cost`` at ``rtol=1e-12`` (XLA contracts the port's ``c·d`` and lease sum
  into a fused multiply-add, one ulp off; the tolerance
  ``tests/test_torch_runtime.py`` holds fleet mode to);
* the port's own CPU ``plan_topology`` and ``replay_plan_topology``: every
  field bit for bit (both fold legs in order and sum sequentially);
* ``reroute()`` at a chunk boundary and between ticks, against the JAX
  ``reroute()`` and the replay oracle of both packages;
* the re-routing scenario's frozen and live costs against JAX's
  (``examples/reroute_demo.py``'s regime swap: a saving of 0.38215 at
  ``(2000, 800, seed 0)``).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import jax_topology_dict

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.core import planner as jplanner
from repro.core.pricing import flat_rate as jflat_rate
from repro.fleet import engine as jeng
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.stream import ElasticFleetPlanner as JElasticFleetPlanner
from repro.fleet.stream import FleetRuntime as JFleetRuntime

from repro_torch.core import planner as tplanner
from repro_torch.core.pricing import flat_rate
from repro_torch.core.togglecci import window_sums
from repro_torch.fleet import (
    ElasticFleetPlanner,
    FleetRuntime,
    RoutingPlan,
    RuntimeConfig,
    resolve_runtime_operands,
)
from repro_torch.fleet import engine as teng
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import topology as ttop
from repro_torch.fleet.routing import index_legs
from repro_torch.fleet.topology import topology_arrays_from_numpy

EXACT = ("x", "state", "vpn_cost", "r_vpn")
CLOSE = ("cci_cost", "r_cci", "cost")
HOURS = 400
MONTH = 48          # a billing month short enough for several starts in a stream

SCENARIOS = {
    "topology": lambda m: m.build_topology_scenario(16, n_facilities=3, horizon=HOURS, seed=0),
    "relay": lambda m: m.build_relay_scenario(horizon=HOURS, seed=0),
    "multicast": lambda m: m.build_multicast_scenario(n_leaves=3, horizon=HOURS, seed=0),
}
# name: (scenario, padding legs, the stream's own calendar on pre-stacked
# arrays, endogenous CCI demand, NaN hours in pair 0)
CASES = {
    "topology": ("topology", 0, False, False, False),
    "month": ("topology", 0, True, False, False),
    "endo": ("topology", 0, False, True, False),
    "relay-padded": ("relay", 3, False, False, False),
    "multicast": ("multicast", 0, False, False, False),
    "nan-pair0-padded": ("topology", 4, False, False, True),
}
RUNS = [
    ("topology", "reactive", False, 1), ("topology", "hysteresis", True, 7),
    ("topology", "reactive", True, 24), ("month", "hysteresis", False, 24),
    ("month", "reactive", True, 7), ("endo", "reactive", False, 24),
    ("endo", "hysteresis", False, 1), ("relay-padded", "reactive", False, 7),
    ("multicast", "hysteresis", False, 24), ("nan-pair0-padded", "reactive", False, 24),
    ("nan-pair0-padded", "reactive", False, 1),
]
RUN_IDS = [f"{c}-{k}-{'chunks' if r else 'continuous'}-K{K}" for c, k, r, K in RUNS]


@functools.lru_cache(maxsize=None)
def _scenarios(name):
    jsc, tsc = SCENARIOS[name](jscen), SCENARIOS[name](tscen)
    assert np.array_equal(jsc.demand, tsc.demand)
    jr = jtop.optimize_routing(jsc.topo, jsc.demand)
    tr = ttop.optimize_routing(tsc.topo, tsc.demand)
    assert jr.paths == tr.paths and jr.n_legs == tr.n_legs
    return jsc, tsc, jr, tr


def _case(case, kind):
    """Both packages' stream operands for ``case``: (jax spec or arrays, port
    spec or arrays, the JAX runtime's keywords, the port's, demand, CCI
    demand). With its own calendar a case streams pre-stacked arrays (the
    JAX arrays carried into the port), which take ``hours_per_month``."""
    name, pad, own_month, endo, nan = CASES[case]
    jsc, tsc, jr, tr = _scenarios(name)
    jtopo = dataclasses.replace(jsc.topo, policy=kind)
    ttopo = dataclasses.replace(tsc.topo, policy=kind)
    if pad:
        jr, tr = jr.pad_to(jr.n_legs + pad), tr.pad_to(tr.n_legs + pad)
    demand = tsc.demand
    if nan:
        demand = demand.copy()
        demand[0, [30, 31, 100, 250]] = np.nan
    cci = demand * 1.5 if endo else None
    if own_month:
        with enable_x64():
            jarr = jtopo.stack(jr, jnp.float64)
        tarr = topology_arrays_from_numpy(jax_topology_dict(jarr), "cpu")
        month = {"hours_per_month": MONTH}
        return jarr, tarr, month, month, demand, cci
    return jtopo, ttopo, {"routing": jr}, {"routing": tr}, demand, cci


def _stream(rt, demand, K, cci=None):
    """Stream (rows, T) through ``rt``: chunks of K, then a per-tick tail
    (K = 1: per tick throughout); outputs stacked to (rows, T)."""
    T = demand.shape[1]
    blk = lambda a, b: None if cci is None else cci[:, a:b]
    outs, t = [], 0
    while t < T:
        if K > 1 and t + K <= T:
            outs.append(rt.step_many(demand[:, t:t + K], cci_demand_block=blk(t, t + K)))
            t += K
        else:
            c = None if cci is None else cci[:, t]
            outs.append({k: v[:, None] for k, v in rt.step(demand[:, t], cci_demand_t=c).items()})
            t += 1
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}


@functools.lru_cache(maxsize=None)
def _port_run(case, kind, renew, K):
    _, tspec, _, kw, demand, cci = _case(case, kind)
    rt = FleetRuntime(tspec, renew_in_chunks=renew, device="cpu", **kw)
    assert rt.topology and rt.n_demand_rows == demand.shape[0]
    return _stream(rt, demand, K, cci), rt


@pytest.mark.parametrize("case,kind,renew,K", RUNS, ids=RUN_IDS)
def test_topology_stream_matches_jax_runtime(case, kind, renew, K):
    jspec, _, jkw, _, demand, cci = _case(case, kind)
    want = _stream(JFleetRuntime(jspec, renew_in_chunks=renew, **jkw), demand, K, cci)
    got, rt = _port_run(case, kind, renew, K)
    assert got["x"].shape == (rt.n_rows, demand.shape[1])
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    if case in ("topology", "month"):
        assert 0 < want["x"].sum() < want["x"].size           # the ports do toggle
    if case.startswith("nan"):   # a NaN hour prices +0.0; its volume is NaN on pair 0's
        # ports and, through the padding legs, on port 0
        nan_ports = set(np.flatnonzero(np.isnan(got["cci_cost"][:, 30])).tolist())
        assert nan_ports == {0, *rt.routing_plan.paths[0]} and not np.isnan(got["vpn_cost"]).any()


@pytest.mark.parametrize("case,kind,renew,K",
                         [r for r in RUNS if not CASES[r[0]][3]],
                         ids=[i for r, i in zip(RUNS, RUN_IDS) if not CASES[r[0]][3]])
def test_topology_stream_matches_port_plan_topology(case, kind, renew, K):
    """The stream equals the offline plan of the same routing, every bit of
    every field (NaN in the same places)."""
    _, tspec, _, kw, demand, _ = _case(case, kind)
    got, rt = _port_run(case, kind, renew, K)
    plan = teng.plan_topology(tspec, demand, renew_in_chunks=renew, device="cpu", **kw)
    vpn, cci = plan["vpn_hourly"], plan["cci_hourly"]
    h = rt.arrays.toggle.h
    want = {"x": plan["x"], "state": plan["state"], "vpn_cost": vpn, "cci_cost": cci,
            "r_vpn": window_sums(vpn, h), "r_cci": window_sums(cci, h),
            "cost": torch.where(plan["x"] == 1, cci, vpn)}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.numpy(), err_msg=k)


def test_chunked_stream_equals_per_tick_in_outputs_and_host_state():
    """Any chunking, mixed with per-tick steps, gives the per-tick stream bit
    for bit, in the outputs and in every carried host array."""
    _, tsc, _, tr = _scenarios("multicast")
    d = tsc.demand[:, :130]
    ticked = FleetRuntime(tsc.topo, routing=tr, device="cpu")
    per_tick = _stream(ticked, d, 1)
    mixed = FleetRuntime(tsc.topo, routing=tr, device="cpu")
    outs, t = [], 0
    for K in (5, 1, 24, 1, 1, 37, 49, 12):
        outs.append(mixed.step_many(d[:, t:t + K]))
        t += K
    assert t == d.shape[1]
    for k in per_tick:
        np.testing.assert_array_equal(np.concatenate([o[k] for o in outs], 1), per_tick[k],
                                      err_msg=k)
    for f in ("dcum", "dcum_month", "vpn_pref", "cci_pref", "ring_vpn", "ring_cci"):
        np.testing.assert_array_equal(getattr(mixed._state, f), getattr(ticked._state, f),
                                      err_msg=f)


def test_from_config_and_the_resolver_in_topology_mode():
    """``resolve_runtime_operands`` stacks a TopologySpec with its routing
    (the leg index built on the host, the calendar from the spec), and
    ``from_config`` streams what the keyword constructor streams."""
    sc = tscen.build_reroute_scenario(horizon=96, shift_hour=48, seed=0)
    plan = sc.topo.plan([0, 0, 1])
    r = resolve_runtime_operands(sc.topo, RuntimeConfig(routing=plan, hours_per_month=24),
                                 "cpu")
    assert r.topology and r.spec is sc.topo and r.routing_plan is plan
    assert r.hours_per_month == sc.topo.hours_per_month and r.arrays.routing.index is not None
    a = FleetRuntime.from_config(sc.topo, RuntimeConfig(routing=plan), device="cpu")
    b = FleetRuntime(sc.topo, routing=plan, device="cpu")
    got, want = a.run(sc.demand), b.run(sc.demand)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# The port-major leg descriptors the routed chunk kernel stages
# ---------------------------------------------------------------------------


def _assert_port_major(op):
    """``op``'s LegIndex holds its legs' pair, VPN share and attachment
    weight in port-major order: ``leg_pair[order]`` and so on, every port's
    run from ``start[m]`` in ascending leg index."""
    idx = op.index
    o = idx.order.long()
    assert torch.equal(idx.leg_pair_pm, op.leg_pair[o]) and idx.leg_pair_pm.dtype == torch.int32
    assert torch.equal(idx.vpn_w_pm, op.vpn_w[o]) and torch.equal(idx.attach_w_pm, op.attach_w[o])
    ports = op.leg_port[o]
    for m in range(idx.n_ports):
        run = o[idx.start[m]:idx.start[m + 1]]
        assert (ports[idx.start[m]:idx.start[m + 1]] == m).all()
        assert (run[1:] > run[:-1]).all()


@pytest.mark.parametrize("case", ["relay-padded", "multicast", "nan-pair0-padded"])
def test_port_major_leg_descriptors(case):
    """``RoutingPlan.operand`` (the runtime's routing) and ``index_legs``
    (an operand built elsewhere, or one whose index lacks them) build the
    descriptors equal to the leg list gathered through ``order``; padding
    legs (pair 0, port 0, zero weights) stay in their place in port 0's
    run."""
    _, ttopo, _, tkw, _, _ = _case(case, "reactive")
    rt = FleetRuntime(ttopo, device="cpu", **tkw)
    op = rt.arrays.routing
    _assert_port_major(op)
    bare = op._replace(index=None)
    _assert_port_major(index_legs(bare, rt.n_rows))
    partial = op._replace(index=op.index._replace(leg_pair_pm=None, vpn_w_pm=None,
                                                  attach_w_pm=None))
    assert not partial.index.port_major
    _assert_port_major(index_legs(partial, rt.n_rows))
    assert index_legs(op, rt.n_rows) is op
    pad = CASES[case][1]
    if pad:
        tail = op.index.attach_w_pm[op.index.start[0]:op.index.start[1]]
        assert (tail[-pad:] == 0).all()


def test_port_major_leg_descriptors_rebuilt_by_reroute():
    """``reroute()`` builds the new routing's descriptors on the host, once:
    after a swap of hop depth (relay, within one padded bound) and a move
    of pairs (topology), they are the new leg list's in port-major order."""
    tsc = tscen.build_relay_scenario(horizon=240, seed=0)
    trel = ttop.optimize_routing(tsc.topo, tsc.demand)
    tdir = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=1)
    rt = FleetRuntime(tsc.topo, routing=tdir.pad_to(trel.total_hops), device="cpu")
    rt.step_many(tsc.demand[:, :24])
    before = rt.arrays.routing.index
    rt.reroute(trel)
    _assert_port_major(rt.arrays.routing)
    assert not torch.equal(rt.arrays.routing.index.leg_pair_pm, before.leg_pair_pm)
    ssc = tscen.build_topology_scenario(8, n_facilities=3, horizon=96, seed=5)
    t0 = ttop.optimize_routing(ssc.topo, ssc.demand)
    rt = FleetRuntime(ssc.topo, routing=t0, device="cpu")
    before = rt.arrays.routing.index
    rt.reroute(_moved_plan(ssc.topo, t0, 4))
    _assert_port_major(rt.arrays.routing)
    assert not torch.equal(rt.arrays.routing.index.start, before.start)


# reroute(): swaps at a chunk boundary and between ticks
# ---------------------------------------------------------------------------


def _moved_plan(topo, plan, n_moves):
    """``plan`` with up to ``n_moves`` pairs moved to another candidate port
    (the first one that differs), as a validated plan of ``topo``."""
    idx = np.asarray(plan.primary).copy()
    moved = 0
    for i, pr in enumerate(topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others and moved < n_moves:
            idx[i] = others[0]
            moved += 1
    assert moved > 0
    return topo.plan(idx)


def _swap_stream(rt, demand, schedule, K):
    """Stream with ``rt.reroute(plan)`` at each ``(hour, plan)`` of
    ``schedule``: chunks of K that end at every swap hour (K = 1: per tick)."""
    T = demand.shape[1]
    swaps = dict(schedule)
    outs, t = [], 0
    while t < T:
        if t in swaps:
            rt.reroute(swaps[t])
        nxt = min([s for s in swaps if s > t] + [T])
        k = min(K, nxt - t)
        outs.append(rt.step_many(demand[:, t:t + k]))
        t += k
    return {k: np.concatenate([o[k] for o in outs], axis=1) for k in outs[0]}


REROUTES = {"chunk-boundary": (24, 192), "between-ticks": (1, 157)}


@pytest.mark.parametrize("where", sorted(REROUTES))
def test_reroute_matches_jax_reroute_and_replay(where):
    K, s = REROUTES[where]
    jsc = jscen.build_topology_scenario(8, n_facilities=3, horizon=360, seed=5)
    tsc = tscen.build_topology_scenario(8, n_facilities=3, horizon=360, seed=5)
    j0, t0 = jtop.optimize_routing(jsc.topo, jsc.demand), ttop.optimize_routing(tsc.topo,
                                                                                 tsc.demand)
    j1, t1 = _moved_plan(jsc.topo, j0, 4), _moved_plan(tsc.topo, t0, 4)
    assert j1.paths == t1.paths and j1.paths != j0.paths
    demand, hpm = tsc.demand, tsc.topo.hours_per_month
    got = _swap_stream(FleetRuntime(tsc.topo, routing=t0, device="cpu"), demand,
                       [(s, t1)], K)
    jrt = JFleetRuntime(jsc.topo, routing=j0)
    jouts = []
    for t in range(demand.shape[1]):
        if t == s:
            jrt.reroute(j1)
        jouts.append(jrt.step(demand[:, t]))
    want = {k: np.stack([o[k] for o in jouts], axis=1) for k in jouts[0]}
    for k in EXACT:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    assert 0 < got["x"].sum() < got["x"].size
    with enable_x64():
        jarr = jsc.topo.stack(j0, jnp.float64)
    jrep = jeng.replay_plan_topology(jarr, demand, [(0, j0), (s, j1)], hours_per_month=hpm)
    trep = teng.replay_plan_topology(tsc.topo.stack(t0, device="cpu"), demand,
                                     [(0, t0), (s, t1)], hours_per_month=hpm, device="cpu")
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k], np.asarray(jrep[k]), err_msg=k)
        np.testing.assert_array_equal(got[k], trep[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got["vpn_cost"], trep["vpn_hourly"].numpy())
    np.testing.assert_array_equal(got["cci_cost"], trep["cci_hourly"].numpy())


def test_reroute_hop_depth_swaps_match_replay():
    """1-hop, then the relay path, then 1-hop again, in K = 24 chunks within
    one padded leg bound (``tests/test_multihop.py:215``): the stream equals
    the replay of the same schedule in both packages."""
    jsc, tsc = jscen.build_relay_scenario(horizon=240, seed=0), \
        tscen.build_relay_scenario(horizon=240, seed=0)
    jrel, trel = jtop.optimize_routing(jsc.topo, jsc.demand), ttop.optimize_routing(
        tsc.topo, tsc.demand)
    jdir = jtop.optimize_routing(jsc.topo, jsc.demand, max_hops=1)
    tdir = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=1)
    bound = trel.total_hops
    assert bound > tdir.total_hops and trel.hop_depth == 2
    sched = [(96, trel), (168, tdir)]
    rt = FleetRuntime(tsc.topo, routing=tdir.pad_to(bound), device="cpu")
    got = _swap_stream(rt, tsc.demand, sched, 24)
    assert rt.routing_plan.paths == tdir.paths and rt.arrays.routing.n_legs == bound
    trep = teng.replay_plan_topology(tsc.topo.stack(tdir.pad_to(bound), device="cpu"),
                                     tsc.demand, [(0, tdir.pad_to(bound))] + sched,
                                     hours_per_month=tsc.topo.hours_per_month, device="cpu")
    with enable_x64():
        jarr = jsc.topo.stack(jdir.pad_to(bound), jnp.float64)
    jrep = jeng.replay_plan_topology(jarr, jsc.demand,
                                     [(0, jdir.pad_to(bound)), (96, jrel), (168, jdir)],
                                     hours_per_month=jsc.topo.hours_per_month)
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k], trep[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(got[k], np.asarray(jrep[k]), err_msg=k)
    np.testing.assert_array_equal(got["vpn_cost"], trep["vpn_hourly"].numpy())
    np.testing.assert_array_equal(got["cci_cost"], trep["cci_hourly"].numpy())


def test_reroute_guards_and_modes_mapping():
    """``reroute()`` is topology-only, keeps the spec's validation and the leg
    bound, and ``modes()`` maps port states onto PAIRS through the current
    routing (``tests/test_fleet_runtime.py:456``, ``tests/test_multihop.py:258``)."""
    from repro_torch.core.planner import collective_mode
    from repro_torch.fleet import build_fleet_scenario

    sc = tscen.build_reroute_scenario(horizon=300, shift_hour=150, seed=0)
    jsc = jscen.build_reroute_scenario(horizon=300, shift_hour=150, seed=0)
    rt = FleetRuntime(sc.topo, routing=sc.topo.plan([0, 0, 1]), device="cpu")
    jrt = JFleetRuntime(jsc.topo, routing=jsc.topo.plan([0, 0, 1]))
    out, jout = rt.step(sc.demand[:, 0]), jrt.step(sc.demand[:, 0])
    modes = rt.modes(out)
    assert modes == jrt.modes(jout) and len(modes) == 3             # per PAIR
    assert modes == [collective_mode(int(out["state"][m])) for m in (0, 0, 1)]
    np.testing.assert_array_equal(rt.port_occupancy(), [2.0, 1.0])
    rt.reroute(sc.topo.plan([0, 0, 0]))
    np.testing.assert_array_equal(rt.port_occupancy(), [3.0, 0.0])
    with pytest.raises(AssertionError, match="non-candidate"), \
            pytest.warns(DeprecationWarning):
        rt.reroute([1, 0, 0])                  # pair 0's only candidate is port 0
    with pytest.raises(AssertionError, match="non-candidate"), \
            pytest.warns(DeprecationWarning):
        rt.reroute(np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 0.0]]))
    with pytest.raises(AssertionError, match="one-hot"), pytest.warns(DeprecationWarning):
        rt.reroute(np.ones((2, 3)))
    with pytest.raises(ValueError, match="3 rows"):
        rt.reroute(RoutingPlan.from_indices([0, 0], 2))
    np.testing.assert_array_equal(rt.port_occupancy(), [3.0, 0.0])   # refused: unchanged
    fleet_rt = FleetRuntime(build_fleet_scenario(2, horizon=24, seed=0).fleet, device="cpu")
    with pytest.raises(ValueError, match="topology"):
        fleet_rt.reroute([0, 0])
    assert fleet_rt.modes(fleet_rt.step(np.zeros(2))) == ["compressed"] * 2
    relay = tscen.build_relay_scenario(horizon=48, seed=0)
    direct = ttop.optimize_routing(relay.topo, relay.demand, max_hops=1)
    tight = FleetRuntime(relay.topo, routing=direct, device="cpu")    # a tight 1-hop bound
    tight.step(relay.demand[:, 0])
    with pytest.raises(ValueError, match="padded bound"):
        tight.reroute(ttop.optimize_routing(relay.topo, relay.demand))
    with pytest.raises(ValueError, match="explicit routing"):
        FleetRuntime(sc.topo, device="cpu")
    with pytest.raises(ValueError, match="already carry a routing"):
        FleetRuntime(sc.topo.stack(sc.topo.plan([0, 0, 1]), device="cpu"),
                     routing=sc.topo.plan([0, 0, 1]), device="cpu")


# ---------------------------------------------------------------------------
# The re-routing scenario: frozen vs live re-packing on streamed state
# ---------------------------------------------------------------------------


def _repack_run(runtime_cls, optimize, sc, *, live, **kw):
    """Stream ``sc`` in 24-hour ``step_many`` chunks from the routing of its
    first week's demand; with ``live``, re-pack the pairs at every chunk
    boundary on the trailing 168-hour means (``examples/reroute_demo.py``)
    and ``reroute()`` when the packing changes. Returns (summed cost, the
    runtime, the swap hours)."""
    r0 = optimize(sc.topo, sc.demand[:, :168])
    rt = runtime_cls(sc.topo, routing=r0, **kw)
    T = sc.demand.shape[1]
    cost, swaps, t = 0.0, [], 0
    while t < T:
        if live and t > 0:
            seen = sc.demand[:, max(0, t - 168):t].mean(axis=1)
            r_new = optimize(sc.topo, mean_demand=seen)
            if not np.array_equal(r_new.primary, rt.routing_plan.primary):
                rt.reroute(r_new)
                swaps.append(t)
        k = min(24, T - t)
        cost += float(rt.step_many(sc.demand[:, t:t + k])["cost"].sum())
        t += k
    return cost, rt, swaps


def test_reroute_scenario_demand_and_live_win():
    """``build_reroute_scenario`` builds JAX's demand bit for bit, and live
    re-routing beats the frozen day-one routing, ending with every pair on
    the hub (``tests/test_fleet_runtime.py:489``)."""
    sc = tscen.build_reroute_scenario(horizon=1400, shift_hour=500, seed=1)
    jsc = jscen.build_reroute_scenario(horizon=1400, shift_hour=500, seed=1)
    assert np.array_equal(sc.demand, jsc.demand)
    assert [p.name for p in sc.topo.pairs] == [p.name for p in jsc.topo.pairs]
    assert list(ttop.optimize_routing(sc.topo, sc.demand[:, :168]).primary) == [0, 0, 1]
    frozen, _, _ = _repack_run(FleetRuntime, ttop.optimize_routing, sc, live=False,
                               device="cpu")
    lively, rt, swaps = _repack_run(FleetRuntime, ttop.optimize_routing, sc, live=True,
                                    device="cpu")
    assert lively < frozen and swaps
    np.testing.assert_array_equal(rt.port_occupancy(), [3.0, 0.0])
    with pytest.raises(ValueError, match="shift_hour"):
        tscen.build_reroute_scenario(horizon=100, shift_hour=100)


def test_reroute_scenario_costs_match_jax():
    """The README's ~38 % re-routing win at ``(2000, 800, seed 0)``: frozen
    and live costs equal the JAX runtime's within ``rtol=1e-12`` (JAX on the
    CPU: $74,510.61 and $46,036.61), the same swap hours, saving 0.38215."""
    sc = tscen.build_reroute_scenario(horizon=2000, shift_hour=800, seed=0)
    jsc = jscen.build_reroute_scenario(horizon=2000, shift_hour=800, seed=0)
    got, want = {}, {}
    for live in (False, True):
        got[live] = _repack_run(FleetRuntime, ttop.optimize_routing, sc, live=live,
                                device="cpu")
        want[live] = _repack_run(JFleetRuntime, jtop.optimize_routing, jsc, live=live)
        assert got[live][2] == want[live][2]
        np.testing.assert_allclose(got[live][0], want[live][0], rtol=1e-12, atol=0)
    saving = 1.0 - got[True][0] / got[False][0]
    assert abs(got[False][0] - 74510.61) < 0.01 and abs(got[True][0] - 46036.61) < 0.01
    assert abs(saving - 0.38215) < 5e-6, saving


# ---------------------------------------------------------------------------
# Per-port actuation: ElasticFleetPlanner in topology mode
# ---------------------------------------------------------------------------


def _two_port_topology(m, rate):
    """Two ports, three pairs that may use either (``tests/test_fleet_runtime.py:618``)."""
    mk_port = lambda n, f: m.PortSpec(name=n, facility=f, cloud="aws", L_cci=4.55,
                                      V_cci=0.1, c_cci=0.002, D=6, T_cci=12, h=12)
    pairs = tuple(m.PairSpec(f"pr{i}", "gcp", "aws", 0.105, rate(0.1), candidates=(0, 1))
                  for i in range(3))
    return m.TopologySpec(ports=(mk_port("hub", "f0"), mk_port("idle", "f1")), pairs=pairs)


def test_elastic_planner_per_port_matches_jax():
    """Per-pair bytes in, per-pair modes out through the routing, per-port
    leases in the report; the same modes, costs and bytes as JAX every hour,
    and a reroute re-targets the actuation on the next hour."""
    topo = _two_port_topology(ttop, flat_rate)
    jtopo = _two_port_topology(jtop, jflat_rate)
    pl = ElasticFleetPlanner(topo, routing=topo.plan([0, 0, 1]), device="cpu")
    jpl = JElasticFleetPlanner(jtopo, routing=jtopo.plan([0, 0, 1]))
    assert pl.topology and jpl.topology
    np.testing.assert_array_equal(pl.sync_groups(), [0, 0, 1])
    traffic = np.array([5e12, 5e12, 1e9])       # two hot pairs share the hub
    for _ in range(200):
        modes = pl.feed_hour(traffic)
        assert modes == jpl.feed_hour(traffic)
    assert modes == ["hierarchical", "hierarchical", "compressed"]
    rep, jrep = pl.report(), jpl.report()
    for f in ("hours", "on_fraction", "port_occupancy", "pair_gb", "pair_gb_saved"):
        np.testing.assert_array_equal(getattr(rep, f), getattr(jrep, f), err_msg=f)
    for f in ("total_cost", "cost_always_vpn", "cost_always_cci", "link_cost"):
        np.testing.assert_allclose(getattr(rep, f), getattr(jrep, f), rtol=1e-12, err_msg=f)
    np.testing.assert_array_equal(rep.port_occupancy, [2.0, 1.0])
    assert rep.on_fraction.shape == (2,) and rep.pair_gb_saved.shape == (3,)
    gb = traffic / 1e9
    shared_hour = 4.55 + 2 * 0.1 + 0.002 * (gb[0] + gb[1])   # one lease for two pairs
    assert pl.cost_cci_only[0] == pytest.approx(rep.hours * shared_hour, rel=1e-9)
    pl.runtime.reroute(topo.plan([0, 0, 0]))
    jpl.runtime.reroute(jtopo.plan([0, 0, 0]))
    modes = pl.feed_hour(traffic)
    assert modes == jpl.feed_hour(traffic) and modes[2] == "hierarchical"
    np.testing.assert_array_equal(pl.sync_groups(), [0, 0, 0])


def test_fleet_planner_factory_passes_the_routing():
    topo = _two_port_topology(ttop, flat_rate)
    pl = tplanner.fleet_planner(topo, routing=topo.plan([1, 1, 0]), device="cpu",
                                compress_ratio=2.0)
    jtopo = _two_port_topology(jtop, jflat_rate)
    jpl = jplanner.fleet_planner(jtopo, routing=jtopo.plan([1, 1, 0]), compress_ratio=2.0)
    assert isinstance(pl, ElasticFleetPlanner) and pl.topology
    np.testing.assert_array_equal(pl.sync_groups(), jpl.sync_groups())
    for _ in range(30):
        assert pl.feed_hour([3e12, 1e9, 2e12]) == jpl.feed_hour([3e12, 1e9, 2e12])
    np.testing.assert_array_equal(pl.report().port_occupancy, [1.0, 2.0])
