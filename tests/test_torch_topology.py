"""Port vs JAX package for the topology planning slice.

The same scenarios (built by both packages from one seed; ≤ 32 pairs x 2000
hours) go through the JAX package's routing heuristics and
``plan_topology`` and through the port's, on the CPU. Routings, specs and
stacked operands must be equal; decisions (``x``, ``state``) equal element
for element; costs within ``rtol=1e-9`` and hourly series within ``rtol=1e-9,
atol=1e-9`` (XLA's float64 cumsum and fused adds are not the sequential,
unfused arithmetic of PyTorch on the CPU; ``tests/test_torch_fleet.py``
holds the fleet path so). The port's plain leg-ordered segment sum is held
against ``jax.ops.segment_sum`` bit for bit (XLA:CPU's scatter adds in
update order), NaN, inf, -0.0 and padding legs included.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_support import jax_topology_dict

import jax
import jax.numpy as jnp

from repro.fleet import engine as jeng
from repro.fleet import report as jrep
from repro.fleet import routing as jrout
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop

from repro_torch.fleet import engine as teng
from repro_torch.fleet import routing as trout
from repro_torch.fleet import scenario as tscen
from repro_torch.fleet import topology as ttop
from repro_torch.fleet.policy import reactive_policy
from repro_torch.kernels import ops, ref

BUILDERS = {
    "topology-0": lambda m: m.build_topology_scenario(
        32, n_facilities=4, ports_per_facility=2, horizon=2000, seed=0),
    "topology-1": lambda m: m.build_topology_scenario(
        24, n_facilities=3, ports_per_facility=3, reach=1, horizon=2000, seed=1),
    "topology-2": lambda m: m.build_topology_scenario(
        16, n_facilities=2, ports_per_facility=2, horizon=2000, seed=2),
    "relay": lambda m: m.build_relay_scenario(horizon=1200, seed=0),
    "multicast": lambda m: m.build_multicast_scenario(n_leaves=4, horizon=1200, seed=0),
}
PLANNED = ("topology-0", "relay", "multicast")


@functools.lru_cache(maxsize=None)
def _scenarios(name):
    return BUILDERS[name](jscen), BUILDERS[name](tscen)


@functools.lru_cache(maxsize=None)
def _jax_plan(name, kind):
    jsc, _ = _scenarios(name)
    topo = dataclasses.replace(jsc.topo, policy=kind)
    routing = jtop.optimize_routing(topo, jsc.demand)
    return routing, jeng.plan_topology(topo, jsc.demand, routing=routing)


def _assert_plan_close(got, want, keys=("toggle_cost", "static_vpn", "static_cci")):
    for k in ("x", "state"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9, err_msg=k)
    for k in ("vpn_hourly", "cci_hourly"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9, atol=1e-9,
                                   err_msg=k)


def _operand_np(op):
    return {f: np.asarray(getattr(op, f)) for f in jrout.RoutingOperand._fields}


def _same_fields(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


PLANS = {
    "unicast": (((0,), (2,), (1,), (2,)), 3, -1, ()),
    "relay": (((0,), (1,), (0, 1), (2, 0, 1)), 3, -1, ()),
    "tree": (((0,), (0, 1, 2, 3)), 4, -1, (1,)),
    "padded": (((0,), (2, 1), (1,)), 3, 9, ()),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_routing_operand_matches_jax(case):
    paths, M, n_legs, trees = PLANS[case]
    jp = jrout.RoutingPlan(paths=paths, n_ports=M, n_legs=n_legs, tree_rows=trees)
    tp = trout.RoutingPlan(paths=paths, n_ports=M, n_legs=n_legs, tree_rows=trees)
    with jax.enable_x64():
        want = _operand_np(jp.operand(jnp.float64))
    op = tp.operand(torch.float64, "cpu")
    _same_fields(_operand_np(op), want)
    # the port-major index walks each port's legs in ascending leg order
    order, start = op.index.order.numpy(), op.index.start.numpy()
    for m in range(M):
        run = order[start[m]:start[m + 1]]
        assert list(run) == [e for e in range(tp.n_legs) if want["leg_port"][e] == m]
    np.testing.assert_array_equal(op.index.n_attach.numpy(), jp.matrix.sum(axis=1))
    kw = dict(n_legs=tp.n_legs + 5, n_rows=tp.n_rows + 2, pad_pair=tp.n_rows + 1,
              pad_port=M)
    _same_fields(_operand_np(trout.padded_operand_np(tp, **kw)),
                 _operand_np(jrout.padded_operand_np(jp, **kw)))
    assert trout.RoutingPlan.from_operand(op, M, tree_rows=trees).paths == paths


def test_legacy_routings_warn_and_match():
    with pytest.warns(DeprecationWarning, match="plan_topology"):
        plan = trout.as_routing_plan([1, 0, 1], n_ports=2, context="plan_topology")
    assert plan.paths == ((1,), (0,), (1,))
    with pytest.warns(DeprecationWarning, match="one-hot"):
        again = trout.as_routing_plan(plan.matrix, n_ports=2)
    assert again.paths == plan.paths
    np.testing.assert_array_equal(ttop.routing_matrix([1, 0, 1], 2, device="cpu").numpy(),
                                  np.asarray(jtop.routing_matrix([1, 0, 1], 2)))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scenario_parity(name):
    """Demand, specs and the stacked arrays, field by field; the JAX arrays
    carried across with ``topology_arrays_from_numpy`` equal the port's own
    ``TopologySpec.stack``, leg index included."""
    jsc, tsc = _scenarios(name)
    assert np.array_equal(tsc.demand, jsc.demand) and tsc.horizon == jsc.horizon
    for a, b in zip(tsc.topo.ports + tsc.topo.pairs + tsc.topo.groups,
                    jsc.topo.ports + jsc.topo.pairs + jsc.topo.groups):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert tsc.summary() == jsc.summary()
    jplan = jtop.optimize_routing(jsc.topo, jsc.demand)
    tplan = ttop.optimize_routing(tsc.topo, tsc.demand)
    with jax.enable_x64():
        d = jax_topology_dict(jsc.topo.stack(jplan, jnp.float64))
    carried = ttop.topology_arrays_from_numpy(d, "cpu")
    own = tsc.topo.stack(tplan, torch.float64, "cpu")
    for name_, a, b in zip(own._fields, own, carried):
        inner = zip(a, b) if name_ in ("toggle", "routing") else [(a, b)]
        for x, y in inner:
            if isinstance(x, trout.LegIndex):   # tensors, then the host's hottest port
                assert all(torch.equal(u, v) if torch.is_tensor(u) else u == v
                           for u, v in zip(x, y)), name_
            else:
                assert x.dtype == y.dtype and torch.equal(x, y), name_
    back = {k: v.numpy() for k, v in own._asdict().items() if k not in ("toggle", "routing")}
    back.update({k: v.numpy() for k, v in own.toggle._asdict().items()})
    back.update({k: v.numpy() for k, v in own.routing._asdict().items() if k != "index"})
    _same_fields(back, d)


@pytest.mark.parametrize("max_hops", [None, 1], ids=["any", "one-hop"])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_routing_heuristics_match_jax(name, max_hops):
    jsc, tsc = _scenarios(name)
    want = jtop.optimize_routing(jsc.topo, jsc.demand, max_hops=max_hops)
    got = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=max_hops)
    assert (got.paths, got.n_legs, got.tree_rows, got.provenance) == (
        want.paths, want.n_legs, want.tree_rows, want.provenance)
    jfleet = jtop.dedicated_fleet(jsc.topo, want)
    tfleet = ttop.dedicated_fleet(tsc.topo, got)
    for a, b in zip(tfleet.links, jfleet.links):
        assert (a.name, a.family, a.capacity_gb_hr) == (b.name, b.family, b.capacity_gb_hr)
        assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)
    if tsc.topo.groups:
        (je, jmap), (te, tmap) = (jtop.multicast_unicast_expansion(jsc.topo),
                                  ttop.multicast_unicast_expansion(tsc.topo))
        np.testing.assert_array_equal(tmap, jmap)
        assert [dataclasses.asdict(p) for p in te.pairs] == [dataclasses.asdict(p) for p in je.pairs]


SEG_CASES = {  # P, T, M, padding legs, max hops
    "unicast": (12, 50, 4, 0, 1),
    "multihop": (40, 120, 8, 0, 3),
    "padded-nan": (40, 120, 8, 37, 3),
    "wide": (300, 40, 64, 300, 3),
}


def _seeded_legs(seed, P, T, M, pad, hops):
    rng = np.random.default_rng(seed)
    paths = tuple(tuple(rng.choice(M, size=int(rng.integers(1, hops + 1)), replace=False).tolist())
                  for _ in range(P))
    plan = trout.RoutingPlan(paths=paths, n_ports=M)
    op = plan.pad_to(plan.total_hops + pad).operand(torch.float64, "cpu")
    src = rng.normal(scale=100.0, size=(P, T))
    src[0, 3], src[0, 5], src[0, 6] = np.nan, np.inf, -np.inf
    src[1, 7], src[2, :4] = -0.0, -0.0
    return src, op


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_leg_segment_sum_plain_matches_jax_bit_for_bit(case):
    P, T, M, pad, hops = SEG_CASES[case]
    src, op = _seeded_legs(7, P, T, M, pad, hops)
    lp, lm = op.leg_pair.numpy(), op.leg_port.numpy()
    for w in (op.vpn_w, op.attach_w):
        with jax.enable_x64():
            want = np.asarray(jax.ops.segment_sum(
                jnp.asarray(src)[lp] * jnp.asarray(w.numpy())[:, None], jnp.asarray(lm),
                num_segments=M))
        got = ref.leg_segment_sum_ref(torch.tensor(src), op.leg_pair, op.leg_port, w, M)
        assert np.array_equal(got.numpy().view(np.int64), want.view(np.int64))
    both = ops.leg_segment_sum((torch.tensor(src), torch.tensor(-src)), op.leg_pair,
                               op.leg_port, (op.vpn_w, op.attach_w), M)
    one = ops.leg_segment_sum(torch.tensor(-src), op.leg_pair, op.leg_port, op.attach_w, M)
    assert np.array_equal(both[1].numpy().view(np.int64), one.numpy().view(np.int64))
    if pad:
        assert np.isnan(both[0][0, 3].item())   # padding legs carry row 0's NaN to port 0


@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
@pytest.mark.parametrize("name", PLANNED)
def test_plan_topology_matches_jax(name, kind):
    jsc, tsc = _scenarios(name)
    jrouting, want = _jax_plan(name, kind)
    got = teng.plan_topology(dataclasses.replace(tsc.topo, policy=kind), tsc.demand,
                             device="cpu")
    _assert_plan_close(got, want)
    for k in ("pair_demand", "port_demand", "n_pairs"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if kind == "reactive":
        ref_ = teng.plan_topology_reference(tsc.topo, tsc.demand,
                                            ttop.optimize_routing(tsc.topo, tsc.demand))
        np.testing.assert_array_equal(got["x"].numpy(), ref_["x"])
        np.testing.assert_array_equal(got["state"].numpy(), ref_["state"])
        np.testing.assert_allclose(got["toggle_cost"].numpy(), ref_["toggle_cost"], rtol=1e-9)


def test_forecast_policy_raises():
    """A spec's "forecast" kind cannot be auto-resolved: plan_topology raises
    the JAX package's ValueError (the policy is built from predictions with
    forecast_gated_policy and passed as policy=)."""
    _, tsc = _scenarios("relay")
    with pytest.raises(ValueError, match="forecast_gated_policy"):
        teng.plan_topology(dataclasses.replace(tsc.topo, policy="forecast"), tsc.demand,
                           device="cpu")


def test_identity_topology_equals_plan_fleet_bit_for_bit():
    """The fleet planner is the identity-routing special case of the
    topology planner, in the port as in the JAX package."""
    sc = tscen.build_fleet_scenario(16, horizon=2000, seed=0)
    topo, plan = ttop.identity_topology(sc.fleet)
    for renew in (False, True):
        got = teng.plan_topology(topo, sc.demand, routing=plan, renew_in_chunks=renew,
                                 device="cpu")
        want = teng.plan_fleet(sc.fleet, sc.demand, renew_in_chunks=renew, device="cpu")
        for k in ("x", "state", "toggle_cost", "static_vpn", "static_cci", "vpn_hourly",
                  "cci_hourly", "pair_demand", "port_demand", "n_pairs"):
            assert torch.equal(got[k], want[k]), k


def _replan_cost(topo, routing, demand):
    """Reactive full replan of ``routing`` on ``topo``, the baseline every
    savings of ``repro.fleet.report.build_topology_report`` compares with."""
    arrays = topo.stack(routing, torch.float64, "cpu")
    out = teng.plan_topology(arrays, demand, policy=reactive_policy(arrays.toggle),
                             hours_per_month=topo.hours_per_month, device="cpu")
    return float(out["toggle_cost"].sum())


def test_relay_and_tree_savings_match_jax():
    """``relay_savings`` and ``tree_sharing_savings`` from port plans, as
    ``build_topology_report`` computes them, equal the JAX report's."""
    jsc, tsc = _scenarios("relay")
    jrouting, jplan = _jax_plan("relay", "reactive")
    want = jrep.build_topology_report(jsc, jplan, jrouting,
                                      include_dedicated_baseline=False).totals
    plan = teng.plan_topology(tsc.topo, tsc.demand, device="cpu")
    one_hop = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=1)
    relay = 1.0 - float(plan["toggle_cost"].sum()) / _replan_cost(tsc.topo, one_hop, tsc.demand)
    assert abs(relay - want["relay_savings"]) <= 1e-9
    assert round(relay, 4) == 0.3785

    jsc, tsc = _scenarios("multicast")
    jrouting, jplan = _jax_plan("multicast", "reactive")
    want = jrep.build_topology_report(jsc, jplan, jrouting,
                                      include_dedicated_baseline=False).totals
    plan = teng.plan_topology(tsc.topo, tsc.demand, device="cpu")
    etopo, row_map = ttop.multicast_unicast_expansion(tsc.topo)
    d_uni = tsc.demand[row_map]
    uni = ttop.optimize_routing(etopo, d_uni, max_hops=1)
    tree = 1.0 - float(plan["toggle_cost"].sum()) / _replan_cost(etopo, uni, d_uni)
    assert abs(tree - want["tree_sharing_savings"]) <= 1e-9
    assert round(tree, 4) == 0.1101


@pytest.mark.parametrize("name,max_hops", [("relay", 1), ("topology-0", None),
                                           ("multicast", 1)])
def test_refine_routing_matches_jax(name, max_hops):
    jsc, tsc = _scenarios(name)
    jstart = jtop.optimize_routing(jsc.topo, jsc.demand, max_hops=max_hops)
    tstart = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=max_hops)
    jplan, jinfo = jtop.refine_routing(jsc.topo, jsc.demand, jstart, max_moves=4)
    tplan, tinfo = ttop.refine_routing(tsc.topo, tsc.demand, tstart, max_moves=4, device="cpu")
    assert tplan.paths == jplan.paths and tplan.n_legs == jplan.n_legs
    assert tinfo["move_mix"] == jinfo["move_mix"]
    assert tinfo["evaluated_moves"] == jinfo["evaluated_moves"]
    assert [m[:3] for m in tinfo["moves"]] == [m[:3] for m in jinfo["moves"]]
    np.testing.assert_allclose([m[3] for m in tinfo["moves"]], [m[3] for m in jinfo["moves"]],
                               rtol=1e-9)
    for k in ("cost_before", "cost_after"):
        assert tinfo[k] == pytest.approx(jinfo[k], rel=1e-9), k
    if name == "relay":
        assert tinfo["move_mix"]["relay"] >= 1 and tinfo["cost_after"] < tinfo["cost_before"]


def test_replay_plan_topology_matches_jax():
    """Direct (1-hop) routing, then the relay from hour 600: the stitched
    plan equals JAX's replay; one segment equals ``plan_topology``."""
    jsc, tsc = _scenarios("relay")
    jdirect = jtop.optimize_routing(jsc.topo, jsc.demand, max_hops=1)
    jrelay = jtop.optimize_routing(jsc.topo, jsc.demand)
    tdirect = ttop.optimize_routing(tsc.topo, tsc.demand, max_hops=1)
    trelay = ttop.optimize_routing(tsc.topo, tsc.demand)
    with jax.enable_x64():
        jarr = jsc.topo.stack(jrelay.pad_to(jrelay.total_hops), jnp.float64)
    want = jeng.replay_plan_topology(jarr, jsc.demand, [(0, jdirect), (600, jrelay)])
    tarr = tsc.topo.stack(trelay, torch.float64, "cpu")
    got = teng.replay_plan_topology(tarr, tsc.demand, [(0, tdirect), (600, trelay)],
                                    device="cpu")
    _assert_plan_close(got, want)
    one = teng.replay_plan_topology(tarr, tsc.demand, [(0, trelay)], device="cpu")
    full = teng.plan_topology(tarr, tsc.demand, device="cpu")
    for k in one:
        assert torch.equal(one[k], full[k]), k
    by_operand = teng.replay_plan_topology(
        tarr, tsc.demand, [(0, tdirect.operand(torch.float64, "cpu")), (600, tarr.routing)],
        device="cpu")
    for k in got:
        assert torch.equal(by_operand[k], got[k]), k
    with pytest.raises(ValueError, match="hour 0"):
        teng.replay_plan_topology(tarr, tsc.demand, [(5, trelay)], device="cpu")


@pytest.mark.parametrize("name", PLANNED)
def test_references_match_jax(name):
    jsc, tsc = _scenarios(name)
    jrouting = jtop.optimize_routing(jsc.topo, jsc.demand)
    trouting = ttop.optimize_routing(tsc.topo, tsc.demand)
    want = jeng.topology_port_costs_reference(jsc.topo, jsc.demand, jrouting)
    got = teng.topology_port_costs_reference(tsc.topo, tsc.demand, trouting)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    want = jeng.plan_topology_reference(jsc.topo, jsc.demand, jrouting, renew_in_chunks=True)
    got = teng.plan_topology_reference(tsc.topo, tsc.demand, trouting, renew_in_chunks=True)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_carried_arrays_plan_like_the_jax_arrays():
    """The JAX package's stacked arrays carried across plan in the port as
    in JAX; ``n_pairs`` is the index's attachment count, on both devices'
    code paths the same host sum."""
    jsc, tsc = _scenarios("multicast")
    jrouting, want = _jax_plan("multicast", "reactive")
    with jax.enable_x64():
        arr = ttop.topology_arrays_from_numpy(
            jax_topology_dict(jsc.topo.stack(jrouting, jnp.float64)), "cpu")
    got = teng.plan_topology(arr, jsc.demand, hours_per_month=jsc.topo.hours_per_month,
                             device="cpu")
    _assert_plan_close(got, want)
    with pytest.raises(ValueError, match="already carry"):
        teng.plan_topology(arr, jsc.demand, routing=jrouting.paths, device="cpu")
    with pytest.raises(ValueError, match="leg index"):
        teng.routed_cost_series(arr._replace(routing=arr.routing._replace(index=None)),
                                jsc.demand, hours_per_month=730, device="cpu")
