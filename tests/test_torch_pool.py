"""The gateway's pools against the JAX package, and the pooled chunk's plain
versions against the scalar ones.

* ``bucket_key_for`` and ``pack_tenant``: the same capacities as JAX's
  (rows, pairs, legs, tiers, prediction columns, ring depth, the doubling
  that reserves a pad port) and the same padded operands, bit for bit.
* Padded FSM rows stay OFF, at zero cost, over a few hundred hours beside
  live neighbours.
* The pooled routing operand is the slots' own padded operands, offset into
  one block-diagonal leg list whose port-major index walks each slot's ports
  through exactly its legs in its leg order, before and after a slot's
  reroute.
* The plain versions with per-row clocks (``ref.stream_chunk_ref`` and
  ``ref.stream_chunk_routed_ref``): one common clock on every row gives the
  scalar call's bits, and distinct clocks across month starts give each
  slot's own scalar call's bits, for the three policies and K in {1, 5, 6,
  24, 25}.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (aliases enable_x64 before repro imports)

from test_torch_cuda import (POOL_KINDS, _same_bits, pooled_bucket, pooled_call, scalar_clock,
                             slot_call, slot_result)

import jax.numpy as jnp
from jax.experimental import enable_x64

from repro.fleet import policy as jpol
from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.runtime import RuntimeConfig as JRuntimeConfig
from repro.fleet.runtime import resolve_runtime_operands as jresolve
from repro.gateway import bucket_key_for as jbucket_key_for
from repro.gateway import pack_tenant as jpack_tenant

from repro_torch.fleet import (
    RuntimeConfig,
    build_fleet_scenario,
    build_relay_scenario,
    build_topology_scenario,
    forecast_gated_policy,
    hysteresis_policy,
    optimize_routing,
    resolve_runtime_operands,
)
from repro_torch.fleet.routing import padded_operand_np
from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec, bucket_key_for, pack_tenant
from repro_torch.gateway.pool import HBUF_FLOOR, ceil_pow2
from repro_torch.kernels import ref

CPU = "cpu"
KS = (1, 5, 6, 24, 25)


def _fields(tree):
    if hasattr(tree, "_asdict"):
        return tree._asdict().items()
    return ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))


def _flat(tree) -> dict:
    """Every leaf of a (nested) NamedTuple or dataclass as a numpy array, by
    path."""
    out = {}
    for name, v in _fields(tree):
        if hasattr(v, "_asdict") or dataclasses.is_dataclass(v):
            out.update({f"{name}.{k}": a for k, a in _flat(v).items()})
        elif v is not None and not isinstance(v, (bool, int, float)):
            out[name] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
    return out


def _tenants():
    """(name, port spec and config, JAX spec and config) of each case: fleet
    tenants of 2, 3 and 5 links, topology tenants of 3 to 6 pairs (one of 4
    pairs on 4 ports, whose padded pairs reserve a pad port by doubling), a
    relay tenant with multi-hop legs, a hysteresis and a replay tenant."""
    out = []
    for n in (2, 3, 5):
        sc, jsc = build_fleet_scenario(n, horizon=48, seed=n), \
            jscen.build_fleet_scenario(n, horizon=48, seed=n)
        out.append((f"fleet{n}", sc.fleet, RuntimeConfig(), jsc.fleet, JRuntimeConfig()))
    for n, nf, pf in ((3, 2, 2), (4, 2, 2), (6, 2, 2), (5, 3, 2)):
        kw = dict(n_facilities=nf, ports_per_facility=pf, horizon=48, seed=n)
        sc, jsc = build_topology_scenario(n, **kw), jscen.build_topology_scenario(n, **kw)
        r, jr = optimize_routing(sc.topo, sc.demand), jtop.optimize_routing(jsc.topo, jsc.demand)
        out.append((f"topo{n}", sc.topo, RuntimeConfig(routing=r), jsc.topo,
                    JRuntimeConfig(routing=jr)))
    from repro.fleet import scenario as jsc_mod

    sc, jsc = build_relay_scenario(horizon=48), jsc_mod.build_relay_scenario(horizon=48)
    r, jr = optimize_routing(sc.topo, sc.demand), jtop.optimize_routing(jsc.topo, jsc.demand)
    assert r.hop_depth > 1 and r.paths == jr.paths
    out.append(("relay", sc.topo, RuntimeConfig(routing=r), jsc.topo, JRuntimeConfig(routing=jr)))
    sc, jsc = build_fleet_scenario(3, horizon=48, seed=9), jscen.build_fleet_scenario(
        3, horizon=48, seed=9)
    tog = sc.fleet.stack(torch.float64, CPU).toggle
    with enable_x64():
        jtog = jsc.fleet.stack(jnp.float64).toggle
        out.append(("hysteresis", sc.fleet,
                    RuntimeConfig(policy=hysteresis_policy(tog, up_hold=2, down_hold=3)),
                    jsc.fleet, JRuntimeConfig(policy=jpol.hysteresis_policy(
                        jtog, up_hold=2, down_hold=3))))
        rng = np.random.default_rng(0)
        pred, coef = rng.uniform(0, 100, (3, 77)), rng.uniform(0.2, 1.0, (3, 4))
        out.append(("replay", sc.fleet, RuntimeConfig(policy=forecast_gated_policy(
            tog, pred, margin=0.05, cost_coef=coef)), jsc.fleet, JRuntimeConfig(
            policy=jpol.forecast_gated_policy(jtog, jnp.asarray(pred), margin=0.05,
                                              cost_coef=jnp.asarray(coef)))))
    return out


@functools.lru_cache(maxsize=None)
def _cases():
    return _tenants()


@pytest.mark.parametrize("i", range(10))
def test_bucket_key_and_pack_match_jax(i):
    name, spec, cfg, jspec, jcfg = _cases()[i]
    res = resolve_runtime_operands(spec, cfg, CPU)
    key = bucket_key_for(res)
    with enable_x64():
        jres = jresolve(jspec, jcfg)
        jkey = jbucket_key_for(jres)
        jpk = jpack_tenant(jres, jkey)
    for f in ("topology", "rows_cap", "pairs_cap", "legs_cap", "n_tiers", "pred_source",
              "pred_cap", "hbuf_cap"):
        assert getattr(key, f) == getattr(jkey, f), (name, f)
    assert key.policy_class.__name__ == type(jres.policy).__name__
    assert key.hbuf_cap >= HBUF_FLOOR and key.rows_cap == ceil_pow2(key.rows_cap)
    pk = pack_tenant(res, key)
    assert (pk.n_rows, pk.n_pairs, pk.hours_per_month) == (jpk.n_rows, jpk.n_pairs,
                                                             jpk.hours_per_month)
    np.testing.assert_array_equal(pk.h_np, jpk.h_np)
    got, want = _flat(pk.arrays), _flat(jpk.arrays)
    want.pop("routing", None)   # JAX keeps a (1, 1) dummy; the port none
    assert set(got) == set(want), name
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name}:{f}")
    got, want = _flat(pk.policy), _flat(jpk.policy)
    assert set(got) == set(want), name
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name}:{f}")
    if key.topology:
        for f in ("leg_pair", "leg_port", "vpn_w", "attach_w", "primary"):
            np.testing.assert_array_equal(getattr(pk.routing, f), getattr(jpk.routing, f),
                                          err_msg=f"{name}:{f}")
    else:
        assert pk.routing is None and jpk.routing is None


def test_pad_port_is_reserved_when_pairs_pad():
    """Padded pairs route to a pad port: when the pairs pad and the ports do
    not (3 or 6 pairs on 4 ports), rows_cap doubles; 5 pairs on 6 ports pad
    both and keep rows_cap 8."""
    for name, spec, cfg, _, _ in _cases():
        res = resolve_runtime_operands(spec, cfg, CPU)
        if not res.topology:
            continue
        key = bucket_key_for(res)
        m, p = res.arrays.n_ports, res.arrays.n_pairs
        double = ceil_pow2(p) > p and ceil_pow2(m) == m
        assert key.rows_cap == ceil_pow2(m) * (2 if double else 1), name
        pk = pack_tenant(res, key)
        assert (pk.routing.primary[p:] == key.rows_cap - 1).all()
        assert key.rows_cap - 1 >= m or p == key.pairs_cap, name


def test_padded_rows_stay_off_beside_live_neighbours():
    """Three tenants of 3, 5 and 6 links in 4- and 8-row buckets: over 300
    hours the padded rows' FSMs never leave OFF, cost nothing and keep zero
    prefixes, while the real rows toggle."""
    gw = FleetGateway(GatewayConfig(slots_per_bucket=3, cadence=50), device=CPU)
    for n, seed in ((3, 0), (5, 1), (6, 2), (5, 3)):
        sc = build_fleet_scenario(n, horizon=300, seed=seed)
        gw.join(f"t{seed}", TenantSpec(spec=sc.fleet, demand=sc.demand))
    toggled = 0
    for _ in range(300):
        gw.tick(collect=False)
        for b in gw._live_buckets():
            M = b.key.rows_cap
            pad = np.concatenate([np.arange(s * M + int(b.m[s]), (s + 1) * M)
                                  for s in range(b.n_slots) if b.alive[s]])
            real = np.concatenate([np.arange(s * M, s * M + int(b.m[s]))
                                   for s in range(b.n_slots) if b.alive[s]])
            fsm = b.fsm.numpy()
            assert (fsm[0, pad] == 0).all() and (fsm[2:, pad] == 0).all()   # OFF, no trigger
            assert (b.pref.numpy()[:, pad] == 0).all()
            toggled += int((fsm[0, real] != 0).sum())
            for s in range(b.n_slots):
                if b.alive[s]:
                    assert (b.bill_real[s, int(b.m[s]):] == 0).all()
    assert toggled > 0
    assert gw.check() == []


def test_block_diagonal_routing_operand_before_and_after_a_reroute():
    """The pooled operand is each slot's padded operand offset by s·pairs_cap
    and s·rows_cap; its port-major index walks each real port's legs, its
    tenant's and no other, in leg order; a slot's reroute rewrites that slot
    alone."""
    gw = FleetGateway(GatewayConfig(slots_per_bucket=3, obs=False), device=CPU)
    plans = {}
    for seed in range(3):
        sc = build_topology_scenario(6, n_facilities=2, ports_per_facility=2, horizon=48,
                                     seed=seed)
        plans[seed] = (sc, optimize_routing(sc.topo, sc.demand))
        gw.join(f"t{seed}", TenantSpec(spec=sc.topo, demand=sc.demand,
                                       config=RuntimeConfig(routing=plans[seed][1])))
    (b,) = gw._live_buckets()
    key = b.key

    def check():
        r, idx = b.routing, b.routing.index
        start = idx.start.numpy()
        for name in b.slots:
            s = b.slots.index(name)
            plan = plans[int(name[1:])][1]
            op = padded_operand_np(plan, n_legs=key.legs_cap, n_rows=key.pairs_cap,
                                   pad_pair=key.pairs_cap - 1, pad_port=key.rows_cap - 1)
            E, P, M = key.legs_cap, key.pairs_cap, key.rows_cap
            cut = slice(s * E, (s + 1) * E)
            np.testing.assert_array_equal(r.leg_pair[cut].numpy(), op.leg_pair + s * P)
            np.testing.assert_array_equal(r.leg_port[cut].numpy(), op.leg_port + s * M)
            np.testing.assert_array_equal(r.vpn_w[cut].numpy(), op.vpn_w)
            np.testing.assert_array_equal(r.attach_w[cut].numpy(), op.attach_w)
            for m in range(M):
                run = idx.order.numpy()[start[s * M + m]:start[s * M + m + 1]]
                want = np.flatnonzero(op.leg_port == m) + s * E
                np.testing.assert_array_equal(run, want)
            assert gw.sync_groups(name) == [int(g) for g in plan.primary]

    check()
    sc, plan = plans[1]
    idx = plan.primary.copy()
    for i, pr in enumerate(sc.topo.pairs):
        others = [c for c in pr.candidates if c != idx[i]]
        if others:
            idx[i] = others[0]
    plans[1] = (sc, sc.topo.plan(idx))
    gw.reroute("t1", plans[1][1])
    check()


@functools.lru_cache(maxsize=None)
def _bucket(topology, kind, staggered):
    return pooled_bucket(topology, kind, CPU, staggered=staggered)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("kind", POOL_KINDS)
@pytest.mark.parametrize("topology", [False, True], ids=["fleet", "routed"])
def test_plain_pooled_chunk_equals_scalar_calls(topology, kind, K):
    """Per-row clocks in the plain versions: one common clock gives the
    scalar call's bits; the slots' own clocks (month starts inside the
    chunk, replay columns past a slot's T_pred) give each slot's own scalar
    call's bits."""
    plain = ref.stream_chunk_routed_ref if topology else ref.stream_chunk_ref
    gw, b = _bucket(topology, kind, False)
    args, kw = pooled_call(gw, b, K)
    got, got_fsm = plain(*args, **kw)
    sargs, skw = scalar_clock(args, kw)
    want, want_fsm = plain(*sargs, **skw)
    assert _same_bits(got, want) and _same_bits(got_fsm, want_fsm)
    gw, b = _bucket(topology, kind, True)
    args, kw = pooled_call(gw, b, K)
    clocks = b.t.copy()
    assert len(set(clocks.tolist())) == b.n_slots and len(set(b.hpm.tolist())) > 1
    got, got_fsm = plain(*args, **kw)
    for s in range(b.n_slots):
        one, kw1 = slot_call(args, kw, s, b)
        want, want_fsm = plain(*one, **kw1)
        g, gf = slot_result(got, got_fsm, s, b, K)
        assert _same_bits(g, want) and _same_bits(gf, want_fsm), s
