"""The routed chunk's launch form, chosen on the host once per routing.

``stream_chunk_routed`` has two launch forms on the card: the port-block
form (a 512-thread block a port, for few busy ports) and the small-port form
(a warp a port, several ports a block, for many ports of few legs: the
gateway's large topology buckets). The routing's hottest port is counted
where the port-major leg index is built on the host (``RoutingPlan.operand``,
``index_legs``) and kept on the ``LegIndex``; the wrapper chooses the form
from it, the port count and the call's shape without touching the device.
These tests hold that choice on the shapes the port streams:

* the smoke's gateway bucket (256 tenants of 32 pairs on 8 ports, 2048
  ports of at most 12 legs) takes the small-port form; a 4-slot bucket of
  the same tenants (32 ports) and the standalone 2048-pair stream on 128
  ports (a port of ~100 legs) the port-block form;
* one port above the rule's leg cap switches the whole routing;
* a call whose small-port launch would not fit the shared memory takes the
  port-block form;
* the hottest port survives ``.to()`` of the index and of the operand;
* the wrapper's private ``form=`` refuses unknown names, a forced small-port
  form above the kernel's leg cap, past its shared memory and in live mode,
  before anything is built;
* the constants the wrapper sizes the launch with are the kernel's;
* on the smoke's bucket the pooled plain version (the CPU gateway) equals
  JAX's gateway at ``tests/test_torch_gateway.py``'s tolerances: decisions
  exact, costs ``rtol=1e-12``.

Both forms are held to the plain version bit for bit on the card by
``tests/test_torch_cuda.py -k routed``.
"""
import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (aliases enable_x64 before repro imports)

from repro.fleet import scenario as jscen
from repro.fleet import topology as jtop
from repro.fleet.runtime import RuntimeConfig as JRuntimeConfig
from repro.gateway import FleetGateway as JFleetGateway
from repro.gateway import GatewayConfig as JGatewayConfig
from repro.gateway import TenantSpec as JTenantSpec

from _routed_cases import synthetic_chunk, synthetic_routing
from repro_torch.fleet import RuntimeConfig, build_topology_scenario, optimize_routing
from repro_torch.fleet.routing import LegIndex, RoutingPlan, index_legs
from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec
from repro_torch.kernels import ops
from repro_torch.kernels.stream_chunk import (ROUTED_TILE, SMALL_PORT_LEGS_BELOW,
                                              SMALL_PORT_MAX_LEGS, SMALL_PORT_MAX_SMEM,
                                              SMALL_PORT_MIN_PORTS, SMALL_PORT_WIDE_PORTS,
                                              SMALL_PORTS, routed_form, routed_launch_form,
                                              small_port_fits, small_port_geometry,
                                              stream_chunk_routed)

CPU = "cpu"
#: chip_smoke.py's gateway bucket: tenants of 32 pairs on 8 ports.
GW_TENANTS, GW_PAIRS, GW_KW = 256, 32, dict(n_facilities=4, ports_per_facility=2, horizon=720)
STEP_FIELDS = ("x", "state", "r_vpn", "r_cci", "vpn_cost", "cci_cost", "cost")
EXACT = ("x", "state")


def _tenant_scale(i: int) -> float:
    return 1.0 + 0.01 * (i % 97)


def _gateway(n_slots: int):
    """The smoke's gateway bucket on the CPU: ``n_slots`` tenants of one
    32-pair, 8-port topology, joined at once, observability off."""
    sc = build_topology_scenario(GW_PAIRS, seed=0, **GW_KW)
    plan = optimize_routing(sc.topo, sc.demand)
    gw = FleetGateway(GatewayConfig(slots_per_bucket=n_slots, queue_limit=n_slots,
                                    obs=False), device=CPU)
    for i in range(n_slots):
        gw.join(f"t{i}", TenantSpec(spec=sc.topo, demand=sc.demand * _tenant_scale(i),
                                    config=RuntimeConfig(routing=plan)))
    (b,) = gw._live_buckets()
    return gw, b


@pytest.fixture(scope="module")
def gateway_bucket():
    return _gateway(GW_TENANTS)


def test_gateway_bucket_takes_the_small_port_form(gateway_bucket):
    """2048 ports of 0-12 legs: the small-port form, from the hottest port
    the bucket's block-diagonal routing counted on the host; its launch (8
    port warps a block) fits two blocks an SM by shared memory, so the
    bucket's 256 blocks are resident on 132 SMs at once."""
    _, b = gateway_bucket
    idx = b.routing.index
    legs = np.diff(idx.start.numpy())
    P, Kt = b.routing.n_rows, b.key.n_tiers
    assert idx.n_ports == GW_TENANTS * b.key.rows_cap == 2048
    assert idx.max_legs == legs.max() == 12
    assert set(legs.tolist()) == {0, 1, 2, 3, 4, 6, 12}
    assert routed_form(idx.max_legs, idx.n_ports) == "small_port"
    for K in (1, 24, 25, 40):
        assert routed_launch_form(idx, P, K, Kt, False) == "small_port"
    geo = small_port_geometry(P, idx.n_ports, 24, Kt, False, idx.max_legs)
    assert (geo["blocks"], geo["threads"], geo["rows"]) == (256, 256, 16)
    assert 2 * (geo["smem"] + 1024) <= 228 * 1024
    assert geo["blocks"] <= 2 * 132


def test_small_gateway_bucket_takes_the_port_block_form():
    """The smoke's mixed gateway holds 4 such tenants a bucket: 32 ports,
    below the rule's port floor, where one port block an SM runs them in
    one wave; the port-block form."""
    _, b = _gateway(4)
    idx = b.routing.index
    assert idx.n_ports == 32 < SMALL_PORT_MIN_PORTS
    assert routed_launch_form(idx, b.routing.n_rows, 24, b.key.n_tiers, False) == "port_block"


def test_standalone_topology_takes_the_port_block_form():
    """The smoke's standalone topology stream, 2048 pairs on 128 ports: its
    hottest port holds ~100 legs, past the rule's cap, so the port-block form;
    a live call takes it whatever the routing."""
    sc = build_topology_scenario(2048, n_facilities=32, ports_per_facility=4, reach=2,
                                 horizon=48, seed=0)
    op = optimize_routing(sc.topo, sc.demand).operand(device=CPU)
    idx = op.index
    assert idx.n_ports == 128 and idx.max_legs > SMALL_PORT_MAX_LEGS
    assert idx.max_legs == int(np.diff(idx.start.numpy()).max())
    assert routed_launch_form(idx, 2048, 24, 4, False) == "port_block"
    small = synthetic_routing([3, 1, 0] * SMALL_PORT_MIN_PORTS, 8, seed=0).index
    assert routed_launch_form(small, 8, 24, 4, False) == "small_port"
    assert routed_launch_form(small, 8, 24, 4, False, live=True) == "port_block"


@pytest.mark.parametrize("built_by", ["operand", "index_legs"])
@pytest.mark.parametrize("n_ports,cap", [(SMALL_PORT_MIN_PORTS, SMALL_PORT_LEGS_BELOW),
                                         (SMALL_PORT_WIDE_PORTS, SMALL_PORT_MAX_LEGS)])
def test_one_port_above_the_cap_switches_the_whole_routing(built_by, n_ports, cap):
    """At most the rule's cap of legs on every port: the small-port form; one
    more leg on one port: the port-block form for the whole routing, built
    by ``RoutingPlan.operand`` or by ``index_legs`` on a bare operand, at the
    port floor (a cap of 16 legs) and from 384 ports on (32)."""
    M = n_ports

    def form(hot_legs):
        ports = [0] * hot_legs + list(range(1, M))
        plan = RoutingPlan.from_indices(ports, M)
        op = plan.operand(device=CPU)
        if built_by == "index_legs":
            op = index_legs(op._replace(index=None), M)
        assert op.index.max_legs == hot_legs
        return routed_launch_form(op.index, len(ports), 24, 4, False)

    assert form(cap) == "small_port"
    assert form(cap + 1) == "port_block"


@pytest.mark.parametrize("max_legs,n_ports,want", [
    (0, 2048, "small_port"), (12, 2048, "small_port"),
    (SMALL_PORT_MAX_LEGS, SMALL_PORT_WIDE_PORTS, "small_port"),
    (SMALL_PORT_MAX_LEGS + 1, SMALL_PORT_WIDE_PORTS, "port_block"),
    (SMALL_PORT_MAX_LEGS, SMALL_PORT_WIDE_PORTS - 1, "port_block"),
    (SMALL_PORT_LEGS_BELOW, SMALL_PORT_WIDE_PORTS - 1, "small_port"),
    (SMALL_PORT_LEGS_BELOW, SMALL_PORT_MIN_PORTS, "small_port"),
    (SMALL_PORT_LEGS_BELOW + 1, SMALL_PORT_MIN_PORTS, "port_block"),
    (SMALL_PORT_LEGS_BELOW, SMALL_PORT_MIN_PORTS - 1, "port_block"),
    (4, 32, "port_block"), (113, 128, "port_block"),
    (-1, 2048, "port_block"), (4, 0, "port_block"),
])
def test_routed_form_rule(max_legs, n_ports, want):
    """The rule on its edges: the port floor (133: one port block more than
    the card's 132 SMs), the leg cap below and from 384 ports, an unknown
    hottest port (-1) and no ports."""
    assert routed_form(max_legs, n_ports) == want


@pytest.mark.parametrize("legs,pairs_a_port,Kt", [(15, 17, 4), (SMALL_PORT_LEGS_BELOW, 16, 4),
                                                  (9, 23, 8)])
def test_shared_memory_over_the_limit_takes_the_port_block_form(legs, pairs_a_port, Kt):
    """A port's rows fill at 32 when it holds 16 or more pairs: with CCI demand
    (a third plane), K >= 32 (a 33-double stride) and 4 tiers a hottest port
    of 15 legs takes more shared memory a block than the card gives
    (8 x 3637 doubles > 227 KB), with 8 tiers one of 9 legs. The rule alone
    takes the small-port form there; the wrapper takes the port-block form,
    and a forced small-port form raises. Without CCI demand, or at K = 24,
    the same routing fits and takes the small-port form."""
    M = 256
    P = pairs_a_port * M
    r = synthetic_routing([legs] + [3] * (M - 1), P, seed=4)
    idx = r.index
    assert routed_form(idx.max_legs, M) == "small_port"
    for K in (32, 40):
        geo = small_port_geometry(P, M, K, Kt, True, legs)
        assert geo["rows"] == 32 and geo["smem"] > SMALL_PORT_MAX_SMEM
        assert not small_port_fits(idx, P, K, Kt, True)
        assert routed_launch_form(idx, P, K, Kt, True) == "port_block"
        with pytest.raises(ValueError, match="bytes of shared memory"):
            routed_launch_form(idx, P, K, Kt, True, form="small_port")
        assert routed_launch_form(idx, P, K, Kt, False) == "small_port"
    assert routed_launch_form(idx, P, 24, Kt, True) == "small_port"


def test_small_port_constants_match_the_source():
    """The wrapper sizes the small-port launch with the kernel's constants:
    its legs a port, ports a block, shared memory limit and hour tile."""
    import re
    from pathlib import Path

    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" /
           "stream_chunk_routed.cu").read_text()

    def const(name):
        (expr,) = re.findall(rf"constexpr int {name} = ([0-9* ]+);", src)
        return int(np.prod([int(v) for v in expr.split("*")]))

    assert const("kSmallLegs") == SMALL_PORT_MAX_LEGS
    assert const("kSmallPorts") == SMALL_PORTS
    assert const("kMaxSmem") == SMALL_PORT_MAX_SMEM
    assert const("kTile") == ROUTED_TILE


def test_the_hottest_port_survives_to():
    """The index's hottest port rides through ``LegIndex.to`` and
    ``RoutingOperand.to``; an index built without it keeps -1, and the
    wrapper then takes the port-block form."""
    op = synthetic_routing([5, 0, 12, 3] * (SMALL_PORT_WIDE_PORTS // 4), 16, pad_legs=2, seed=3)
    assert routed_launch_form(op.index, 16, 24, 4, False) == "small_port"
    for moved in (op.index.to(CPU), op.index.to(torch.device(CPU)), op.to(CPU).index):
        assert moved.max_legs == 12
        assert torch.equal(moved.start, op.index.start)
    bare = LegIndex(order=op.index.order, start=op.index.start, n_attach=op.index.n_attach)
    moved = bare.to(CPU)
    assert (moved.max_legs, moved.leg_pair_pm) == (-1, None)
    with_legs = moved._replace(leg_pair_pm=op.index.leg_pair_pm)
    assert routed_launch_form(with_legs, 16, 24, 4, False) == "port_block"


def test_form_argument_is_checked_before_anything_is_built():
    """``form=`` takes "auto", "port_block" or "small_port": an unknown name,
    a forced small-port form on a routing whose hottest port holds more legs
    than a warp has lanes, or in live mode, raises before the operands'
    devices are looked at; a valid form on CPU operands reaches the CUDA
    check."""
    r = synthetic_routing([4, 2, 0, 7], 12, seed=1)
    args, kw = synthetic_chunk(r, 12, 24, seed=1)
    with pytest.raises(ValueError, match="form 'bogus'"):
        stream_chunk_routed(*args, **kw, form="bogus")
    for form in ("auto", "port_block", "small_port"):
        with pytest.raises(ValueError, match="CUDA"):
            stream_chunk_routed(*args, **kw, form=form)
    hot = synthetic_routing([SMALL_PORT_MAX_LEGS + 1, 2], SMALL_PORT_MAX_LEGS + 4, seed=2)
    assert routed_launch_form(hot.index, SMALL_PORT_MAX_LEGS + 4, 24, 4, False) == "port_block"
    hargs, hkw = synthetic_chunk(hot, SMALL_PORT_MAX_LEGS + 4, 24, seed=2)
    with pytest.raises(ValueError, match="holds 33 legs"):
        stream_chunk_routed(*hargs, **hkw, form="small_port")
    with pytest.raises(ValueError, match="no live instance"):
        routed_launch_form(r.index, 12, 24, 4, False, "small_port", live=True)
    with pytest.raises(ValueError, match="holds -1 legs"):
        routed_launch_form(r.index._replace(max_legs=-1), 12, 24, 4, False, "small_port")
    assert routed_launch_form(hot.index, 36, 24, 4, False, "port_block") == "port_block"
    assert routed_launch_form(r.index, 12, 24, 4, False, "port_block") == "port_block"


def test_small_port_geometry_rows_and_slice():
    """The small-port launch's rows hold the hottest port's legs and as much
    of a port's slice of the calendars as makes 32; a longer slice is walked
    apart. Its shared memory grows with the rows and the hour tile only."""
    g = small_port_geometry(36, 4, 24, 4, False, 31)            # slice of 9 pairs
    assert g["rows"] == SMALL_PORT_MAX_LEGS
    g1 = small_port_geometry(8192, 2048, 1, 4, False, 12)
    g24 = small_port_geometry(8192, 2048, 24, 4, False, 12)
    g40 = small_port_geometry(8192, 2048, 40, 4, False, 12)
    assert g1["rows"] == g24["rows"] == 16
    assert g1["smem"] < g24["smem"] < g40["smem"]
    assert small_port_geometry(8192, 2048, 24, 4, True, 12)["smem"] > g24["smem"]
    assert g24["threads"] == 32 * SMALL_PORTS == 256 and g24["blocks"] == 2048 // SMALL_PORTS


def test_the_cpu_runs_the_plain_version_whatever_the_form(gateway_bucket):
    """On the CPU the gateway's routed bucket runs the plain version: no
    kernel launch is counted, the small-port form's among them."""
    gw, _ = gateway_bucket
    before = dict(ops.LAUNCHES)
    gw.tick(collect=False)
    assert ops.LAUNCHES == before


def test_pooled_plain_on_the_smoke_bucket_equals_jax():
    """The smoke's bucket (256 tenants x 32 pairs on 8 ports) through the
    port's CPU gateway and JAX's: three ticks and a chunk of 24 hours, every
    tenant's decisions equal and costs at rtol=1e-12."""
    sc = build_topology_scenario(GW_PAIRS, seed=0, **GW_KW)
    jsc = jscen.build_topology_scenario(GW_PAIRS, seed=0, **GW_KW)
    plan, jplan = optimize_routing(sc.topo, sc.demand), jtop.optimize_routing(jsc.topo,
                                                                              jsc.demand)
    assert plan.paths == jplan.paths
    cfg = dict(slots_per_bucket=GW_TENANTS, queue_limit=GW_TENANTS, obs=False)
    gw, jgw = FleetGateway(GatewayConfig(**cfg), device=CPU), JFleetGateway(JGatewayConfig(**cfg))
    for i in range(GW_TENANTS):
        s = _tenant_scale(i)
        gw.join(f"t{i}", TenantSpec(spec=sc.topo, demand=sc.demand * s,
                                    config=RuntimeConfig(routing=plan)))
        jgw.join(f"t{i}", JTenantSpec(spec=jsc.topo, demand=jsc.demand * s,
                                      config=JRuntimeConfig(routing=jplan)))
    (b,) = gw._live_buckets()
    assert routed_form(b.routing.index.max_legs, b.routing.index.n_ports) == "small_port"
    steps = [(gw.tick(), jgw.tick()) for _ in range(3)] + [(gw.tick_many(24), jgw.tick_many(24))]
    for t, (got, want) in enumerate(steps):
        assert got.keys() == want.keys()
        for name in got:
            for f in STEP_FIELDS:
                g, w = np.asarray(got[name][f]), np.asarray(want[name][f])
                if f in EXACT:
                    np.testing.assert_array_equal(g, w, err_msg=f"{name}@{t}:{f}")
                else:
                    np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                               err_msg=f"{name}@{t}:{f}")
