"""Port vs JAX package for the plain versions of the fleet path's kernels
(the CUDA kernels themselves are tested in ``tests/test_torch_cuda.py``).

On the CPU the dispatcher runs the plain PyTorch versions; they are held
against the JAX kernels and oracles on the same seeded inputs:

* tiered pricing, float32: against the Pallas kernel in interpret mode at
  ``rtol=1e-6, atol=1e-6`` (the tolerance ``tests/test_kernels.py`` holds
  the Pallas kernel to); float64: bit for bit against the JAX oracle;
* FSM scan: against ``policy_scan`` vmapped over rows — ``x``/``state``
  equal, ``total_cost`` at ``rtol=1e-12`` (XLA sums in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_support import CPU, guard_rows, seeded_costs, seeded_tiers, seeded_toggle

import jax
import jax.numpy as jnp

from repro.core.togglecci import ToggleParams as JToggleParams
from repro.fleet import policy as jpol
from repro.kernels.tiered_cost import tiered_cost_batched, tiered_cost_batched_ref

from repro_torch.core.togglecci import ToggleParams
from repro_torch.fleet import policy as tpol
from repro_torch.kernels import ops


def _t(a, device=CPU):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def test_tiered_plain_f32_matches_pallas_interpret():
    args = seeded_tiers(5, 8, 512, np.float32)
    want = np.asarray(tiered_cost_batched(*(jnp.asarray(a) for a in args),
                                          block_t=128, interpret=True))
    got = ops.tiered_cost_batched(*(_t(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_tiered_plain_f64_bit_equal_to_jax_oracle():
    args = seeded_tiers(6, 8, 700)
    with jax.enable_x64():
        want = np.asarray(tiered_cost_batched_ref(*(jnp.asarray(a) for a in args)))
    got = ops.tiered_cost_batched(*(_t(a) for a in args)).numpy()
    assert np.array_equal(got, want)


def _holds(n):
    return np.resize(np.array([1, 2, 3, 6], np.int32), n)


def _jax_scan(kind, tog, vpn, cci, renew):
    with jax.enable_x64():
        tp = JToggleParams(**{k: jnp.asarray(v) for k, v in tog.items()})
        if kind == "reactive":
            pol = jpol.reactive_policy(tp, renew_in_chunks=renew)
        else:
            h = jnp.asarray(_holds(len(tog["h"])))
            pol = jpol.HysteresisPolicy(toggle=tp, up_hold=h, down_hold=h[::-1],
                                        renew_in_chunks=renew)
        out = jax.vmap(lambda p, v, c: jpol.policy_scan(p, v, c))(
            pol, jnp.asarray(vpn), jnp.asarray(cci))
        return {k: np.asarray(out[k]) for k in ("x", "state", "total_cost")}


def _port_policy(kind, tog, renew, device=CPU):
    tp = ToggleParams(**{k: _t(v, device) for k, v in tog.items()})
    if kind == "reactive":
        return tpol.reactive_policy(tp, renew_in_chunks=renew)
    h = _t(_holds(len(tog["h"])), device)
    return tpol.HysteresisPolicy(tp, h, h.flip(0).contiguous(), renew)


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
def test_fsm_plain_matches_jax_policy_scan(kind, renew):
    vpn, cci = seeded_costs(7, 10, 1200)
    tog = seeded_toggle(7, 10)
    want = _jax_scan(kind, tog, vpn, cci, renew)
    got = tpol.policy_scan(_port_policy(kind, tog, renew), _t(vpn), _t(cci))
    assert want["x"].sum() > 0 and (want["x"] == 0).any()   # the rows do toggle
    np.testing.assert_array_equal(got["x"].numpy(), want["x"])
    np.testing.assert_array_equal(got["state"].numpy(), want["state"])
    np.testing.assert_allclose(got["total_cost"].numpy(), want["total_cost"], rtol=1e-12)


# ---------------------------------------------------------------------------
# Chunked pricing (tiered_cost_scan) and the chunked FSM (fsm_chunk)
# ---------------------------------------------------------------------------


def _scan_inputs(K, dtype=np.float32):
    """The inputs of tests/test_kernels.py::test_tiered_cost_scan_matches_ref
    (same seed, shapes and billing-month boundary mid-chunk)."""
    rng = np.random.default_rng(11)
    N, Kt = 16, 4
    cum0 = rng.uniform(0, 5e4, N)
    d = rng.uniform(0, 200, (N, K))
    b = np.sort(rng.uniform(1e3, 2e5, (N, Kt)), axis=1)
    b[:, -1] = 1e30
    rates = rng.uniform(0.01, 0.2, (N, Kt))
    reset = np.zeros(K, np.int32)
    reset[K // 2] = 1
    cast = lambda a: np.asarray(a, dtype)
    return cast(cum0), cast(d), cast(b), cast(rates), reset


@pytest.mark.parametrize("K", [1, 7, 24])
def test_tiered_scan_plain_f32_matches_pallas_interpret(K):
    from repro.kernels.tiered_cost import tiered_cost_scan, tiered_cost_scan_ref

    args = _scan_inputs(K)
    jargs = [jnp.asarray(a) for a in args]
    want, cum_want = tiered_cost_scan(*jargs, interpret=True)
    got, cum_got = ops.tiered_cost_scan(*(_t(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (16, K)
    # The tolerances tests/test_kernels.py holds the Pallas kernel to.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cum_got.numpy(), np.asarray(cum_want), rtol=1e-6)
    # Against the XLA oracle of the same precision: the same-precision twin
    # tolerance of tests/test_kernels.py.
    ref_c, ref_cum = tiered_cost_scan_ref(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_c), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(cum_got.numpy(), np.asarray(ref_cum), rtol=1e-6)


@pytest.mark.parametrize("K", [1, 7, 24])
def test_tiered_scan_plain_f64_bit_equal_to_jax_oracle(K):
    from repro.kernels.tiered_cost import tiered_cost_scan_ref

    args = _scan_inputs(K, np.float64)
    with jax.enable_x64():
        want, cum_want = tiered_cost_scan_ref(*(jnp.asarray(a) for a in args))
        want, cum_want = np.asarray(want), np.asarray(cum_want)
    got, cum_got = ops.tiered_cost_scan(*(_t(a) for a in args))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(cum_got.numpy(), cum_want)
    if K > 1:  # two chained half-chunks are the whole chunk, bit for bit
        cum0, d, b, r, reset = (_t(a) for a in args)
        h = K // 2
        cA, cumA = ops.tiered_cost_scan(cum0, d[:, :h], b, r, reset[:h])
        cB, cumB = ops.tiered_cost_scan(cumA, d[:, h:], b, r, reset[h:])
        assert torch.equal(torch.cat([cA, cB], dim=1), got)
        assert torch.equal(cumB, cum_got)


def test_tiered_calendar_plain_chains_to_the_offline_pricing():
    """The runtime's calendar form over chained chunks (boundaries inside
    chunks and on chunk edges) equals the offline pricing, monthly_cumsum
    then the tier fold, bit for bit: on the CPU both prefixes are sequential."""
    from repro_torch.core.costmodel import monthly_cumsum, tiered_marginal_cost_tables

    cum, d, b, r = seeded_tiers(5, 6, 300)
    d, b, r = _t(d), _t(b), _t(r)
    hpm = 48
    want = tiered_marginal_cost_tables(monthly_cumsum(d, hpm), d, b, r)
    carry = torch.zeros((2, 6), dtype=torch.float64)
    got, t0 = [], 0
    for K in (1, 7, 24, 40, 48, 13, 100, 67):
        c, carry = ops.tiered_cost_calendar(carry, d[:, t0:t0 + K].T.contiguous(), b, r,
                                            t0, hpm)
        assert c.shape == (K, 6)
        got.append(c.T)
        t0 += K
    assert t0 == 300
    assert torch.equal(torch.cat(got, dim=1), want)
    full = torch.cat([torch.zeros((6, 1), dtype=torch.float64), torch.cumsum(d, 1)], 1)
    assert torch.equal(carry[0], full[:, 300])
    assert torch.equal(carry[1], full[:, 288])       # the last month start


def _pre_reads(pref, t0, K, h):
    """The host ring reads of the runtime: pref[max(0, t0 + k - h)]."""
    lo = np.maximum(0, t0 + np.arange(K)[:, None] - h[None, :])     # (K, M)
    return np.take_along_axis(pref, np.minimum(lo, pref.shape[0] - 1), axis=0)


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
def test_fsm_chunk_plain_chains_to_fsm_scan(kind, renew):
    """fsm_chunk over chained chunks of the horizon (the snapshot/ring split
    of the window reads included) equals fsm_scan over the whole horizon:
    x/state exact, and the window sums equal the offline ones bit for bit."""
    from repro_torch.core.togglecci import window_sums

    vpn, cci = seeded_costs(7, 10, 700)
    tog = seeded_toggle(7, 10)
    pol = _port_policy(kind, tog, renew)
    want = tpol.policy_scan(pol, _t(vpn), _t(cci))
    pref_v = np.concatenate([np.zeros((1, 10)), np.cumsum(vpn.T, axis=0)])  # (T+1, M)
    pref_c = np.concatenate([np.zeros((1, 10)), np.cumsum(cci.T, axis=0)])
    tp = pol.toggle
    carry, pref = tpol.fsm_carry(pol), torch.zeros((2, 10), dtype=torch.float64)
    xs, states, rvs, t0 = [], [], [], 0
    for K in (24, 1, 7, 72, 100, 96, 200, 200):
        sl = slice(t0, t0 + K)
        out = ops.fsm_chunk(
            _t(vpn[:, sl].T), _t(cci[:, sl].T),
            _t(_pre_reads(pref_v, t0, K, tog["h"])), _t(_pre_reads(pref_c, t0, K, tog["h"])),
            tp.theta1, tp.theta2, tp.h, tp.D, tp.T_cci, *pol.holds(), carry, pref, t0,
            renew_in_chunks=renew)
        carry, pref = out["carry"], out["pref"]
        assert torch.equal(out["snap_v"], _t(pref_v[sl]))
        xs.append(out["x"].T)
        states.append(out["state"].T)
        rvs.append(out["r_vpn"].T)
        t0 += K
    assert t0 == 700
    assert torch.equal(torch.cat(xs, 1), want["x"])
    assert torch.equal(torch.cat(states, 1), want["state"])
    assert torch.equal(torch.cat(rvs, 1), window_sums(_t(vpn), tp.h))
    assert torch.equal(pref, _t(np.stack([pref_v[-1], pref_c[-1]])))


# ---------------------------------------------------------------------------
# The streaming runtime's fused chunk (stream_chunk)
# ---------------------------------------------------------------------------


def _chunk_rows(seed, M, kind, renew):
    """Seeded per-row operands of a streaming chunk, in the order of
    ``FleetRuntime._chunk_rows``: demand regimes that clip at some rows'
    capacity, and VPN / CCI prices that cross over with the regime, so the
    rows toggle."""
    rng = np.random.default_rng(seed)
    _, _, b, r = seeded_tiers(seed, M, 1)
    pol = _port_policy(kind, seeded_toggle(seed, M), renew)
    tp = pol.toggle
    cap = rng.uniform(250.0, 450.0, M)
    L_vpn, L_cci, V_cci = (rng.uniform(0.5, 2.0, M), rng.uniform(6.0, 10.0, M),
                           rng.uniform(0.5, 1.0, M))
    c_cci = rng.uniform(0.01, 0.02, M)
    return (_t(cap), _t(L_vpn), _t(L_cci + V_cci), _t(c_cci), _t(b), _t(r),
            tp.theta1, tp.theta2, tp.h, tp.D, tp.T_cci, *pol.holds())


def _chunk_demand(seed, M, T):
    """(T, M) hour-major demand in 40-hour regimes, row 3 holding NaN at hour
    50 and +inf at hour 70 (the capacity clips the inf; the NaN stays)."""
    rng = np.random.default_rng(seed + 1)
    regime = np.repeat(rng.uniform(10.0, 500.0, (T // 40 + 1, M)), 40, axis=0)[:T]
    d = regime * rng.uniform(0.8, 1.2, (T, M))
    d[50, 3], d[70, 3] = np.nan, np.inf
    return d


def _replaced_chunk(block, K, endo, rows, cal, fsm, pref, t0, hpm, renew):
    """The sequence stream_chunk replaced in FleetRuntime._launch: clip, the
    calendar pricing, the VPN and CCI planes, fsm_chunk, and the cat."""
    cap, L_vpn, lease, c_cci, b, r, *fsm_rows = rows
    M = cap.shape[0]
    nd = (2 if endo else 1) * K * M
    d_pair = torch.minimum(block[:K * M].view(K, M), cap[None, :])
    d_cci = torch.minimum(block[K * M:nd].view(K, M), cap[None, :]) if endo else d_pair
    pre_v, pre_c = block[nd:nd + K * M].view(K, M), block[nd + K * M:].view(K, M)
    transfer, cal = ops.tiered_cost_calendar(cal, d_pair, b, r, t0, hpm)
    vpn = L_vpn[None, :] + transfer
    cci = lease[None, :] + c_cci[None, :] * d_cci
    out = ops.fsm_chunk(vpn, cci, pre_v, pre_c, *fsm_rows, fsm, pref, t0,
                        renew_in_chunks=renew)
    f64 = torch.float64
    packed = torch.cat([vpn, cci, out["r_vpn"], out["r_cci"], out["snap_v"], out["snap_c"],
                        out["x"].to(f64), out["state"].to(f64), cal, out["pref"]])
    return packed, out["carry"]


def _same_bits(a, b):
    """Every bit equal, NaN payloads included (torch.equal is False on NaN)."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("renew", [False, True], ids=["continuous", "chunks"])
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
@pytest.mark.parametrize("endo", [False, True], ids=["exo", "endo"])
@pytest.mark.parametrize("K", [1, 24, 37])
def test_stream_chunk_plain_is_the_sequence_it_replaced(K, endo, kind, renew):
    """stream_chunk's plain version over chained chunks (months of 30 hours,
    so month starts fall inside chunks; a NaN and an inf demand hour) equals,
    bit for bit, the clip / calendar / planes / fsm_chunk / cat sequence the
    runtime ran before, chunk by chunk and in every carry."""
    M, T, hpm = 10, 120, 30
    rows = _chunk_rows(17, M, kind, renew)
    d = _chunk_demand(17, M, T)
    dc = d[::-1].copy() * 1.3            # a CCI demand of its own
    h = rows[8].numpy()
    f64 = torch.float64
    new = old = (torch.zeros((2, M), dtype=f64), torch.zeros((4, M), dtype=torch.int32),
                 torch.zeros((2, M), dtype=f64))
    snaps_v, snaps_c = [], []            # the host ring: prefix before each hour
    xs = []
    for t0 in range(0, T - T % K, K):
        lo = np.maximum(0, t0 + np.arange(K)[:, None] - h[None, :])          # (K, M)

        def ring(snaps):   # the host's reads older than the chunk; 0 where unread
            hist = np.asarray(snaps + [np.zeros(M)])                            # (t0 + 1, M)
            return np.where(lo < t0, np.take_along_axis(hist, np.minimum(lo, t0), 0), 0.0)

        planes = [d[t0:t0 + K]] + ([dc[t0:t0 + K]] if endo else [])
        block = _t(np.concatenate([p.ravel() for p in planes]
                                  + [ring(snaps_v).ravel(), ring(snaps_c).ravel()]))
        got = ops.stream_chunk(block, K, endo, *rows, *new[0:1], new[1], new[2], t0, hpm,
                               renew_in_chunks=renew)
        want = _replaced_chunk(block, K, endo, rows, *old, t0, hpm, renew)
        assert got[0].shape == (8 * K + 4, M)
        assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1]), t0
        new = (got[0][8 * K:8 * K + 2], got[1], got[0][8 * K + 2:])
        old = (want[0][8 * K:8 * K + 2], want[1], want[0][8 * K + 2:])
        snaps_v += list(got[0][4 * K:5 * K].numpy())
        snaps_c += list(got[0][5 * K:6 * K].numpy())
        xs.append(got[0][6 * K:7 * K])
    x = torch.cat(xs)
    assert 0 < x.sum() < x.numel()                        # the rows do toggle
    assert torch.isnan(new[0][0, 3]) and not torch.isnan(new[0][0, :3]).any()


@pytest.mark.parametrize("endo", [False, True], ids=["exo", "endo"])
def test_stream_chunk_plain_matches_jax_step_many(endo):
    """One K = 24 chunk across the month start at hour 730, from a stream's
    own state: the port's plain stream_chunk on the runtime's packed block
    against the JAX runtime's step_many (its _build_step_many dispatch) on
    the same hours. Decisions, the VPN plane and its window sums bit for bit;
    the CCI plane and its window sums at ``rtol=1e-12``: XLA contracts
    ``c·d + (L+V)`` into a fused multiply-add, one ulp off the port's
    product-then-sum (the tolerance of ``tests/test_torch_runtime.py``)."""
    from repro.fleet import scenario as jscen
    from repro.fleet.stream import FleetRuntime as JFleetRuntime

    from repro_torch.fleet import FleetRuntime, build_fleet_scenario

    n, T, t0, K = 8, 760, 712, 24
    jsc = jscen.build_fleet_scenario(n, horizon=T, seed=3)
    sc = build_fleet_scenario(n, horizon=T, seed=3)
    assert np.array_equal(jsc.demand, sc.demand)
    cci_d = sc.demand * 1.5 if endo else None
    cblk = lambda a, b: None if cci_d is None else cci_d[:, a:b]
    jrt, rt = JFleetRuntime(jsc.fleet), FleetRuntime(sc.fleet, device="cpu")
    for a in list(range(0, 696, 24)) + [696]:
        b = a + 24 if a < 696 else t0
        jrt.step_many(sc.demand[:, a:b], cci_demand_block=cblk(a, b))
        rt.step_many(sc.demand[:, a:b], cci_demand_block=cblk(a, b))
    assert rt.t == t0
    block, K_, endo_ = rt._pack(sc.demand[:, t0:t0 + K], cblk(t0, t0 + K))
    assert (K_, endo_) == (K, endo)
    packed, _ = ops.stream_chunk(*rt._chunk_args(torch.from_numpy(block), K, endo))
    want = jrt.step_many(sc.demand[:, t0:t0 + K], cci_demand_block=cblk(t0, t0 + K))
    planes = packed[:8 * K].view(8, K, n).numpy()
    got = {"vpn_cost": planes[0], "r_vpn": planes[2], "x": planes[6], "state": planes[7],
           "cci_cost": planes[1], "r_cci": planes[3]}
    assert 0 < want["x"].sum() < want["x"].size              # the links do toggle
    for k in ("vpn_cost", "r_vpn", "x", "state"):
        np.testing.assert_array_equal(got[k], want[k].T, err_msg=k)
    for k in ("cci_cost", "r_cci"):
        np.testing.assert_allclose(got[k], want[k].T, rtol=1e-12, atol=0, err_msg=k)


def test_stream_chunk_dispatch_refuses_other_devices():
    """ops.stream_chunk sends CPU tensors to the plain version and CUDA ones
    to the kernel; any other device raises, with no fallback."""
    rows = _chunk_rows(3, 4, "reactive", False)
    meta = lambda a: a.to("meta")
    f64 = torch.float64
    args = (torch.zeros(4 * 4, dtype=f64, device="meta"), 1, True, *map(meta, rows),
            torch.zeros((2, 4), dtype=f64, device="meta"),
            torch.zeros((4, 4), dtype=torch.int32, device="meta"),
            torch.zeros((2, 4), dtype=f64, device="meta"), 0, 730)
    with pytest.raises(ValueError, match="stream_chunk"):
        ops.stream_chunk(*args)


# ---------------------------------------------------------------------------
# The streaming runtime's routed chunk (stream_chunk_routed), topology mode
# ---------------------------------------------------------------------------

# name: (scenario, padding legs, billing month, the chunk's first hour, K, endogenous,
# NaN demand hours of pair 0)
ROUTED_CASES = {
    "relay-padded": ("relay", 3, 730, 48, 24, False, ()),
    "multicast-tree": ("multicast", 0, 730, 24, 24, False, ()),
    "nan-pair0-padded": ("topology", 4, 730, 48, 24, False, (40, 51, 58)),
    "k1-month-start": ("topology", 0, 30, 30, 1, False, ()),
    "k24-month-inside": ("topology", 0, 30, 48, 24, False, ()),
    "past-hbuf": ("relay", 0, 730, 48, 120, False, ()),
    "endogenous": ("topology", 0, 730, 48, 24, True, ()),
    "hot-port-76-legs-k24": ("hot-port", 0, 730, 48, 24, False, ()),
    "hot-port-76-legs-k1": ("hot-port", 0, 730, 72, 1, False, ()),
    "hot-port-76-legs-k33": ("hot-port", 0, 730, 73, 33, False, ()),
    "hot-port-165-legs-k24": ("hotter-port", 0, 730, 48, 24, False, ()),
}


def _routed_scenario(m, name, hpm):
    sc = {"relay": lambda: m.build_relay_scenario(horizon=200, seed=0),
          "multicast": lambda: m.build_multicast_scenario(n_leaves=3, horizon=200, seed=0),
          "topology": lambda: m.build_topology_scenario(16, n_facilities=3, horizon=200,
                                                        seed=0),
          # 200 or 400 pairs on 4 ports: the hottest port holds 76 or 165 legs
          "hot-port": lambda: m.build_topology_scenario(200, n_facilities=2,
                                                        ports_per_facility=2, horizon=200,
                                                        seed=0),
          "hotter-port": lambda: m.build_topology_scenario(400, n_facilities=2,
                                                           ports_per_facility=2, horizon=200,
                                                           seed=0)}[name]()
    return sc, dataclasses.replace(sc.topo, hours_per_month=hpm)


@pytest.mark.parametrize("case", sorted(ROUTED_CASES))
def test_stream_chunk_routed_plain_matches_jax_step_many(case):
    """One chunk from a stream's own state: the port's plain
    stream_chunk_routed on the runtime's packed block against the JAX
    runtime's topology step_many on the same hours: a padded relay routing, a
    multicast tree, NaN demand in pair 0 under padding legs (it reaches port 0
    through them), K = 1 at a month start, a month start inside a K = 24
    chunk, K past the window ring, endogenous CCI demand, and ports of 76
    and 165 legs (one and two of the kernel's 128-leg tiles; K = 24, 1 and
    33 past the 32-hour tile). Decisions, the VPN plane and its window sums
    bit for bit; the CCI plane and its window sums at ``rtol=1e-12`` (XLA
    contracts the lease sum and ``c·d_bill`` into a fused multiply-add, one
    ulp off)."""
    from repro.fleet import scenario as jscen
    from repro.fleet import topology as jtop
    from repro.fleet.stream import FleetRuntime as JFleetRuntime

    from repro_torch.fleet import FleetRuntime
    from repro_torch.fleet import scenario as tscen
    from repro_torch.fleet import topology as ttop

    name, pad, hpm, t0, K, endo, nan_hours = ROUTED_CASES[case]
    jsc, jtopo = _routed_scenario(jscen, name, hpm)
    sc, topo = _routed_scenario(tscen, name, hpm)
    demand = sc.demand.copy()
    demand[0, list(nan_hours)] = np.nan
    cci_d = demand * 1.5 if endo else None
    cblk = lambda a, b: None if cci_d is None else cci_d[:, a:b]
    jr, tr = jtop.optimize_routing(jsc.topo, jsc.demand), ttop.optimize_routing(topo, sc.demand)
    jr, tr = jr.pad_to(jr.n_legs + pad), tr.pad_to(tr.n_legs + pad)
    hot = {"hot-port": 76, "hotter-port": 165}.get(name)
    if hot is not None:
        assert np.bincount([m for path in tr.paths for m in path]).max() == hot
    jrt = JFleetRuntime(jtopo, routing=jr)
    rt = FleetRuntime(topo, routing=tr, device="cpu")
    for a in range(0, t0, 24):
        b = min(a + 24, t0)
        jrt.step_many(demand[:, a:b], cci_demand_block=cblk(a, b))
        rt.step_many(demand[:, a:b], cci_demand_block=cblk(a, b))
    if case == "past-hbuf":
        assert K > rt.hbuf
    block, _, _ = rt._pack(demand[:, t0:t0 + K], cblk(t0, t0 + K))
    packed, fsm = ops.stream_chunk_routed(*rt._chunk_args(torch.from_numpy(block), K, endo))
    want = jrt.step_many(demand[:, t0:t0 + K], cci_demand_block=cblk(t0, t0 + K))
    M, P = rt.n_rows, rt.n_demand_rows
    assert packed.shape == (8 * K * M + 2 * P + 2 * M,) and fsm.shape == (4, M)
    planes = packed[:8 * K * M].view(8, K, M).numpy()
    got = {"vpn_cost": planes[0], "r_vpn": planes[2], "x": planes[6], "state": planes[7],
           "cci_cost": planes[1], "r_cci": planes[3]}
    for k in ("vpn_cost", "r_vpn", "x", "state"):
        np.testing.assert_array_equal(got[k], want[k].T, err_msg=k)
    for k in ("cci_cost", "r_cci"):
        np.testing.assert_allclose(got[k], want[k].T, rtol=1e-12, atol=0, err_msg=k)
    if nan_hours:
        bad = set(np.flatnonzero(np.isnan(got["cci_cost"][nan_hours[-1] - t0])).tolist())
        assert bad == {0, *tr.paths[0]} and 0 not in tr.paths[0]


def test_stream_chunk_routed_plain_on_identity_routing_is_stream_chunk():
    """A fleet's identity topology (one pair per private port, one leg each)
    streamed through the routed chunk gives the fleet chunk's packed result
    and FSM carry bit for bit, chunk after chunk (NaN and endogenous hours
    included): the fold of one unit-weight leg from +0.0 and the lease
    ``L + V·1`` change nothing."""
    from repro_torch.fleet import FleetRuntime, build_fleet_scenario, identity_topology

    sc = build_fleet_scenario(8, horizon=800, seed=2)
    itopo, iplan = identity_topology(sc.fleet)
    demand = sc.demand.copy()
    demand[3, 700], demand[5, 710] = np.nan, np.inf
    rf = FleetRuntime(sc.fleet, device="cpu")
    rt = FleetRuntime(itopo, routing=iplan, device="cpu")
    assert rt.topology and rt.n_rows == rt.n_demand_rows == 8
    for t, K in [(0, 24), (24, 1), (25, 671), (696, 24), (720, 24), (744, 56)]:
        c = demand[:, t:t + K] * 1.5 if t == 720 else None
        bf, Kf, ef = rf._pack(demand[:, t:t + K], c)
        bt, Kt, et = rt._pack(demand[:, t:t + K], c)
        nd = (2 if ef else 1) * K * 8          # the demand planes: pair-major in topology mode
        pair_major = bf[:nd].reshape(-1, K, 8).transpose(0, 2, 1).ravel()
        assert np.array_equal(pair_major, bt[:nd], equal_nan=True)
        assert np.array_equal(bf[nd:], bt[nd:], equal_nan=True) and (Kf, ef) == (Kt, et)
        got = rt._launch(torch.from_numpy(bt), K, et)
        want = rf._launch(torch.from_numpy(bf), K, ef)
        assert _same_bits(got, want.reshape(-1)), t
        assert _same_bits(rt._state.fsm, rf._state.fsm), t
        rt._commit(got.numpy(), K)
        rf._commit(want.numpy(), K)
    assert np.isnan(rt._state.dcum[3]) and rt._state.t == 800


def test_stream_chunk_routed_dispatch_refuses_other_devices():
    """ops.stream_chunk_routed sends CPU tensors to the plain version and CUDA
    ones to the kernel; any other device raises, with no fallback."""
    from repro_torch.fleet.routing import RoutingPlan

    meta = lambda *shape, dt=torch.float64: torch.zeros(shape, dtype=dt, device="meta")
    i32 = torch.int32
    op = RoutingPlan(paths=((0,), (1, 0), (1,)), n_ports=2).operand(torch.float64, "cpu")
    args = (meta((3 + 2 * 2) * 1), 1, False, meta(3), meta(3), meta(3, 2), meta(3, 2),
            *(meta(2) for _ in range(5)), *(meta(2, dt=i32) for _ in range(5)), op.to("meta"),
            meta(2, 3), meta(4, 2, dt=i32), meta(2, 2), 0, 730)
    with pytest.raises(ValueError, match="stream_chunk_routed"):
        ops.stream_chunk_routed(*args)


# ---------------------------------------------------------------------------
# The LM's kernels: flash attention and RMSNorm (plain versions)
# ---------------------------------------------------------------------------

from test_kernels import ATT_SHAPES  # noqa: E402


def _att_inputs(seed, shape, Dv=None):
    B, Hq, Hkv, Sq, Skv, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, Dv or D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("mask", ["full", "causal", "window"])
@pytest.mark.parametrize("shape", ATT_SHAPES)
def test_attention_plain_matches_pallas_interpret(shape, mask):
    """The port's plain attention against the Pallas flash kernel in
    interpret mode, float32, at the tolerance tests/test_kernels.py holds
    that kernel to (2e-5)."""
    from repro.kernels.flash_attention import flash_attention

    q, k, v = _att_inputs(12, shape)
    Sq, Skv = shape[3], shape[4]
    causal = mask != "full"
    if causal and Sq > Skv:
        pytest.skip("causal requires Sq <= Skv here")
    kw = dict(causal=causal, window=64 if mask == "window" else 0,
              q_offset=Skv - Sq if causal else 0)
    want = flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw)
    got = ops.attention(*(_t(a) for a in (q, k, v)), **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_attention_plain_covers_the_kernel_contract():
    """Against the JAX oracle where the Pallas kernel needs padding: ragged
    lengths, q_offset with Sq < Skv, Dv != D, a window, and rows with no
    valid key (0, not NaN)."""
    from repro.kernels import ref as jref

    cases = [
        ((1, 4, 2, 100, 260, 48), 32, dict(causal=True, q_offset=160, window=0)),
        ((2, 2, 1, 72, 72, 16), None, dict(causal=True, q_offset=0, window=8)),
        ((1, 2, 2, 64, 64, 32), 24, dict(causal=False, q_offset=0, window=0)),
        ((1, 2, 1, 96, 96, 16), None, dict(causal=True, q_offset=100, window=16)),
    ]
    for shape, Dv, kw in cases:
        q, k, v = _att_inputs(13, shape, Dv)
        want = np.asarray(jref.attention(*(jnp.asarray(a) for a in (q, k, v)), **kw))
        got = ops.attention(*(_t(a) for a in (q, k, v)), **kw).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # The last case: rows 100.. with window 16 over 96 keys; rows >= 111 see none.
    assert (got[:, :, 11:] == 0).all() and (got[:, :, :11] != 0).any()


@pytest.mark.parametrize("shape", [(128, 512), (256, 1024), (2, 128, 384), (3, 256)])
def test_rmsnorm_plain_matches_pallas_interpret(shape):
    from repro.kernels.rmsnorm import rmsnorm

    rng = np.random.default_rng(14)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    if np.prod(shape[:-1]) % 128 == 0:
        want = np.asarray(rmsnorm(jnp.asarray(x), jnp.asarray(w), interpret=True))
    else:   # the Pallas kernel takes multiples of 128 rows; its oracle any
        from repro.kernels import ref as jref
        want = np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(w)))
    got = ops.rmsnorm(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _layout(B, Hq, Hkv, S, D, Dv, *, transposed=False):
    """(b, h, s) element strides of q, k, v and the contiguous output: q/k/v
    contiguous (B, H, S, D), or the LM's transposes of (B, S, H, D)."""
    def st(H, d):
        return (S * H * d, d, H * d) if transposed else (H * S * d, S * d, d)
    return [*st(Hq, D), *st(Hkv, D), *st(Hkv, Dv), Hq * S * Dv, S * Dv, Dv]


SM90, F32, BF16 = "flash_attention_sm90_bf16", "flash_attention_f32", "flash_attention_bf16"
ALIGNED = [1 << 20, 3 << 20, 5 << 20, 7 << 20]   # base addresses, 16-byte aligned
STRIDE_68 = _layout(1, 2, 1, 63, 64, 64)
STRIDE_68[2] = 68                                 # q's s stride: 136 bytes


@pytest.mark.parametrize("dtype,D,Dv,strides,ptrs,want", [
    ("bfloat16", 64, 64, _layout(4, 32, 4, 1024, 64, 64), ALIGNED, SM90),         # TinyLlama
    ("bfloat16", 64, 64, _layout(4, 32, 4, 1024, 64, 64, transposed=True), ALIGNED, SM90),
    ("bfloat16", 120, 120, _layout(1, 32, 8, 1024, 120, 120, transposed=True), ALIGNED, SM90),
    ("bfloat16", 128, 128, _layout(1, 4, 4, 256, 128, 128), ALIGNED, SM90),
    ("bfloat16", 192, 128, _layout(1, 2, 1, 200, 192, 128), ALIGNED, SM90),
    ("bfloat16", 256, 256, _layout(1, 2, 1, 130, 256, 256), ALIGNED, SM90),
    ("bfloat16", 40, 40, _layout(1, 2, 2, 70, 40, 40), ALIGNED, SM90),
    ("bfloat16", 60, 60, _layout(1, 2, 1, 64, 60, 60), ALIGNED, BF16),           # D % 8 != 0
    ("bfloat16", 64, 60, _layout(1, 2, 1, 64, 64, 60), ALIGNED, BF16),
    ("bfloat16", 64, 64, STRIDE_68, ALIGNED, BF16),
    ("bfloat16", 64, 64, [0] + _layout(1, 2, 1, 64, 64, 64)[1:], ALIGNED, BF16),  # broadcast b
    ("bfloat16", 64, 64, _layout(2, 4, 2, 128, 64, 64), [ALIGNED[0] + 2] + ALIGNED[1:],
     BF16),                                                                      # q at +1 elem
    ("bfloat16", 64, 64, _layout(2, 4, 2, 128, 64, 64), ALIGNED[:3] + [ALIGNED[3] + 8],
     BF16),                                                                      # o at +8 B
    ("float32", 64, 64, _layout(4, 32, 4, 1024, 64, 64), ALIGNED, F32),
    ("float32", 192, 128, _layout(1, 2, 1, 200, 192, 128), ALIGNED, F32),
], ids=["tinyllama", "lm-transposes", "danube-120", "d128", "d192-dv128", "d256", "d40",
        "d60", "dv60", "stride68", "stride0", "q-offset", "o-offset", "f32", "f32-d192"])
def test_flash_entry_choice(dtype, D, Dv, strides, ptrs, want):
    """The pure choice between the Hopper entry and the general one: bf16
    with head dims that are multiples of 8 and 16-byte aligned pointers and
    strides go to sm90, anything else of a dtype to its general entry."""
    from repro_torch.kernels.flash_attention import _entry

    assert _entry(getattr(torch, dtype), D, Dv, strides, ptrs) == want


@pytest.mark.parametrize("dtype,D,Dv,err", [
    ("bfloat16", 264, 64, ValueError), ("bfloat16", 64, 264, ValueError),
    ("float32", 256, 128, ValueError), ("float32", 200, 200, ValueError),
    ("float16", 64, 64, TypeError),
])
def test_flash_entry_choice_refuses_what_no_entry_takes(dtype, D, Dv, err):
    """Head dims past MAX_HEAD_DIM of the dtype, and other dtypes, raise."""
    from repro_torch.kernels.flash_attention import MAX_HEAD_DIM, _entry

    if dtype != "float16":
        assert max(D, Dv) > MAX_HEAD_DIM[getattr(torch, dtype)]
    with pytest.raises(err):
        _entry(getattr(torch, dtype), D, Dv, _layout(1, 2, 1, 64, D, Dv), ALIGNED)


def test_lm_kernel_dispatch_refuses_other_devices():
    q = torch.empty((1, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.rmsnorm(q, torch.empty(8, device="meta"))


# ---------------------------------------------------------------------------
# int8 quantization and the static tiered cost (the actuation slice)
# ---------------------------------------------------------------------------

INT8_SHAPES = [(256, 128), (512, 1024), (17, 33)]


def _int8_input(shape, dtype, seed=7):
    """x * 3 from a seeded normal, with a zero row; as a JAX array and the
    same bits as a torch tensor."""
    from repro_torch.models.convert import tree_from_reference

    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    x[1] = 0.0
    jx = jnp.asarray(x, dtype)
    return jx, tree_from_reference(np.asarray(jx), CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_plain_bit_equal_to_jax_ref(shape, dtype):
    from repro.kernels import ref as jref

    jx, x = _int8_input(shape, dtype)
    q, s = ops.int8_quantize(x)
    jq, js = jref.int8_quantize(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (shape[0], 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[1] == 0).all()
    for odt in ("float32", "bfloat16"):
        got = ops.int8_dequantize(q, s, getattr(torch, odt))
        want = np.asarray(jref.int8_dequantize(jq, js, dtype=getattr(jnp, odt)))
        assert got.dtype == getattr(torch, odt)
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", INT8_SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_int8_plain_matches_pallas_interpret(shape, dtype):
    """Against the Pallas kernels in interpret mode, with
    ``tests/test_kernels.py``'s allowance: the interpreted scale may differ
    by rounding, so |Δq| <= 1 on fewer than 1e-3 of the entries."""
    from repro.kernels.int8_quant import int8_dequantize, int8_quantize

    jx, x = _int8_input(shape, dtype)
    jq, js = int8_quantize(jx, interpret=True)
    q, s = ops.int8_quantize(x)
    dq = np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32))
    assert dq.max() <= 1 and (dq != 0).mean() < 1e-3
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    want = np.asarray(int8_dequantize(jq, js, interpret=True))
    got = ops.int8_dequantize(q, s).numpy()
    np.testing.assert_allclose(got, want, atol=float(np.asarray(js).max()) * 1.01)
    assert (np.abs(x.float().numpy() - got) <= s.numpy() * 0.5 + 1e-6).all()


def test_int8_default_guard_is_the_pallas_contract_on_tiny_rows():
    """``ops.int8_quantize``'s default guard stays the Pallas kernel's,
    ``max(amax, 1e-30) / 127``: q and scale equal ``repro.kernels.ref``'s bit
    for bit on rows whose |max| is 0, 1e-29, 1.2e-28, 127 * 1e-30 and 3,
    and the collectives' guard gives other scales on the rows below 127 * 1e-30."""
    from repro.kernels import ref as jref

    x = guard_rows(11, d=33)
    q, s = ops.int8_quantize(torch.from_numpy(x))
    jq, js = jref.int8_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _, cs = ops.int8_quantize(torch.from_numpy(x), guard="collectives")
    np.testing.assert_array_equal((s != cs).flatten().numpy(), [True, True, True, False, False])
    with pytest.raises(ValueError, match="guard"):
        ops.int8_quantize(torch.from_numpy(x), guard="xla")


def test_int8_collectives_guard_matches_jax_collectives_quantize():
    """``ref.int8_quantize(guard="collectives")`` is
    ``repro.dist.collectives._quantize``: q and scale bit for bit, on the
    guard's edge rows and on a (256, 1024) float32 block (where the clip,
    which the JAX version lacks, changes nothing)."""
    from repro.dist.collectives import _quantize as jquantize

    from repro_torch.kernels import ref

    rng = np.random.default_rng(12)
    for x in (guard_rows(12, d=33), (rng.normal(size=(256, 1024)) * 3.0).astype(np.float32)):
        q, s = ref.int8_quantize(torch.from_numpy(x), guard="collectives")
        jq, js = jquantize(jnp.asarray(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert int(np.abs(np.asarray(jq, np.int32)).max()) <= 127


def _nonfinite_rows(seed, d=33):
    """Seeded float32 rows: one holding a NaN, one +inf, one -inf, one of
    zeros, one finite, and one holding NaN and +inf."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(6, d)) * 3.0).astype(np.float32)
    x[0, 5] = np.nan
    x[1, 0] = np.inf
    x[2, d - 1] = -np.inf
    x[3] = 0.0
    x[5, 2], x[5, 7] = np.inf, np.nan
    return x


@pytest.mark.parametrize("guard", ["pallas", "collectives"])
def test_int8_plain_matches_jax_on_nonfinite_rows(guard):
    """On rows holding NaN, +inf and -inf, the plain quantizer gives what JAX
    gives (``repro.kernels.ref.int8_quantize`` for the Pallas guard,
    ``repro.dist.collectives._quantize`` for the collectives' guard): scale
    NaN or inf and q = 0 on the whole row; zero and finite rows as before.
    The dequantized rows match too (``0 · NaN`` is NaN)."""
    from repro.dist.collectives import _quantize as jquantize
    from repro.kernels import ref as jref

    from repro_torch.kernels import ref

    x = _nonfinite_rows(13)
    jq, js = (jref.int8_quantize if guard == "pallas" else jquantize)(jnp.asarray(x))
    q, s = ref.int8_quantize(torch.from_numpy(x), guard=guard)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert np.isnan(s[0, 0].item()) and np.isnan(s[5, 0].item())
    assert s[1, 0].item() == np.inf and s[2, 0].item() == np.inf
    assert bool((q[[0, 1, 2, 3, 5]] == 0).all()) and bool((q[4] != 0).any())
    for odt in ("float32", "bfloat16"):
        got = ref.int8_dequantize(q, s, getattr(torch, odt)).float().numpy()
        want = np.asarray(jref.int8_dequantize(jq, js, dtype=getattr(jnp, odt)),
                          np.float32)
        np.testing.assert_array_equal(got, want)        # NaN where JAX has NaN
    assert np.isnan(got[[0, 1, 2, 5]]).all() and np.isfinite(got[[3, 4]]).all()


@pytest.mark.parametrize("T,P", [(512, 1), (1024, 4), (8704, 8)])
def test_tiered_cost_plain_matches_pallas_and_jax_ref(T, P):
    """The static-table plain version: against the Pallas kernel in interpret
    mode and the JAX oracle (a sum over a tier axis) at ``rtol=atol=1e-6``,
    and against the float64 numpy reference at ``atol=2e-2`` (float32
    resolution at month volumes of ~2e6 GB), as ``tests/test_kernels.py``."""
    from repro.core.costmodel import tiered_marginal_cost_np
    from repro.core.pricing import AWS_EGRESS_INTERNET as tier
    from repro.kernels import ref as jref
    from repro.kernels.tiered_cost import tiered_cost as jtiered_cost

    rng = np.random.default_rng(8)
    d = rng.uniform(0, 500, size=(T, P)).astype(np.float32)
    cum = (np.cumsum(d, axis=0) - d).astype(np.float32)
    got = ops.tiered_cost(_t(cum), _t(d), tier.bounds_gb, tier.rates)
    assert got.dtype == torch.float32 and got.shape == (T, P)
    pallas = np.asarray(jtiered_cost(jnp.asarray(cum), jnp.asarray(d), tier.bounds_gb,
                                     tier.rates, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
    b32 = jnp.asarray([b if np.isfinite(b) else 1e30 for b in tier.bounds_gb], jnp.float32)
    oracle = np.asarray(jref.tiered_cost(jnp.asarray(cum), jnp.asarray(d), b32,
                                         jnp.asarray(tier.rates, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), tiered_marginal_cost_np(tier, cum, d), atol=2e-2)


def test_tiered_cost_plain_is_the_left_fold_and_checks_the_table():
    """A hand-folded case through every tier, an infinite bound as 1e30, and
    more tiers than the kernel's table holds raise."""
    cum = torch.tensor([[0.0, 10.0, 30.0]])
    d = torch.tensor([[25.0, 15.0, 5.0]])
    got = ops.tiered_cost(cum, d, (10.0, 20.0, float("inf")), (3.0, 2.0, 1.0))
    np.testing.assert_array_equal(got.numpy(), [[10 * 3 + 10 * 2 + 5 * 1, 10 * 2 + 5, 5.0]])
    with pytest.raises(ValueError, match="at most 8"):
        ops.tiered_cost(cum, d, [float(i) for i in range(1, 10)], [1.0] * 9)
    with pytest.raises(ValueError, match="rates"):
        ops.tiered_cost(cum, d, (1.0, 2.0), (1.0,))


def test_actuation_kernel_dispatch_refuses_other_devices():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.int8_quantize(x)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.int8_dequantize(torch.empty((4, 8), dtype=torch.int8, device="meta"),
                            torch.empty((4, 1), device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.tiered_cost(x, x, (1.0, float("inf")), (0.1, 0.05))


# ---------------------------------------------------------------------------
# NaN in the tier fold, and the dequantize yardstick
# ---------------------------------------------------------------------------

def _same_nan(got: np.ndarray, want: np.ndarray) -> bool:
    """NaN in the same places and every bit equal elsewhere (``np.array_equal``
    and ``torch.equal`` are False wherever both hold NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(np.isnan(got), nan)
            and np.array_equal(got[~nan].view(np.uint8), want[~nan].view(np.uint8)))


def _nan_cells(cum, d):
    """NaN month-to-date volumes and NaN demands in seeded (n, T) planes: one
    of each alone, both in one cell, and a NaN demand in the first hour."""
    cum, d = cum.copy(), d.copy()
    cum[0, 3] = np.nan
    d[1, 5] = np.nan
    cum[2, 7], d[2, 7] = np.nan, np.nan
    d[3, 0] = np.nan
    return cum, d, [(0, 3), (1, 5), (2, 7), (3, 0)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_tier_fold_plain_prices_nan_hours_zero_as_jax(dtype):
    """The port's ``tiered_marginal_cost_tables`` on hours with a NaN demand
    or month-to-date volume: every bit equal to the JAX function of that
    name (NaN-aware), and those hours priced +0.0 (every tier segment is NaN
    and fails ``seg > 0``). The Pallas ``tiered_cost_batched`` in interpret
    mode sums without that guard: it gives NaN on those hours and agrees at
    ``rtol=atol=1e-6`` elsewhere (float32, its only type)."""
    from repro.core.costmodel import tiered_marginal_cost_tables as jtables

    from repro_torch.core.costmodel import tiered_marginal_cost_tables

    cum, d, b, r = seeded_tiers(21, 8, 128, dtype)
    cum, d, cells = _nan_cells(cum, d)
    got = tiered_marginal_cost_tables(*(_t(a) for a in (cum, d, b, r))).numpy()
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jtables(*(jnp.asarray(a) for a in (cum, d, b, r))))
    assert got.dtype == dtype and _same_nan(got, want)
    assert not np.isnan(got).any()
    for n, t in cells:
        assert got[n, t] == 0.0 and not np.signbit(got[n, t])
    if dtype == np.float32:
        pallas = np.asarray(tiered_cost_batched(*(jnp.asarray(a) for a in (cum, d, b, r)),
                                                block_t=128, interpret=True))
        nan = np.isnan(pallas)
        assert sorted(zip(*np.nonzero(nan))) == sorted(cells)
        np.testing.assert_allclose(got[~nan], pallas[~nan], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
def test_tiered_scan_plain_prices_nan_hours_zero_as_jax(dtype):
    """Month-to-date form on rows with a NaN carried volume (zeroed at the
    month start mid-chunk) and NaN demands: every bit of costs and carry
    equal to the XLA ``tiered_cost_scan_ref`` (NaN-aware), NaN hours +0.0.
    The Pallas ``tiered_cost_scan`` in interpret mode (float32) gives NaN on
    those hours and agrees with the port elsewhere at ``tests/test_kernels.py``'s
    ``rtol=1e-5, atol=1e-4``; its carry at ``rtol=1e-6``."""
    from repro.kernels.tiered_cost import tiered_cost_scan, tiered_cost_scan_ref

    cum0, d, b, r, reset = _scan_inputs(24, dtype)
    cum0[0] = np.nan                       # NaN until the reset at hour 12
    d[1, 3] = np.nan                       # NaN carry from hour 4 to the reset
    d[2, 20] = np.nan                      # NaN past the reset: carried to the end
    got, cum_got = ops.tiered_cost_scan(*(_t(a) for a in (cum0, d, b, r, reset)))
    with jax.enable_x64(dtype == np.float64):
        want, cum_want = tiered_cost_scan_ref(*(jnp.asarray(a) for a in (cum0, d, b, r, reset)))
        want, cum_want = np.asarray(want), np.asarray(cum_want)
    assert _same_nan(got.numpy(), want) and _same_nan(cum_got.numpy(), cum_want)
    g = got.numpy()
    nan_hours = ([(0, k) for k in range(12)] + [(1, k) for k in range(3, 12)]
                 + [(2, k) for k in range(20, 24)])
    for n, k in nan_hours:
        assert g[n, k] == 0.0 and not np.signbit(g[n, k])
    c = cum_got.numpy()
    assert not np.isnan(g).any() and np.isnan(c[2]) and not np.isnan(c[:2]).any()
    if dtype == np.float32:
        pallas, cum_pallas = tiered_cost_scan(*(jnp.asarray(a) for a in (cum0, d, b, r, reset)),
                                              interpret=True)
        pallas = np.asarray(pallas)
        nan = np.isnan(pallas)
        assert sorted(zip(*np.nonzero(nan))) == sorted(nan_hours)
        np.testing.assert_allclose(g[~nan], pallas[~nan], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(cum_got.numpy(), np.asarray(cum_pallas), rtol=1e-6)


def test_tiered_calendar_plain_prices_nan_hours_zero_as_jax():
    """The runtime's calendar form on rows with a NaN carried prefix and NaN
    demands: every bit equal (NaN-aware) to the JAX ``tiered_marginal_cost_tables``
    over the same month-to-date volumes (the JAX runtime's calendar, replayed
    in numpy float64: one add and one subtract an hour, as its scan), with
    the carry; every hour whose volume is NaN priced +0.0."""
    from repro.core.costmodel import tiered_marginal_cost_tables as jtables

    _, d, b, r = seeded_tiers(22, 6, 60)
    d = d.T.copy()                                     # (K, N), hour-major
    d[10, 1] = np.nan
    carry = np.zeros((2, 6))
    carry[0] = np.linspace(0.0, 5e4, 6)
    carry[0, 0] = np.nan                               # NaN prefix
    t0, hpm = 20, 48                                   # a month starts at hour 48
    got, carry_got = ops.tiered_cost_calendar(_t(carry), _t(d), _t(b), _t(r), t0, hpm)
    dcum, month = carry[0].copy(), carry[1].copy()
    lo = np.empty_like(d)
    for k in range(d.shape[0]):
        if (t0 + k) % hpm == 0:
            month = dcum.copy()
        lo[k] = dcum - month
        dcum = dcum + d[k]
    with jax.enable_x64():
        want = np.asarray(jtables(jnp.asarray(lo.T), jnp.asarray(d.T), jnp.asarray(b),
                                  jnp.asarray(r))).T
    assert _same_nan(got.numpy(), want)
    assert _same_nan(carry_got.numpy(), np.stack([dcum, month]))
    nan = np.isnan(lo) | np.isnan(d)
    assert nan[:, 0].all() and nan[10:, 1].all() and not nan[:, 2:].any()
    assert (got.numpy()[nan] == 0.0).all() and not np.signbit(got.numpy()[nan]).any()


def test_tiered_cost_static_plain_is_nan_on_nan_hours_as_pallas():
    """The static-table plain version on hours with a NaN demand or
    month-to-date volume: NaN exactly where the Pallas ``_tiered_kernel`` in
    interpret mode and the JAX oracle are NaN (its clip keeps the NaN and it
    has no ``seg > 0`` guard), and ``rtol=atol=1e-6`` elsewhere, as
    ``test_tiered_cost_plain_matches_pallas_and_jax_ref``."""
    from repro.core.pricing import AWS_EGRESS_INTERNET as tier
    from repro.kernels import ref as jref
    from repro.kernels.tiered_cost import tiered_cost as jtiered_cost

    rng = np.random.default_rng(23)
    d = rng.uniform(0, 500, size=(512, 4)).astype(np.float32)
    cum = (np.cumsum(d, axis=0) - d).astype(np.float32)
    cum, d, cells = _nan_cells(cum.T, d.T)
    cum, d = np.ascontiguousarray(cum.T), np.ascontiguousarray(d.T)
    got = ops.tiered_cost(_t(cum), _t(d), tier.bounds_gb, tier.rates).numpy()
    pallas = np.asarray(jtiered_cost(jnp.asarray(cum), jnp.asarray(d), tier.bounds_gb,
                                     tier.rates, interpret=True))
    b32 = jnp.asarray([b if np.isfinite(b) else 1e30 for b in tier.bounds_gb], jnp.float32)
    oracle = np.asarray(jref.tiered_cost(jnp.asarray(cum), jnp.asarray(d), b32,
                                         jnp.asarray(tier.rates, jnp.float32)))
    nan = np.isnan(got)
    assert sorted(zip(*np.nonzero(nan))) == sorted((t, n) for n, t in cells)
    for other in (pallas, oracle):
        assert np.array_equal(np.isnan(other), nan)
        np.testing.assert_allclose(got[~nan], other[~nan], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 2048), (17, 33), (256, 5632)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_dequantize_plain_is_one_torch_mul(shape):
    """``torch.mul(q, scale)`` on int8 q (N, d) and float32 scale (N, 1)
    promotes to float32 in one call and equals ``ref.int8_dequantize`` bit
    for bit, NaN and inf scales included: the library call the card's
    ``int8_dequantize`` is timed against."""
    from repro_torch.kernels import ref

    rng = np.random.default_rng(24)
    q = torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8))
    s = torch.from_numpy(rng.uniform(1e-6, 1e-2, size=(shape[0], 1)).astype(np.float32))
    if shape[0] > 2:
        s[0, 0], s[1, 0] = float("nan"), float("inf")
    got = torch.mul(q, s)
    want = ref.int8_dequantize(q, s)
    assert got.dtype == torch.float32 and got.shape == shape
    assert _same_nan(got.numpy(), want.numpy())
