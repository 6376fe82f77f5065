"""Port vs JAX package for the actuation layer.

On the CPU the port's gradient sync runs on gloo process groups and the
plain versions of its int8 kernels. It is held against:

* the JAX ``ToggleCCIController``/``InterconnectPlanner``: served states,
  modes and every report field equal (both are the same Python float code);
* the JAX ``sync_grads``/``fleet_sync_grads`` on replicated gradients:
  outputs and error-feedback residuals equal bit for bit, on a one-rank pod
  mesh in this process (``jax.make_mesh((1, 1, 1), ...)``; rows holding
  NaN or inf too) and on pod x data meshes of 4, 3, 5 and 6 ranks across
  as many gloo processes (JAX on forced host devices, as
  ``tests/test_dist.py`` runs it);
* the JAX ``ElasticFleetPlanner`` in fleet mode: modes equal at every tick;
  ``cost_always_vpn``, ``gb`` and ``gb_saved`` bit for bit, the CCI side
  (``cost``, ``cost_always_cci``) at ``rtol=1e-12`` (XLA contracts
  ``c·d + (L+V)`` into a fused multiply-add, as ``test_torch_runtime.py``
  states).

The sync quantizes with the JAX collectives' scale guard, ``max(amax /
127, 1e-30)``, so rows whose |max| lies in (0, 1.27e-28) match too; the
quantize kernel's default stays the Pallas kernel's (``test_torch_kernels.py``).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from test_torch_support import SRC, guard_rows

import jax
import jax.numpy as jnp

from repro.core import planner as jplanner
from repro.core.costmodel import hourly_cost_series as jhourly_cost_series
from repro.core.pricing import make_scenario as jmake_scenario
from repro.core.togglecci import run_togglecci as jrun_togglecci
from repro.dist import collectives as jcoll
from repro.fleet import scenario as jscen
from repro.fleet.runtime import ElasticFleetPlanner as JElasticFleetPlanner
from repro.fleet.spec import fleet_from_params as jfleet_from_params
from repro.traffic.traces import bursty_trace as jbursty_trace

from repro_torch.core import planner
from repro_torch.core.costmodel import hourly_cost_series
from repro_torch.core.pricing import make_scenario
from repro_torch.core.togglecci import ON, run_togglecci
from repro_torch.dist import collectives as coll
from repro_torch.fleet import ElasticFleetPlanner, build_fleet_scenario
from repro_torch.fleet.spec import fleet_from_params
from repro_torch.kernels import ops
from repro_torch.launch.mesh import dp_axes, make_host_mesh
from repro_torch.models.convert import tree_from_reference
from repro_torch.traffic.traces import bursty_trace
from repro_torch.tree import tree_leaves, tree_map

MODES = ("direct", "hierarchical", "compressed")
POD_NAMES = ("pod", "data", "model")


# ---------------------------------------------------------------------------
# The single-link controller and planner
# ---------------------------------------------------------------------------


def test_incremental_controller_matches_jax_and_batch():
    """Port of ``tests/test_dist.py::test_incremental_controller_matches_batch``:
    the port's controller serves the JAX controller's states and
    ``run_togglecci``'s decisions hour by hour."""
    d = bursty_trace(horizon=4000, seed=9).sum(axis=1)
    assert np.array_equal(d, jbursty_trace(horizon=4000, seed=9).sum(axis=1))
    params, jparams = make_scenario("gcp", "aws"), jmake_scenario("gcp", "aws")
    costs, jcosts = hourly_cost_series(params, d), jhourly_cost_series(jparams, d)
    ctl, jctl = planner.ToggleCCIController(params), jplanner.ToggleCCIController(jparams)
    served = np.array([ctl.update(costs.vpn[t], costs.cci[t]) for t in range(len(d))])
    jserved = np.array([jctl.update(jcosts.vpn[t], jcosts.cci[t]) for t in range(len(d))])
    np.testing.assert_array_equal(served, jserved)
    np.testing.assert_array_equal((served == ON).astype(int), run_togglecci(params, d, costs=costs).x)
    np.testing.assert_array_equal((served == ON).astype(int),
                                  jrun_togglecci(jparams, d, costs=jcosts).x)
    assert ctl.requests == jctl.requests and ctl.releases == jctl.releases
    assert 0 < (served == ON).sum() < len(d)


def _byte_stream(kind):
    if kind == "low":
        return np.full(500, 1e9)                 # 1 GB/h: stays compressed
    if kind == "high":
        return np.full(2000, 200e12)             # 200 TB/h: leases
    rng = np.random.default_rng(11)              # regime flips, GB/h -> bytes
    return np.where(rng.random(2500) < 0.5, 40e3, 20.0) * 1e9


@pytest.mark.parametrize("kind", ["low", "high", "flip"])
def test_interconnect_planner_matches_jax(kind):
    """``tests/test_dist.py:285/296`` and ``test_fleet_runtime.py:589``'s
    byte streams: the same mode every hour and the same report, bit for bit."""
    pl, jpl = planner.InterconnectPlanner(), jplanner.InterconnectPlanner()
    modes = [pl.feed_hour(b) for b in _byte_stream(kind)]
    jmodes = [jpl.feed_hour(b) for b in _byte_stream(kind)]
    assert modes == jmodes
    rep, jrep = pl.report(), jpl.report()
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    if kind == "low":
        assert rep.on_fraction == 0.0 and rep.total_cost <= rep.cost_always_cci
    elif kind == "high":
        assert rep.on_fraction > 0.5 and rep.total_cost < rep.cost_always_vpn
    else:
        assert rep.requests and rep.releases


def test_dci_scenario_and_constants_match_jax():
    assert planner.COMPRESS_RATIO == jplanner.COMPRESS_RATIO
    p, jp = planner.dci_scenario(), jplanner.dci_scenario()
    for f in ("L_cci", "V_cci", "c_cci", "L_vpn", "theta1", "theta2", "h", "D", "T_cci",
              "hours_per_month"):
        assert getattr(p, f) == getattr(jp, f), f
    assert p.vpn_tier.bounds_gb == jp.vpn_tier.bounds_gb
    assert p.vpn_tier.rates == jp.vpn_tier.rates
    for s in range(3):
        assert planner.collective_mode(s) == jplanner.collective_mode(s)
    with pytest.raises(NotImplementedError, match="item 12"):
        planner.cross_pod_bytes_per_step("")


# ---------------------------------------------------------------------------
# sync_grads on one rank, in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def gloo_world(tmp_path):
    """A one-rank gloo default group of this test's own (FileStore under
    tmp_path), destroyed afterwards."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def pod_mesh(gloo_world):
    return init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=POD_NAMES)


def _grads(seed, dtype=np.float32):
    """Leaves (64, 32) with a row of zeros, (17,) and (3, 4, 8)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(64, 32)).astype(dtype)
    w[5] = 0.0
    return {"w": w, "b": rng.normal(size=(17,)).astype(dtype),
            "t": [rng.normal(size=(3, 4, 8)).astype(dtype)]}


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    got_leaves = tree_leaves(got)
    want_leaves = jax.tree.leaves(_np_tree(want))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_sync_grads_one_rank_pod_mesh_matches_jax(pod_mesh):
    jmesh = jax.make_mesh((1, 1, 1), POD_NAMES)
    g_np = _grads(0)
    g = tree_from_reference(g_np, "cpu")
    for mode in ("direct", "hierarchical"):
        out, err = coll.sync_grads(g, pod_mesh, mode=mode)
        jout, jerr = jcoll.sync_grads(_jax_tree(g_np), jmesh, mode=mode)
        assert err is None and jerr is None
        _assert_trees_equal(out, jout)
        _assert_trees_equal(out, g_np)                 # one rank: the input itself
    err, jerr = None, None
    for step in range(2):                              # carried residuals
        g_np = _grads(step)
        out, err = coll.sync_grads(tree_from_reference(g_np, "cpu"), pod_mesh,
                                   mode="compressed", err_state=err)
        jout, jerr = jcoll.sync_grads(_jax_tree(g_np), jmesh, mode="compressed",
                                      err_state=jerr)
        _assert_trees_equal(out, jout)
        _assert_trees_equal(err, jerr)
        assert not np.array_equal(out["w"].numpy(), g_np["w"])       # it did quantize
        np.testing.assert_array_equal(out["w"][5].numpy(), 0.0)      # the zero row
        np.testing.assert_array_equal(err["w"][5].numpy(), 0.0)


def test_sync_grads_matches_the_plain_path(pod_mesh):
    """Per leaf: ``u = g + err``, ``deq = dequant(quant(u))`` on a
    ``(-1, last)`` view, output ``deq`` and residual ``u - deq``."""
    g = tree_from_reference(_grads(3), "cpu")
    err = tree_map(lambda a: torch.randn(a.shape, generator=torch.Generator().manual_seed(1)), g)
    out, new_err = coll.sync_grads(g, pod_mesh, mode="compressed", err_state=err)
    for a, e, o, ne in zip(*(tree_leaves(t) for t in (g, err, out, new_err))):
        u = a + e
        q, s = ops.int8_quantize(u.reshape(-1, u.shape[-1]), guard="collectives")
        deq = ops.int8_dequantize(q, s).view(u.shape)
        assert torch.equal(o, deq) and torch.equal(ne, u - deq)
    for a, e in zip(tree_leaves(g), tree_leaves(err)):          # inputs untouched
        assert not torch.equal(a, a + e)


def test_sync_grads_without_pod_axis_matches_jax(gloo_world):
    """A ``(data, model)`` mesh has no pod hop: compressed returns the
    unquantized gradients and zero residuals, as in the JAX package."""
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and dp_axes(mesh) == ("data",)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    g_np = _grads(4)
    out, err = coll.sync_grads(tree_from_reference(g_np, "cpu"), mesh, mode="compressed")
    jout, jerr = jcoll.sync_grads(_jax_tree(g_np), jmesh, mode="compressed")
    _assert_trees_equal(out, jout)
    _assert_trees_equal(err, jerr)
    _assert_trees_equal(out, g_np)
    assert all(bool((e == 0).all()) for e in tree_leaves(err))


def test_make_host_mesh_creates_a_one_rank_world_and_checks_the_size():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        make_host_mesh(data=2, model=1, device="cpu")
    try:
        mesh = make_host_mesh(data=1, model=1, pod=1, device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="ranks"):
            make_host_mesh(data=2, model=2, pod=2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_compressed_sync_matches_jax_on_tiny_rows(pod_mesh):
    """The port's compressed ``sync_grads`` quantizes with the JAX
    collectives' guard, ``max(amax / 127, 1e-30)``: outputs and residuals
    equal ``repro.dist.collectives.sync_grads`` bit for bit on rows whose
    |max| is 0, 1e-29, 1.2e-28, exactly 127 * 1e-30 and 3, over two steps
    with a carried residual."""
    jmesh = jax.make_mesh((1, 1, 1), POD_NAMES)
    err, jerr = None, None
    for step in range(2):
        x = guard_rows(7 + step)
        out, err = coll.sync_grads({"x": torch.from_numpy(x)}, pod_mesh, mode="compressed",
                                   err_state=err)
        jout, jerr = jcoll.sync_grads({"x": jnp.asarray(x)}, jmesh, mode="compressed",
                                      err_state=jerr)
        _assert_trees_equal(out, jout)
        _assert_trees_equal(err, jerr)
    assert bool((out["x"][1:4] != 0).any(dim=1).all())          # the tiny rows survive


def test_compressed_sync_matches_jax_on_nonfinite_rows(pod_mesh):
    """A leaf with a NaN row and a +inf row through the compressed sync, two
    steps with the carried residual: outputs and residuals equal the JAX
    sync bit for bit (NaN where JAX has NaN); the finite rows stay finite."""
    jmesh = jax.make_mesh((1, 1, 1), POD_NAMES)
    rng = np.random.default_rng(21)
    err, jerr = None, None
    for step in range(2):
        x = rng.normal(size=(4, 24)).astype(np.float32)
        x[1, 3] = np.nan
        x[2, 0] = np.inf
        out, err = coll.sync_grads({"x": torch.from_numpy(x)}, pod_mesh, mode="compressed",
                                   err_state=err)
        jout, jerr = jcoll.sync_grads({"x": jnp.asarray(x)}, jmesh, mode="compressed",
                                      err_state=jerr)
        _assert_trees_equal(out, jout)
        _assert_trees_equal(err, jerr)
    o = out["x"].numpy()
    assert np.isnan(o[1:3]).all() and np.isfinite(o[[0, 3]]).all()


# ---------------------------------------------------------------------------
# Wire bytes, labels, fleet_sync_grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_sync_wire_bytes_matches_jax(dtype, mode):
    z = lambda *s: torch.zeros(s, dtype=getattr(torch, dtype))
    g = {"w": z(256, 256), "b": z(256), "t": [z(3, 4, 8), z(17)], "e": None}
    jg = {"w": jnp.zeros((256, 256), dtype), "b": jnp.zeros((256,), dtype),
          "t": [jnp.zeros((3, 4, 8), dtype), jnp.zeros((17,), dtype)], "e": None}
    assert coll.sync_wire_bytes(g, mode) == jcoll.sync_wire_bytes(jg, mode)
    full = coll.sync_wire_bytes(g, "hierarchical")
    comp = coll.sync_wire_bytes(g, "compressed")
    assert 3.5 < full / comp <= 4.0 if dtype == "float32" else 1.7 < full / comp <= 2.0


@pytest.mark.parametrize("tenant", [None, "acme", "acme co/1", 7])
@pytest.mark.parametrize("mode", ["hierarchical", "compressed"])
def test_sync_domain_label_matches_jax(tenant, mode):
    for gid in (0, 3, "p7"):
        assert (coll.sync_domain_label(gid, mode, tenant=tenant)
                == jcoll.sync_domain_label(gid, mode, tenant=tenant))


def _jobs(seed, n):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(64, 32)).astype(np.float32)} for _ in range(n)]


def test_fleet_sync_grads_groups_and_carried_residuals(pod_mesh):
    """``tests/test_fleet_runtime.py:689-732`` on the port, and each call
    against JAX's ``fleet_sync_grads``: grouped equals ungrouped, billed
    bytes are per job, and after a re-grouping carried residuals continue
    while fresh jobs start from zero."""
    jmesh = jax.make_mesh((1, 1, 1), POD_NAMES)
    g_np = _jobs(0, 4)
    g = [tree_from_reference(j, "cpu") for j in g_np]
    jg = [_jax_tree(j) for j in g_np]
    modes = ["hierarchical", "hierarchical", "compressed", "compressed"]
    groups = [7, 7, 7, 9]                       # jobs 0 + 1 share port 7's domain
    gs, ge, gb = coll.fleet_sync_grads(g, pod_mesh, modes, groups=groups)
    us, ue, ub = coll.fleet_sync_grads(g, pod_mesh, modes)
    js, je, jb = jcoll.fleet_sync_grads(jg, jmesh, modes, groups=groups)
    for i in range(4):
        assert torch.equal(gs[i]["w"], us[i]["w"])
        _assert_trees_equal(gs[i], js[i])
    assert gb == ub == jb
    assert gb[0] == coll.sync_wire_bytes(g[0], "hierarchical")
    assert gb[2] == coll.sync_wire_bytes(g[2], "compressed")
    assert ge[0] is None and ge[1] is None and ge[2] is not None
    _assert_trees_equal(ge[2], je[2])
    # Re-grouped next step: job 1 joins a compressed domain with no residual
    # of its own (fresh), jobs 2 and 3 carry theirs.
    modes2 = ["hierarchical", "compressed", "compressed", "compressed"]
    groups2 = [7, 9, 9, 9]
    gs2, ge2, _ = coll.fleet_sync_grads(g, pod_mesh, modes2, ge, groups=groups2)
    us2, ue2, _ = coll.fleet_sync_grads(g, pod_mesh, modes2, ue)
    js2, je2, _ = jcoll.fleet_sync_grads(jg, jmesh, modes2, je, groups=groups2)
    for i in range(4):
        assert torch.equal(gs2[i]["w"], us2[i]["w"])
        _assert_trees_equal(gs2[i], js2[i])
    for i in (1, 2, 3):
        assert torch.equal(ge2[i]["w"], ue2[i]["w"])
        _assert_trees_equal(ge2[i], je2[i])
    fresh, _ = coll.sync_grads(g[1], pod_mesh, mode="compressed")
    assert torch.equal(gs2[1]["w"], fresh["w"])
    carried, _ = coll.sync_grads(g[2], pod_mesh, mode="compressed", err_state=ge[2])
    assert torch.equal(gs2[2]["w"], carried["w"])


def test_fleet_sync_grads_checks_its_arguments(pod_mesh):
    g = [tree_from_reference(j, "cpu") for j in _jobs(1, 2)]
    with pytest.raises(ValueError, match="modes"):
        coll.fleet_sync_grads(g, pod_mesh, ["compressed"])
    with pytest.raises(ValueError, match="groups"):
        coll.fleet_sync_grads(g, pod_mesh, ["compressed"] * 2, groups=[0])
    with pytest.raises(ValueError, match="mode"):
        coll.sync_grads(g[0], pod_mesh, mode="ring")


def test_tree_from_reference_keeps_structure_and_dtypes():
    import ml_dtypes

    tree = {"a": [np.arange(6, dtype=np.float32).reshape(2, 3), None],
            "b": (np.array([1.5, -2.25], dtype=ml_dtypes.bfloat16),),
            "c": np.arange(4, dtype=np.int32)}
    got = tree_from_reference(tree, "cpu")
    assert got["a"][1] is None and isinstance(got["b"], tuple)
    assert got["a"][0].dtype == torch.float32 and got["c"].dtype == torch.int32
    assert got["b"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"][0].float().numpy(), [1.5, -2.25])
    np.testing.assert_array_equal(got["a"][0].numpy(), tree["a"][0])


# ---------------------------------------------------------------------------
# sync_grads across gloo processes with a pod axis of 2, 3 or 5
# ---------------------------------------------------------------------------

_TORCH_WORKER = """
    import sys
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist.collectives import sync_grads
    from repro_torch.models.convert import tree_from_reference
    from repro_torch.tree import tree_leaves

    rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    pod, data_ = int(sys.argv[5]), int(sys.argv[6])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, pod * data_), rank=rank,
                            world_size=pod * data_)
    mesh = init_device_mesh("cpu", (pod, data_, 1), mesh_dim_names=("pod", "data", "model"))
    data = np.load(sys.argv[4])
    res = {}
    for mode in ("direct", "hierarchical"):
        g = tree_from_reference({"w": data["w0"], "b": data["b0"]}, "cpu")
        out, _ = sync_grads(g, mesh, mode=mode)
        res[mode + "_w"], res[mode + "_b"] = out["w"].numpy(), out["b"].numpy()
    err = None
    for s in range(2):
        g = tree_from_reference({"w": data[f"w{s}"], "b": data[f"b{s}"]}, "cpu")
        out, err = sync_grads(g, mesh, mode="compressed", err_state=err)
        for k in ("w", "b"):
            res[f"c{s}_{k}"], res[f"e{s}_{k}"] = out[k].numpy(), err[k].numpy()
    if rank == 0:
        np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()
"""

_JAX_SCRIPT = """
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.launch.mesh import make_host_mesh
    from repro.dist.collectives import sync_grads

    mesh = make_host_mesh(pod=int(sys.argv[3]), data=int(sys.argv[4]), model=2)
    data = np.load(sys.argv[2])
    res = {}
    for mode in ("direct", "hierarchical"):
        g = {"w": jnp.asarray(data["w0"]), "b": jnp.asarray(data["b0"])}
        out, _ = sync_grads(g, mesh, mode=mode)
        res[mode + "_w"], res[mode + "_b"] = np.asarray(out["w"]), np.asarray(out["b"])
    err = None
    for s in range(2):
        g = {"w": jnp.asarray(data[f"w{s}"]), "b": jnp.asarray(data[f"b{s}"])}
        out, err = sync_grads(g, mesh, mode="compressed", err_state=err)
        for k in ("w", "b"):
            res[f"c{s}_{k}"], res[f"e{s}_{k}"] = np.asarray(out[k]), np.asarray(err[k])
    np.savez(sys.argv[1], **res)
"""


@pytest.mark.parametrize("pod,data_", [(2, 2), (3, 1), (5, 1), (3, 2), (2, 3)])
def test_sync_grads_pod_of_two_across_processes_matches_jax(tmp_path, pod, data_):
    """``pod · data`` gloo ranks (model=1) against JAX's ``make_host_mesh(pod,
    data, model=2)`` on ``2 · pod · data`` forced host devices, the same
    replicated gradients on every rank: every mode and two compressed steps
    with carried residuals equal bit for bit. Pod and data sizes that are not
    powers of two (3, 5, 6 ranks) hold the order and rounding of the sums:
    XLA's in-order ``psum`` divided by n, and ``jnp.mean``'s in-order sum
    times ``1/n``."""
    world = pod * data_
    rng = np.random.default_rng(12)
    data = {}
    for s in range(2):
        w = rng.normal(size=(64, 32)).astype(np.float32)
        w[3] = 0.0
        data[f"w{s}"], data[f"b{s}"] = w, rng.normal(size=(17,)).astype(np.float32)
    np.savez(tmp_path / "grads.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(SRC) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    (tmp_path / "worker.py").write_text(textwrap.dedent(_TORCH_WORKER))
    (tmp_path / "jax_sync.py").write_text(textwrap.dedent(_JAX_SCRIPT))
    jenv = dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count={2 * world}",
                JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "jax_sync.py"),
                               str(tmp_path / "jax.npz"), str(tmp_path / "grads.npz"),
                               str(pod), str(data_)],
                              env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for rank in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, str(tmp_path / "worker.py"), str(rank), str(tmp_path / "store"),
             str(tmp_path / "torch.npz"), str(tmp_path / "grads.npz"), str(pod), str(data_)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            logs.append(out.decode(errors="replace")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    got, want = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if world & (world - 1) == 0:                                 # replicated mean, exact
        np.testing.assert_array_equal(got["direct_w"], data["w0"])
    else:                                                        # n·w rounds before / n
        np.testing.assert_allclose(got["direct_w"], data["w0"], rtol=1e-6, atol=0)
        assert not np.array_equal(got["direct_w"], data["w0"])
    assert not np.array_equal(got["c0_w"], data["w0"])           # quantized


# ---------------------------------------------------------------------------
# ElasticFleetPlanner (fleet mode)
# ---------------------------------------------------------------------------


def _feed_both(port_fleet, jax_fleet, traffic):
    """Feed both planners ``traffic`` (hours, links) bytes; return them and
    the per-tick modes, asserted equal."""
    pl = ElasticFleetPlanner(port_fleet, device="cpu")
    jpl = JElasticFleetPlanner(jax_fleet)
    for t, b in enumerate(traffic):
        assert pl.feed_hour(b) == jpl.feed_hour(b), f"modes differ at hour {t}"
    return pl, jpl


def _assert_reports_match(pl, jpl):
    rep, jrep = pl.report(), jpl.report()
    assert rep.hours == jrep.hours
    for k in ("cost_always_vpn", "total_gb"):
        assert getattr(rep, k) == getattr(jrep, k), k
    for k in ("on_fraction", "port_occupancy", "pair_gb", "pair_gb_saved"):
        np.testing.assert_array_equal(getattr(rep, k), getattr(jrep, k), err_msg=k)
    np.testing.assert_array_equal(pl.cost_vpn_only, jpl.cost_vpn_only)
    for k in ("total_cost", "cost_always_cci"):
        assert getattr(rep, k) == pytest.approx(getattr(jrep, k), rel=1e-12, abs=0), k
    for a, b in ((rep.link_cost, jrep.link_cost), (pl.cost_cci_only, jpl.cost_cci_only)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    assert rep.wire_savings_fraction == pytest.approx(jrep.wire_savings_fraction, rel=1e-12)
    return rep


def test_elastic_planner_matches_jax_on_the_two_link_fleet():
    """``_planner_fleet()`` of ``tests/test_fleet_runtime.py``: a cold link
    stays compressed, a hot one leases."""
    fleet = fleet_from_params([planner.dci_scenario(), planner.dci_scenario()])
    jfleet = jfleet_from_params([jplanner.dci_scenario(), jplanner.dci_scenario()])
    pl, jpl = _feed_both(fleet, jfleet, np.tile([1e9, 200e12], (1500, 1)))
    rep = _assert_reports_match(pl, jpl)
    assert rep.on_fraction[0] == 0.0 and rep.on_fraction[1] > 0.5
    assert rep.total_cost <= rep.cost_always_cci
    np.testing.assert_array_equal(pl.sync_groups(), [0, 1])


def test_elastic_planner_matches_jax_on_a_scenario_fleet():
    """``build_fleet_scenario(16, horizon=2000)``, fed ``demand·16e9`` bytes
    per hour (at ``demand·1e9`` the compressed path stays cheaper on every
    link and nothing toggles; at 16x the links lease and release)."""
    sc = build_fleet_scenario(16, horizon=2000, seed=0)
    jsc = jscen.build_fleet_scenario(16, horizon=2000, seed=0)
    assert np.array_equal(sc.demand, jsc.demand)
    pl, jpl = _feed_both(sc.fleet, jsc.fleet, sc.demand.T * 16e9)
    rep = _assert_reports_match(pl, jpl)
    assert 0 < rep.on_fraction.mean() < 1 and 0 < rep.wire_savings_fraction < 1


def test_fleet_planner_factory_and_out_of_scope_modes():
    fleet = fleet_from_params([planner.dci_scenario(), planner.dci_scenario()])
    pl = planner.fleet_planner(fleet, device="cpu", compress_ratio=2.0,
                               collective_mode=lambda s: f"s{s}")
    assert isinstance(pl, ElasticFleetPlanner) and not pl.topology
    assert pl.compress_ratio == 2.0 and pl.feed_hour([1e9, 1e9]) == ["s0", "s0"]
    np.testing.assert_array_equal(pl.report().port_occupancy, [1.0, 1.0])
    # A routing beside a FleetSpec is not read (fleet mode, as the JAX
    # resolver); anything but a spec or stacked arrays is refused.
    assert not planner.fleet_planner(fleet, device="cpu", routing=[0, 0]).topology
    with pytest.raises(TypeError, match="FleetSpec"):
        planner.fleet_planner(object(), device="cpu")
    assert ElasticFleetPlanner(fleet, device="cpu", obs=True).runtime.obs is not None


def test_elastic_planner_modes_actuate_the_sync(pod_mesh):
    """The endogenous loop on one rank: the planner's modes select the sync
    path per job, and the billed bytes it returns are ``sync_wire_bytes``."""
    fleet = fleet_from_params([planner.dci_scenario(), planner.dci_scenario()])
    pl = ElasticFleetPlanner(fleet, device="cpu")
    grads = [tree_from_reference(j, "cpu") for j in _jobs(2, 2)]
    errs, billed = None, [1e9, 200e12]
    seen = set()
    for _ in range(120):
        modes = pl.feed_hour(billed)
        seen.add(tuple(modes))
        synced, errs, wire = coll.fleet_sync_grads(grads, pod_mesh, modes, errs,
                                                   groups=pl.sync_groups())
        assert wire == [coll.sync_wire_bytes(g, m) for g, m in zip(grads, modes)]
        billed = [1e9, 200e12]
    assert ("compressed", "hierarchical") in seen and ("compressed", "compressed") in seen
    assert errs[0] is not None and errs[1] is None
