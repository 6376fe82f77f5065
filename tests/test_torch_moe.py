"""The port's MoE layer against the JAX package, on the CPU.

``moe_apply`` against :func:`repro.models.ffn.moe_apply` at ``reduce_config``
shapes in float32 (4 experts, top-2, group 64): the softmax router
(Mixtral), the sigmoid router with a shared expert (DeepSeek-V3), one and
two groups a row, and forced drops (capacity factor 0.25, where a keep
decision that differed would move y by O(1)). y and the aux loss at
``rtol=atol=1e-5``: the two sum the router and expert products in
different orders. The routing decisions (``gate_idx``, ``pos``, ``keep``
and the capacity map) equal, element for element, a jnp recomputation of
the reference's top-k and in-order slot count (``src/repro/models/
ffn.py:86``, ``:95-100``) on the same logits, the all-zero router's ties
and coarse ties included; ``gate_w`` at ``rtol=1e-6``. The plain dispatch
and combine equal the reference's scatter-add and weighted gather
(``:110-115``, ``:128-131``). Reduced Mixtral's ``forward``, ``prefill``
with a decode chain (at ``capacity_factor = n_experts``, where decode drops
nothing) and ``greedy_generate`` match ``repro.models.lm`` and
``repro.train.serve`` at ``test_torch_lm.py``'s ``TOL``. The port runs the
plain versions of its kernels here; the kernels themselves are held against
those in ``tests/test_torch_cuda.py -k moe`` on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (the enable_x64 alias, before repro)

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.train.serve import greedy_generate as jgreedy_generate

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import ops, ref
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import lm
from repro_torch.models.convert import params_from_reference
from repro_torch.train.serve import greedy_generate, make_decode_step, make_prefill

TOL = dict(rtol=1e-4, atol=1e-4)        # test_torch_lm.py's, for the LM's logits
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "mixtral-8x7b"
ROUTERS = {"softmax": "mixtral-8x7b", "sigmoid": "deepseek-v3-671b"}   # the shared expert too
PROMPT, NEW = 48, 8


def _configs(arch, **moe):
    jcfg, cfg = jreduce_config(jget_config(arch)), reduce_config(get_config(arch))
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    return jcfg, cfg


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(np.asarray(v))
            for k, v in tree.items()}


def _jnp_decisions(logits, k, C, router):
    """The reference's routing decisions (``ffn.py:84-100``), vmapped over
    groups: gate_idx, gate_w, pos, keep."""
    E = logits.shape[-1]

    def one(lg):
        scores = jax.nn.sigmoid(lg) if router == "sigmoid" else jax.nn.softmax(lg, axis=-1)
        gate_w, gate_idx = jax.lax.top_k(scores, k)
        gate_w = gate_w / jnp.maximum(gate_w.sum(-1, keepdims=True), 1e-9)
        slot_e = gate_idx.reshape(-1)
        onehot = jax.nn.one_hot(slot_e, E, dtype=jnp.int32)
        pos_all = jnp.cumsum(onehot, axis=0) - onehot
        pos = jnp.take_along_axis(pos_all, slot_e[:, None], axis=1)[:, 0]
        return gate_idx, gate_w, pos, pos < C

    return [np.asarray(a) for a in jax.vmap(one)(jnp.asarray(logits))]


# -- the layer --------------------------------------------------------------


@pytest.mark.parametrize("capacity_factor", [None, 0.25], ids=["cf-default", "cf-0.25"])
@pytest.mark.parametrize("S", [64, 128], ids=["one-group", "two-groups"])
@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_apply_matches_reference(router, S, capacity_factor):
    kw = {} if capacity_factor is None else dict(capacity_factor=capacity_factor)
    jcfg, cfg = _configs(ROUTERS[router], **kw)
    assert cfg.moe.router == router and cfg.moe.group_size == 64
    assert bool(cfg.moe.n_shared) == (router == "sigmoid")
    p = jffn.moe_init(jax.random.PRNGKey(S + 7), jcfg)
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want_y, want_aux = jffn.moe_apply(jcfg, p, jnp.asarray(x))
    tp = _torch_tree(p)
    assert tp["router"].dtype == torch.float32
    got_y, got_aux = tffn.moe_apply(cfg, tp, torch.as_tensor(x))
    assert got_y.shape == x.shape and got_y.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **MOE_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **MOE_TOL)
    if router == "sigmoid":
        assert float(got_aux) == 0.0
    if capacity_factor is not None:   # the capacity really drops slots
        G, g = 2 * S // 64, 64
        logits = torch.as_tensor(x).reshape(G, g, -1) @ tp["router"]
        r = ops.moe_route(logits, cfg.moe.top_k, tffn.capacity(cfg, g), router=router)
        assert tffn.capacity(cfg, g) == 8 and int((~r.keep).sum()) > g


def test_moe_apply_refuses_ragged_groups():
    _, cfg = _configs(ARCH)
    p = tffn.moe_init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the MoE group"):
        tffn.moe_apply(cfg, p, torch.zeros((1, 96, cfg.d_model)))


@pytest.mark.parametrize("router", sorted(ROUTERS))
def test_moe_apply_without_aux_gives_the_same_y(router):
    """Decode drops the aux loss: ``with_aux=False`` gives None in its place
    and the same y."""
    _, cfg = _configs(ROUTERS[router])
    p = tffn.moe_init(cfg, torch.Generator().manual_seed(1), torch.device("cpu"))
    x = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    y, aux = tffn.moe_apply(cfg, p, torch.as_tensor(x))
    y_no, no_aux = tffn.moe_apply(cfg, p, torch.as_tensor(x), with_aux=False)
    assert no_aux is None and aux.dim() == 0 and torch.equal(y, y_no)


@pytest.mark.parametrize("fn", ["moe_scores_ref", "moe_route_ref"])
def test_unknown_router_raises(fn):
    args = (2, 8) if fn == "moe_route_ref" else ()
    with pytest.raises(ValueError, match="unknown router 'relu'"):
        getattr(ref, fn)(torch.zeros((1, 4, 4)), *args, router="relu")


def test_dense_forward_aux_is_a_python_zero():
    """A dense model's aux loss is the Python 0.0: no device work for it."""
    cfg = reduce_config(get_config("tinyllama-1.1b"), d_model=128, n_heads=8)
    model = lm.LM(cfg, device="cpu")
    _, extras = lm.forward(cfg, model, torch.zeros((1, 8), dtype=torch.long))
    assert type(extras["aux"]) is float and extras["aux"] == 0.0


def test_moe_init_shapes_and_router_dtype():
    cfg = get_config("deepseek-v3-671b")
    cfg = dataclasses.replace(cfg, d_model=64, moe=dataclasses.replace(cfg.moe, n_experts=8,
                                                                       d_ff_expert=32))
    p = tffn.moe_init(cfg, torch.Generator().manual_seed(0), torch.device("meta"))
    assert p["router"].shape == (64, 8) and p["router"].dtype == torch.float32
    assert p["wg"].shape == p["wi"].shape == (8, 64, 32) and p["wo"].shape == (8, 32, 64)
    assert p["wg"].dtype == torch.bfloat16
    assert {k: v.shape for k, v in p["shared"].items()} == {
        "wg": (64, 32), "wi": (64, 32), "wo": (32, 64)}


# -- the routing decisions --------------------------------------------------

ROUTE_CASES = {
    # name: (G, N, E, k, C, router, logits)
    "softmax": (3, 64, 4, 2, 40, "softmax", "normal"),
    "softmax-drops": (2, 64, 8, 2, 8, "softmax", "normal"),
    "sigmoid-256x8": (2, 32, 256, 8, 10, "sigmoid", "normal"),
    "zero-router": (2, 64, 8, 2, 20, "softmax", "zeros"),
    "coarse-ties": (2, 96, 8, 3, 30, "softmax", "coarse"),
    "coarse-ties-sigmoid": (2, 96, 16, 4, 12, "sigmoid", "coarse"),
}


def _logits(case, seed=0):
    G, N, E, k, C, router, kind = ROUTE_CASES[case]
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros((G, N, E), np.float32)
    if kind == "coarse":   # few distinct values: equal logits give equal scores
        return rng.choice(np.float32([-1.0, 0.0, 0.5]), size=(G, N, E))
    return rng.standard_normal((G, N, E)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routing_decisions_match_reference(case):
    G, N, E, k, C, router, _ = ROUTE_CASES[case]
    logits = _logits(case)
    gate_idx, gate_w, pos, keep = _jnp_decisions(logits, k, C, router)
    r = ops.moe_route(torch.as_tensor(logits), k, C, router=router, aux_coef=0.01)
    np.testing.assert_array_equal(r.gate_idx.numpy(), gate_idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gate_w.numpy(), gate_w, rtol=1e-6, atol=0)
    src = np.full((G, E, C), -1, np.int32)
    for g in range(G):
        for s in np.flatnonzero(keep[g]):
            src[g, gate_idx[g].reshape(-1)[s], pos[g, s]] = s
    np.testing.assert_array_equal(r.src.numpy(), src)
    if case == "zero-router":          # every token picks experts 0 then 1; most slots drop
        assert (gate_idx == [0, 1]).all()
        np.testing.assert_array_equal(pos, np.repeat(np.arange(N), k)[None].repeat(G, 0))
        assert int((~keep).sum()) == G * k * (N - C)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_aux_loss_matches_reference(router):
    logits = np.random.default_rng(3).standard_normal((3, 64, 8)).astype(np.float32)
    r = ops.moe_route(torch.as_tensor(logits), 2, 20, router=router, aux_coef=0.01)
    if router == "sigmoid":
        assert not r.aux.any()
        return
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    _, gate_idx = jax.lax.top_k(probs, 2)
    density = jax.nn.one_hot(gate_idx[..., 0], 8, dtype=jnp.float32).mean(1)
    want = 0.01 * 8 * jnp.sum(density * probs.mean(1), axis=-1)
    np.testing.assert_allclose(r.aux.numpy(), np.asarray(want), rtol=1e-6)


def test_top_k_ties_on_rounded_scores_take_the_lower_expert():
    """Top-k compares the scores, not the logits: equal scores (here given
    directly) go lower expert first, whatever the order they sit in."""
    probs = torch.tensor([[[0.1, 0.3, 0.2, 0.3, 0.1]]])
    r = ref.moe_decide_ref(probs, 3, 8)
    assert r.gate_idx.tolist() == [[[1, 3, 2]]]
    # two logits one ulp apart whose sigmoid scores both round to 1.0: the
    # lower expert first although its logit is the smaller, as in JAX
    a = np.float32(20.0)
    logits = np.array([[[0.0, np.nextafter(a, np.float32(0)), a, 0.0]]], np.float32)
    r = ops.moe_route(torch.as_tensor(logits), 2, 8, router="sigmoid")
    assert r.probs[0, 0, 1] == r.probs[0, 0, 2] == 1.0
    assert r.gate_idx.tolist() == [[[1, 2]]]
    np.testing.assert_array_equal(_jnp_decisions(logits, 2, 8, "sigmoid")[0], [[[1, 2]]])


def test_plain_dispatch_and_combine_match_the_reference_scatter_and_gather():
    G, N, E, k, C, d = 2, 64, 4, 2, 24, 16
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((G, N, E)).astype(np.float32)
    x = rng.standard_normal((G, N, d)).astype(np.float32)
    out = rng.standard_normal((E, G, C, d)).astype(np.float32)
    r = ops.moe_route(torch.as_tensor(logits), k, C)
    assert int((~r.keep).sum()) > 0
    buf = ops.moe_dispatch(torch.as_tensor(x), r.src, k)
    y = ops.moe_combine(torch.as_tensor(out), r.gate_idx, r.pos, r.keep, r.gate_w)
    assert buf.shape == (E, G, C, d) and y.shape == (G, N, d)
    for g in range(G):
        slot_e = jnp.asarray(r.gate_idx[g].numpy().reshape(-1))
        keep = jnp.asarray(r.keep[g].numpy())
        pos_c = jnp.minimum(jnp.asarray(r.pos[g].numpy()), C - 1)
        x_rep = jnp.where(keep[:, None], jnp.repeat(jnp.asarray(x[g]), k, axis=0), 0)
        want_buf = jnp.zeros((E, C, d), jnp.float32).at[slot_e, pos_c].add(x_rep)
        np.testing.assert_array_equal(buf[:, g].numpy(), np.asarray(want_buf))
        y_slots = jnp.asarray(out[:, g])[slot_e, pos_c]
        w = (jnp.asarray(r.gate_w[g].numpy()).reshape(-1) * keep).astype(y_slots.dtype)
        want_y = (y_slots * w[:, None]).reshape(N, k, d).sum(axis=1)
        np.testing.assert_allclose(y[g].numpy(), np.asarray(want_y), rtol=1e-6, atol=1e-7)


def test_moe_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.moe_route(torch.zeros((1, 4, 4), device="meta"), 2, 8)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.moe_dispatch(torch.zeros((1, 4, 8), device="meta"),
                         torch.zeros((1, 4, 8), dtype=torch.int32), 2)


# -- the model: reduced Mixtral against the JAX LM --------------------------


def _pair(seed, **moe):
    jcfg, cfg = _configs(ARCH, **moe)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    return jcfg, cfg, params, model, tokens


def test_reduced_mixtral_has_the_intended_shape():
    cfg = reduce_config(get_config(ARCH))
    assert cfg.layer_kinds() == [lm.MOE_GQA] * 2 and cfg.moe.n_experts == 4
    assert cfg.window == 32 and PROMPT > cfg.window and PROMPT <= cfg.moe.group_size


def test_converted_router_stays_float32():
    _, cfg, _, model, _ = _pair(0)
    sd = model.state_dict()
    assert sd["layers.0.ffn.router"].dtype == torch.float32
    assert sd["layers.1.ffn.wg"].shape == (4, cfg.d_model, cfg.moe.d_ff_expert)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    jcfg, cfg, params, model, tokens = _pair(seed)
    want, jextras = jlm.forward(jcfg, params, jnp.asarray(tokens))
    got, extras = lm.forward(cfg, model, torch.as_tensor(tokens).long())
    assert got.shape == (2, PROMPT, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert extras["aux"].dtype == torch.float32 and float(extras["aux"]) > 0
    np.testing.assert_allclose(float(extras["aux"]), float(jextras["aux"]), **MOE_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefill_and_decode_chain_match_reference(seed):
    """Prefill, then NEW decode steps fed the same tokens, at capacity
    factor n_experts (decode's one-token groups never drop)."""
    jcfg, cfg, params, model, tokens = _pair(seed, capacity_factor=4.0)
    forced = np.random.default_rng(seed + 10).integers(0, cfg.vocab, (2, NEW)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, PROMPT + NEW)
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg))
    jlogits, jcache = jlm.prefill(jcfg, params, jnp.asarray(tokens), jcache)
    cache = lm.init_cache(cfg, 2, PROMPT + NEW, device="cpu")
    prefill, step = make_prefill(cfg), make_decode_step(cfg)
    logits, cache = prefill(model, torch.as_tensor(tokens).long(), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for t in range(NEW):
        tok = forced[:, t:t + 1]
        jlogits, jcache = jstep(params, jnp.asarray(tok), jcache)
        logits, cache = step(model, torch.as_tensor(tok).long(), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_decode_matches_forward_without_drops():
    """The port's own decode chain against its forward over the same tokens
    at capacity factor n_experts (``tests/test_models.py``'s MoE case)."""
    _, cfg, _, model, tokens = _pair(2, capacity_factor=4.0)
    full, _ = lm.forward(cfg, model, torch.as_tensor(tokens).long())
    cache = lm.init_cache(cfg, 2, PROMPT, device="cpu")
    outs = []
    for t in range(PROMPT):
        logits, cache = lm.decode_step(cfg, model, torch.as_tensor(tokens[:, t:t + 1]).long(),
                                       cache)
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_generate_matches_reference(seed):
    jcfg, cfg, params, model, tokens = _pair(seed)
    want = np.asarray(jgreedy_generate(jcfg, params, jnp.asarray(tokens), NEW))
    got = greedy_generate(cfg, model, torch.as_tensor(tokens), NEW)
    assert got.dtype == torch.int32 and got.shape == (2, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_size_param_count_matches_reference():
    cfg = get_config(ARCH)
    model = lm.LM(cfg, device="meta")
    assert tcommon.count_params(model) == jlm.param_count(jget_config(ARCH))
    assert lm.param_count(cfg) == tcommon.count_params(model)
    assert round(lm.param_count(cfg) / 1e9, 1) == 46.7
    routers = [n for n, _ in model.named_parameters() if n.endswith("ffn.router")]
    assert len(routers) == cfg.n_layers
    assert all(p.dtype == (torch.float32 if n.endswith("router") else torch.bfloat16)
               for n, p in model.named_parameters())


def test_launcher_serves_mixtral_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--arch", ARCH, "--requests", "2", "--prompt-len", "8",
          "--max-new", "4"])
    out = capsys.readouterr().out
    assert "request batch 1: generated (4, 4) tokens" in out and "on cpu" in out
