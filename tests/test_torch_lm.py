"""The port's LM serving path against the JAX package, on the CPU.

Reduced TinyLlama (``d_model=128, n_heads=8``: 8 query heads over 4 KV
heads, a GQA group of 2) and reduced H2O-Danube3 (window 32, so prompts
longer than 32 run the ring cache and the sliding mask), seeds 0 and 1,
float32 throughout. The JAX parameters go through ``params_from_reference``
into the port, which runs the plain versions of its kernels here. Logits of
``forward``, ``prefill`` and a decode chain at ``rtol=atol=1e-4`` (the two
sum in different orders: XLA's chunked attention and dot kernels against
PyTorch's); greedy tokens equal.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import test_torch_support  # noqa: F401  (the enable_x64 alias, before repro)

import jax
import jax.numpy as jnp

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.train.serve import greedy_generate as jgreedy_generate

from repro_torch.configs import REGISTRY, get_config, reduce_config
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import lm
from repro_torch.models.convert import params_from_reference
from repro_torch.train.serve import greedy_generate, make_decode_step, make_prefill

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = {"tinyllama-1.1b": dict(d_model=128, n_heads=8), "h2o-danube-3-4b": {}}
PROMPT = 48          # longer than the reduced window (32)
NEW = 8


def _pair(arch, seed):
    jcfg = jreduce_config(jget_config(arch), **ARCHS[arch])
    cfg = reduce_config(get_config(arch), **ARCHS[arch])
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = lm.LM(cfg, device="cpu")
    model.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    return jcfg, cfg, params, model, tokens


def test_reduced_configs_have_the_intended_shapes():
    tiny = reduce_config(get_config("tinyllama-1.1b"), **ARCHS["tinyllama-1.1b"])
    assert (tiny.n_heads, tiny.n_kv_heads, tiny.hd) == (8, 4, 16)
    danube = reduce_config(get_config("h2o-danube-3-4b"))
    assert danube.window == 32 and PROMPT > danube.window


@pytest.mark.parametrize("arch", sorted(JREGISTRY))
def test_configs_are_copies_of_the_reference(arch):
    assert dataclasses.asdict(REGISTRY[arch]) == dataclasses.asdict(JREGISTRY[arch])
    assert dataclasses.asdict(reduce_config(get_config(arch))) == dataclasses.asdict(
        jreduce_config(jget_config(arch)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch, seed):
    jcfg, cfg, params, model, tokens = _pair(arch, seed)
    want, _ = jlm.forward(jcfg, params, jnp.asarray(tokens))
    got, _ = lm.forward(cfg, model, torch.as_tensor(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, PROMPT, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    last, _ = lm.forward(cfg, model, torch.as_tensor(tokens).long(), logits_mode="last")
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_chain_match_reference(arch, seed):
    """Prefill, then NEW decode steps fed the same (teacher-forced) tokens."""
    jcfg, cfg, params, model, tokens = _pair(arch, seed)
    forced = np.random.default_rng(seed + 10).integers(0, cfg.vocab, (2, NEW)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, PROMPT + NEW)
    jstep = jax.jit(functools.partial(jlm.decode_step, jcfg))
    jlogits, jcache = jlm.prefill(jcfg, params, jnp.asarray(tokens), jcache)
    cache = lm.init_cache(cfg, 2, PROMPT + NEW, device="cpu")
    prefill, step = make_prefill(cfg), make_decode_step(cfg)
    logits, cache = prefill(model, torch.as_tensor(tokens).long(), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert cache["index"] == PROMPT
    for t in range(NEW):
        tok = forced[:, t:t + 1]
        jlogits, jcache = jstep(params, jnp.asarray(tok), jcache)
        logits, cache = step(model, torch.as_tensor(tok).long(), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jc, c = jcache["segments"][0][0], cache["layers"][0]
    np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["pos"][0]))
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"][0]), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_generate_matches_reference(arch, seed):
    jcfg, cfg, params, model, tokens = _pair(arch, seed)
    want = np.asarray(jgreedy_generate(jcfg, params, jnp.asarray(tokens), NEW))
    got = greedy_generate(cfg, model, torch.as_tensor(tokens), NEW)
    assert got.dtype == torch.int32 and got.shape == (2, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rope_matches_reference():
    pos = np.arange(5, 37)
    jc, js = jcommon.rope_tables(jnp.asarray(pos), 16, 1e4)
    tc, ts = tcommon.rope_tables(torch.as_tensor(pos), 16, 1e4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(3).standard_normal((2, 3, 32, 16)).astype(np.float32)
    want = jcommon.apply_rope(jnp.asarray(x), jc, js)
    got = tcommon.apply_rope(torch.as_tensor(x), tc, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gelu_ffn_matches_reference():
    """The ungated (GELU) dense FFN, which no dense config uses yet."""
    from repro.models import ffn as jffn

    cfg = reduce_config(get_config("tinyllama-1.1b"))
    p = jffn.dense_ffn_init(jax.random.PRNGKey(2), jreduce_config(jget_config("tinyllama-1.1b")),
                            gated=False)
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = jffn.dense_ffn_apply(p, jnp.asarray(x))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    got = tffn.dense_ffn_apply(tp, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_full_size_param_count_matches_reference():
    cfg = get_config("tinyllama-1.1b")
    model = lm.LM(cfg, device="meta")
    assert tcommon.count_params(model) == jlm.param_count(jget_config("tinyllama-1.1b"))
    assert lm.param_count(cfg) == tcommon.count_params(model)
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "xlstm-1.3b",
                                  "whisper-tiny", "internvl2-2b", "jamba-v0.1-52b"])
def test_other_families_raise(arch):
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        lm.LM(reduce_config(get_config(arch)), device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "jamba-v0.1-52b"])
def test_moe_families_with_unported_mixers_raise(arch):
    """MoE is ported, but DeepSeek-V3 (MLA, MTP) and Jamba (Mamba mixers)
    still raise at every entry point."""
    cfg = reduce_config(get_config(arch))
    assert any(kind.ffn == "moe" for kind in cfg.layer_kinds())
    for fn in (lambda: lm.LM(cfg, device="cpu"), lambda: lm.init_cache(cfg, 1, 8, device="cpu"),
               lambda: params_from_reference(cfg, {})):
        with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
            fn()


def test_unported_mixers_raise():
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    for fn in (lambda: tattn.mla_apply(cfg, {}, None), lambda: tattn.xattn_apply(cfg, {}, None, None)):
        with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
            fn()


def test_entry_points_raise_without_cuda(monkeypatch):
    cfg = reduce_config(get_config("tinyllama-1.1b"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 1, 8)
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "1"])


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--requests", "2", "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "request batch 1: generated (4, 4) tokens" in out and "on cpu" in out
