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
import numpy as np
import pytest
import torch

from test_torch_support import CPU, seeded_costs, seeded_tiers, seeded_toggle

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
