"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it runs on the GPU
host as it is::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` need an NVIDIA GPU and skip on a host without one
(the kernels are CUDA C++ and have no CPU mode). Tolerances: the float64
tiered kernel and the FSM kernel keep the plain versions' order of
operations and are held bit for bit (the FSM against the plain version on
the CPU, whose cumsum is sequential); the float32 tiered kernel at
``rtol=atol=1e-6``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pricing import (
    AWS_EGRESS_INTERNET,
    GCP_EGRESS_PREMIUM,
    GCP_EGRESS_STANDARD,
    flat_rate,
)
from repro_torch.core.togglecci import ToggleParams
from repro_torch.fleet import build_fleet_scenario, plan_fleet
from repro_torch.fleet import policy as tpol
from repro_torch.fleet.spec import pad_tier_tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fsm_scan import fsm_scan
from repro_torch.kernels.tiered_cost import tiered_cost_batched

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    """The GPU; skips on a host without one (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _t(a, device=CPU):
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _tiers(seed, n, T, dtype):
    tiers = [GCP_EGRESS_PREMIUM, AWS_EGRESS_INTERNET, GCP_EGRESS_STANDARD, flat_rate(0.1)]
    bounds, rates = pad_tier_tables([tiers[i % len(tiers)] for i in range(n)])
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 400.0, size=(n, T))
    cum = np.cumsum(d, axis=1) - d
    return tuple(np.asarray(a, dtype) for a in (cum, d, bounds, rates))


def _fsm_inputs(seed, n, T):
    rng = np.random.default_rng(seed)
    vpn = rng.uniform(5.0, 50.0, size=(n, T))
    regime = np.repeat(rng.uniform(0.6, 1.4, size=(n, T // 40 + 1)), 40, axis=1)[:, :T]
    cci = vpn * regime * rng.uniform(0.95, 1.05, size=(n, T))
    tog = {
        "theta1": rng.uniform(0.85, 0.95, n),
        "theta2": rng.uniform(1.05, 1.2, n),
        "h": rng.choice([1, 5, 24, 72], n).astype(np.int32),
        "D": np.resize(np.array([0, 3, 10, 0], np.int32), n),
        "T_cci": np.resize(np.array([1, 5, 24, 1, 12], np.int32), n),
    }
    return vpn, cci, tog


def _policy(kind, tog, renew, device):
    tp = ToggleParams(**{k: _t(v, device) for k, v in tog.items()})
    if kind == "reactive":
        return tpol.reactive_policy(tp, renew_in_chunks=renew)
    h = _t(np.resize(np.array([1, 2, 3, 6], np.int32), len(tog["h"])), device)
    return tpol.HysteresisPolicy(tp, h, h.flip(0).contiguous(), renew)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch on CUDA tensors or raise; they never compute on
    the CPU themselves (the dispatcher sends CPU tensors to ref.py)."""
    cum, d, b, r = (_t(a) for a in _tiers(0, 2, 8, np.float64))
    with pytest.raises(ValueError, match="CUDA"):
        tiered_cost_batched(cum, d, b, r)
    vpn, cci, tog = _fsm_inputs(0, 2, 8)
    one = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fsm_scan(_t(vpn), _t(cci), *(_t(tog[k]) for k in ToggleParams._fields), one, one)


@pytest.mark.cuda
def test_tiered_kernel_matches_plain(cuda_device):
    for dtype in (np.float64, np.float32):
        args = _tiers(8, 64, 3000, dtype)
        before = ops.LAUNCHES["tiered_cost_batched"]
        got = ops.tiered_cost_batched(*(_t(a, cuda_device) for a in args)).cpu()
        want = ref.tiered_cost_batched_ref(*(_t(a) for a in args))
        assert ops.LAUNCHES["tiered_cost_batched"] == before + 1
        assert got.dtype == want.dtype
        if dtype == np.float64:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_tiered_kernel_checks_its_inputs(cuda_device):
    cum, d, b, r = (_t(a, cuda_device) for a in _tiers(1, 4, 16, np.float64))
    with pytest.raises(ValueError, match="shapes"):
        tiered_cost_batched(cum, d[:, :8].contiguous(), b, r)
    with pytest.raises(ValueError, match="one dtype"):
        tiered_cost_batched(cum, d.float(), b, r)
    with pytest.raises(ValueError, match="contiguous"):
        tiered_cost_batched(cum.t().contiguous().t(), d, b, r)
    with pytest.raises(TypeError):
        tiered_cost_batched(cum.half(), d.half(), b.half(), r.half())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["reactive", "hysteresis"])
def test_fsm_kernel_bit_equal_to_cpu_plain(cuda_device, kind):
    """Same inputs: the kernel's in-order prefixes equal the CPU's sequential
    cumsum, so every output agrees bit for bit."""
    vpn, cci, tog = _fsm_inputs(9, 40, 2000)
    for renew in (False, True):
        before = ops.LAUNCHES["fsm_scan"]
        got = tpol.policy_scan(_policy(kind, tog, renew, cuda_device),
                               _t(vpn, cuda_device), _t(cci, cuda_device))
        assert ops.LAUNCHES["fsm_scan"] == before + 1
        want = tpol.policy_scan(_policy(kind, tog, renew, CPU), _t(vpn), _t(cci))
        assert 0 < int(want["x"].sum()) < want["x"].numel()   # the rows do toggle
        for k in ("x", "state", "total_cost"):
            assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_plan_fleet_gpu_matches_cpu(cuda_device):
    sc = build_fleet_scenario(16, horizon=2000, seed=0)
    ops.reset_launches()
    got = plan_fleet(sc.fleet, sc.demand, device=cuda_device)
    assert ops.LAUNCHES == {"tiered_cost_batched": 1, "fsm_scan": 1}
    assert got["x"].is_cuda
    want = plan_fleet(sc.fleet, sc.demand, device="cpu")
    for k in ("x", "state"):
        assert torch.equal(got[k].cpu(), want[k]), k
    for k in ("toggle_cost", "vpn_hourly", "cci_hourly"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-9, atol=1e-9)
