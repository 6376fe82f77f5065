"""Shared helpers for the PyTorch port's parity tests, and the port's
isolation tests.

The JAX package is the oracle the port is held against. On JAX releases
that dropped ``jax.experimental.enable_x64`` its fleet modules cannot be
imported; the alias below restores the name (to ``jax.enable_x64``, the
same context manager) without changing the package. Test files of the port
import this module before anything of ``repro``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = torch.device("cpu")


def seeded_costs(seed: int, n: int, T: int):
    """(n, T) float64 VPN and CCI hourly cost rows whose ratio switches
    regime every few dozen hours, so every FSM row toggles."""
    rng = np.random.default_rng(seed)
    vpn = rng.uniform(5.0, 50.0, size=(n, T))
    regime = np.repeat(rng.uniform(0.6, 1.4, size=(n, T // 40 + 1)), 40, axis=1)[:, :T]
    cci = vpn * regime * rng.uniform(0.95, 1.05, size=(n, T))
    return vpn, cci


def seeded_toggle(seed: int, n: int):
    """Per-row ToggleCCI parameters as numpy arrays, with D = 0 and
    T_cci = 1 rows among them."""
    rng = np.random.default_rng(seed + 1000)
    return {
        "theta1": rng.uniform(0.85, 0.95, n),
        "theta2": rng.uniform(1.05, 1.2, n),
        "h": rng.choice([1, 5, 24, 72], n).astype(np.int32),
        "D": np.resize(np.array([0, 3, 10, 0], np.int32), n),
        "T_cci": np.resize(np.array([1, 5, 24, 1, 12], np.int32), n),
    }


def seeded_tiers(seed: int, n: int, T: int, dtype=np.float64):
    """Month-to-date volume, demand and padded (n, 4) tier tables."""
    from repro.core.pricing import (
        AWS_EGRESS_INTERNET,
        GCP_EGRESS_PREMIUM,
        GCP_EGRESS_STANDARD,
        flat_rate,
    )
    from repro.fleet.spec import pad_tier_tables

    tiers = [GCP_EGRESS_PREMIUM, AWS_EGRESS_INTERNET, GCP_EGRESS_STANDARD,
             flat_rate(0.1)]
    bounds, rates = pad_tier_tables([tiers[i % len(tiers)] for i in range(n)])
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 400.0, size=(n, T))
    cum = np.cumsum(d, axis=1) - d
    cast = lambda a: np.asarray(a, dtype)
    return cast(cum), cast(d), cast(bounds), cast(rates)


def jax_fleet_dict(arrays) -> dict:
    """``np.asarray`` of every field of a JAX ``FleetArrays``, with the
    toggle parameters flattened — the input of ``fleet_arrays_from_numpy``."""
    d = {k: np.asarray(v) for k, v in arrays._asdict().items() if k != "toggle"}
    d.update({k: np.asarray(v) for k, v in arrays.toggle._asdict().items()})
    return d


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch imports without jax and without repro."""
    code = (
        "import pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(SRC)}, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device and no CUDA: the port raises instead of running on the CPU."""
    from repro_torch.fleet import build_fleet_scenario, plan_fleet
    from repro_torch.fleet.spec import fleet_arrays_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = build_fleet_scenario(4, horizon=48, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_fleet(sc.fleet, sc.demand)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sc.fleet.stack()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_arrays_from_numpy({}, None)


def test_dispatch_refuses_devices_without_a_kernel():
    """Only CPU tensors reach the plain versions; other devices raise."""
    from repro_torch.kernels import ops

    z = torch.empty((2, 3), dtype=torch.float64, device="meta")
    b = torch.empty((2, 1), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.tiered_cost_batched(z, z, b, b)


def test_missing_nvcc_fails_the_build(monkeypatch, tmp_path):
    """A kernel build that cannot run raises; nothing falls back."""
    from repro_torch.kernels import _lib

    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.load()
