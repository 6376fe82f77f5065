"""Synthetic demand traces (paper §VII-D).

* :func:`constant_trace` — fixed GB/hour over a year (8 760 hours): "short
  recurring transfer cycles (e.g., hourly or daily batches for backups), which
  appear almost constant to ToggleCCI".
* :func:`bursty_trace`  — Poisson burst arrivals; burst durations and
  intensities sampled from Gaussians (paper defaults: λ = 1/730 per hour ≈ one
  burst/month, mean duration ≈ one week, mean intensity 400 GB/hour).

A verbatim copy of :mod:`repro.traffic.traces` (numpy only): the port imports nothing
of the JAX package, so the same random streams are consumed in the same
order and the two packages build identical scenarios.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

HOURS_PER_YEAR = 8760


def constant_trace(
    rate_gb_hr: float, horizon: int = HOURS_PER_YEAR, n_pairs: int = 1
) -> np.ndarray:
    """(T, n_pairs) constant-rate demand; rate is the aggregate across pairs."""
    assert rate_gb_hr >= 0
    d = np.full((horizon, n_pairs), rate_gb_hr / n_pairs, dtype=np.float64)
    return d


def bursty_trace(
    *,
    horizon: int = HOURS_PER_YEAR,
    arrival_rate_per_hr: float = 1.0 / 730.0,
    mean_duration_hr: float = 168.0,
    std_duration_hr: float = 42.0,
    mean_intensity_gb_hr: float = 400.0,
    std_intensity_gb_hr: float = 100.0,
    n_pairs: int = 1,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(T, n_pairs) bursty demand. Burst arrivals ~ Poisson(λ); durations and
    intensities ~ Gaussian (clipped at 0/1). Bursts may overlap (superpose)."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    d = np.zeros((horizon, n_pairs), dtype=np.float64)
    t = 0.0
    while True:
        t += rng.exponential(1.0 / arrival_rate_per_hr)
        start = int(t)
        if start >= horizon:
            break
        dur = max(1, int(round(rng.normal(mean_duration_hr, std_duration_hr))))
        stop = min(horizon, start + dur)
        intensity = max(0.0, rng.normal(mean_intensity_gb_hr, std_intensity_gb_hr))
        pair = rng.integers(n_pairs)
        # Hour-level jitter within the burst keeps it realistic but stationary.
        jitter = rng.normal(1.0, 0.05, size=stop - start).clip(0.5, 1.5)
        d[start:stop, pair] += intensity * jitter
    return d
