"""Puffer-like workload generator (paper §VII-C).

The Stanford Puffer dataset (live/on-demand ABR video streaming traces) is not
available offline; this generator matches the paper's characterization:

* "stable, session-based traffic with observable daily and weekly cycles";
* seven video channels, each assigned to a distinct (European) region pair,
  transfers GCP -> AWS;
* hourly aggregation.

Model: per channel, concurrent-viewer count follows a smooth diurnal × weekly
envelope with mild stochastic modulation (AR(1) in log-space), times a mean
per-viewer bitrate (ABR mix ≈ 2.7 GB/hour-viewer at ~6 Mbps average).

A verbatim copy of :mod:`repro.traffic.puffer` (numpy only): the port imports nothing
of the JAX package, so the same random streams are consumed in the same
order and the two packages build identical scenarios.
"""
from __future__ import annotations

import numpy as np

HOURS_PER_DAY = 24
N_CHANNELS = 7

# Viewer diurnal envelope (fraction of channel peak audience by local hour).
_DIURNAL = np.array(
    [0.25, 0.15, 0.10, 0.08, 0.08, 0.10, 0.18, 0.30, 0.40, 0.45, 0.50, 0.55,
     0.60, 0.60, 0.58, 0.60, 0.65, 0.75, 0.90, 1.00, 0.95, 0.80, 0.60, 0.40]
)
# Weekly envelope (Mon..Sun multipliers — weekend evenings are busier).
_WEEKLY = np.array([0.92, 0.94, 0.95, 0.97, 1.05, 1.15, 1.10])

GB_PER_VIEWER_HOUR = 2.7  # ~6 Mbps ABR average


def puffer_trace(
    *,
    horizon_days: int = 365,
    n_channels: int = N_CHANNELS,
    peak_viewers: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """(horizon_days*24, n_channels) hourly GB per channel (= per region pair)."""
    rng = np.random.default_rng(seed)
    T = horizon_days * HOURS_PER_DAY
    hours = np.arange(T)
    hod = hours % HOURS_PER_DAY
    dow = (hours // HOURS_PER_DAY) % 7

    # Per-channel popularity spread (Zipf-ish).
    popularity = (1.0 / (1.0 + np.arange(n_channels))) ** 0.7
    out = np.zeros((T, n_channels))
    for c in range(n_channels):
        # AR(1) log-modulation: stable sessions, slow drift.
        eps = rng.normal(0, 0.05, size=T)
        mod = np.empty(T)
        mod[0] = 0.0
        for t in range(1, T):
            mod[t] = 0.98 * mod[t - 1] + eps[t]
        viewers = (
            peak_viewers
            * popularity[c]
            * _DIURNAL[hod]
            * _WEEKLY[dow]
            * np.exp(mod)
        )
        out[:, c] = viewers * GB_PER_VIEWER_HOUR
    return out
