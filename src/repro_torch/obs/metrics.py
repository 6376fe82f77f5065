"""The metrics ring of the streaming runtime, updated on the host.

Port of :mod:`repro.obs.metrics`: the same fields, layout, drain vector and
semantics, as plain functions on torch tensors of any device.

**Where the ring lives: on the host.** The reference keeps its ring on the
device, updated inside the jitted tick, so that its drain rides the tick's
one packed D2H transfer. The port's chunk already brings home every plane
the ring reads: the (K, M) ``x``, ``state``, ``vpn`` and ``cci`` planes
(and, in live mode, ``pred``) that :meth:`FleetRuntime._commit
<repro_torch.fleet.runtime.FleetRuntime._commit>` unpacks, and the host
holds the demand block it packed. So the runtime updates the ring after
each chunk with :func:`update_ring_chunk`, on CPU tensors that share memory
with those numpy planes: no extra transfer, and no device ring to drain.
The start-of-hour month volume the tier buckets read is formed on the host
from the pre-chunk calendar with the chunk kernels' own adds in their order
(a parallel cumsum on the device could flip a tier), so the card's drains
equal the CPU port's bit for bit. A device ring would need a month-volume
output plane in every instance of both chunk kernels and cross-block
reductions. What it would have to beat: ``chip_smoke.py``'s observability
phase measured the host update at about 2.3 ms a chunk of 2048 links x 24
hours (0.2 ms of it formed while the chunk kernel runs), beside a 3.6 ms
chunk without observability, on an NVIDIA H100 80GB HBM3 host at 700 W
(``PERF.md``, PR 33).

Bit-exactness contract: the ring only consumes the chunk's outputs, it never
feeds back into pricing or the FSM, so decisions with observability on and
off are identical bit for bit. :func:`update_ring_chunk` over a (K, rows)
chunk equals K calls of :func:`update_ring` bit for bit (each hour's
reductions alone, the accumulators advanced hour by hour), so a chunked
stream drains what a per-tick stream drains.

Host side, :meth:`DrainedMetrics.from_flat` unpacks the drained vector by the
shared :func:`ring_layout`; quantiles come from the histogram (log-spaced
edges, under- and overflow clipped into the end bins).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.togglecci import OFF, ON

# Flatten layout (order matters: the host unpacking mirrors it).
SCALARS = ("ticks", "requests", "activations", "releases", "cci_gb")
GAUGES = (
    "lease_on",          # rows leased (serving CCI) this tick
    "realized_cost",     # fleet-wide realized $ this tick
    "vpn_cost",          # fleet-wide VPN counterfactual $
    "cci_cost",          # fleet-wide CCI counterfactual $
    "billed_gb",         # pair-level billed GB (all paths)
    "forecast_abs_err",  # sum |pred - realized row demand| (0 when no forecast)
    "pred_total",        # sum of per-row demand predictions
    "demand_total",      # sum of row-aggregated realized demand
)


class MetricsRing(NamedTuple):
    """Counters, per-tick gauge columns and histograms: three tensors.

    ``small`` holds every scalar accumulator, ``[SCALARS | cost_hist |
    tier_gb]``: ticks since the last drain (the next gauge column), OFF →
    {WAITING, ON} request edges, → ON activations, ON → OFF releases, GB
    billed while leased; then the B per-row hourly realized-cost histogram
    counts; then the K VPN-path billed GB tier buckets. ``prev_state`` is
    carried state, not a metric: the FSM state of the previous tick, kept
    across drains so that no lease edge goes missing at a drain boundary.
    ``gauges`` is (8, cap), one row per :data:`GAUGES` name, one column a
    tick. Everything but ``prev_state`` zeroes on drain.
    """

    small: torch.Tensor       # (5 + B + K,) float64
    prev_state: torch.Tensor  # (M,) int32
    gauges: torch.Tensor      # (8, cap) float64


def default_hist_edges(n_bins: int, lo: float = 1e-2, hi: float = 1e4) -> np.ndarray:
    """Log-spaced histogram edges for per-row hourly realized cost ($/h):
    ``n_bins`` buckets over [lo, hi]; values outside clip into the end bins
    (the first bin doubles as "about zero cost": idle rows land there)."""
    assert n_bins >= 2 and 0 < lo < hi
    return np.logspace(np.log10(lo), np.log10(hi), n_bins + 1)


def init_ring(n_rows: int, cap: int, n_bins: int, n_tiers: int,
              dtype=torch.float64, device="cpu") -> MetricsRing:
    """A fresh ring on ``device`` (the runtime keeps it on the host)."""
    assert cap >= 1 and n_bins >= 2 and n_tiers >= 1
    return MetricsRing(
        small=torch.zeros((len(SCALARS) + n_bins + n_tiers,), dtype=dtype, device=device),
        prev_state=torch.full((n_rows,), OFF, dtype=torch.int32, device=device),
        gauges=torch.zeros((len(GAUGES), cap), dtype=dtype, device=device),
    )


def reset_ring(ring: MetricsRing) -> MetricsRing:
    """Fresh window: zero everything except the carried ``prev_state``."""
    return MetricsRing(small=torch.zeros_like(ring.small), prev_state=ring.prev_state,
                       gauges=torch.zeros_like(ring.gauges))


def init_tenant_ring(n_slots: int, n_rows: int, cap: int, n_bins: int, n_tiers: int,
                     dtype=torch.float64, device="cpu") -> MetricsRing:
    """A pool of ``n_slots`` per-tenant rings as one ring with a leading
    tenant axis on every tensor (the gateway's pooled form)."""
    one = init_ring(n_rows, cap, n_bins, n_tiers, dtype, device)
    return MetricsRing(*(x.repeat((n_slots,) + (1,) * x.dim()) for x in one))


def reset_ring_slot(ring: MetricsRing, slot: int) -> MetricsRing:
    """Reset one tenant slot of a pooled ring to its initial state (zeros,
    ``prev_state`` back to OFF): a tenant joining mid-window must not
    inherit the previous occupant's counters or FSM edge baseline."""
    small, prev, gauges = (x.clone() for x in ring)
    small[slot] = 0
    gauges[slot] = 0
    prev[slot] = OFF
    return MetricsRing(small=small, prev_state=prev, gauges=gauges)


def _host(t) -> Optional[np.ndarray]:
    """A tensor (any device) or an array as a numpy array on the host: a
    view of a CPU tensor, one copy off any other device."""
    if t is None:
        return None
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def update_ring(
    ring: MetricsRing,
    hist_edges,
    *,
    x_t: torch.Tensor,
    state_t: torch.Tensor,
    vpn_t: torch.Tensor,
    cci_t: torch.Tensor,
    d_pair: torch.Tensor,
    d_row: torch.Tensor,
    month_cum: torch.Tensor,
    tier_bounds: torch.Tensor,
    routing_idx: Optional[torch.Tensor] = None,
    pred_t: Optional[torch.Tensor] = None,
) -> MetricsRing:
    """One tick of metrics (``src/repro/obs/metrics.py:139-251``): consumes
    only the tick's outputs and returns the new ring.

    ``x_t``/``state_t``/``vpn_t``/``cci_t``/``d_row`` are per decision row
    (M,), ``d_pair``/``month_cum`` per demand row (P,), ``tier_bounds`` (P,
    K). ``routing_idx`` maps each pair onto its primary port in topology
    mode (``None`` in fleet mode, rows == pairs); ``pred_t`` is this tick's
    per-row demand forecast under a forecast-gated policy (``None``: the
    calibration gauges stay zero). Tier attribution takes the start-of-hour
    month volume (``month_cum >= bound``): an hour straddling a tier bound
    counts in its starting tier. The cost histogram bins with strict ``>``
    against each edge: a value on an edge stays in the lower bin, under- and
    overflow clip into the end bins, and a NaN cost lands in bin 0.
    """
    one = lambda v: None if v is None else v[None]
    return update_ring_chunk(
        ring, hist_edges, x_t=one(x_t), state_t=one(state_t), vpn_t=one(vpn_t),
        cci_t=one(cci_t), d_pair=one(d_pair), d_row=one(d_row), month_cum=one(month_cum),
        tier_bounds=tier_bounds, routing_idx=routing_idx, pred_t=one(pred_t))


def update_ring_chunk(
    ring: MetricsRing,
    hist_edges,
    *,
    x_t: torch.Tensor,
    state_t: torch.Tensor,
    vpn_t: torch.Tensor,
    cci_t: torch.Tensor,
    d_pair: torch.Tensor,
    d_row: torch.Tensor,
    month_cum: torch.Tensor,
    tier_bounds: torch.Tensor,
    routing_idx: Optional[torch.Tensor] = None,
    pred_t: Optional[torch.Tensor] = None,
    cost_t: Optional[torch.Tensor] = None,
) -> MetricsRing:
    """K ticks of metrics at once over (K, rows) planes, in hour order: the
    bits of K :func:`update_ring` calls. Hour k's ``prev_state`` is hour
    k − 1's ``state``, its gauges land in column ``ticks + k``, and each
    hour's reductions run on its own row, added to the accumulators hour by
    hour (never a sum over K added once). The window must hold the chunk
    (``ticks + K <= cap``; the runtime drains at chunk ends). ``cost_t``,
    when the caller has it, is the realized cost plane ``where(x_t == 1,
    cci_t, vpn_t)`` (the runtime's ``cost`` output), so that it is not
    selected twice. It is :func:`update_ring_slots` over one slot."""
    one = lambda v: None if v is None else v[None]
    out = update_ring_slots(
        MetricsRing(*(t[None] for t in ring)), hist_edges, x_t=one(x_t), state_t=one(state_t),
        vpn_t=one(vpn_t), cci_t=one(cci_t), d_pair=one(d_pair), d_row=one(d_row),
        month_cum=one(month_cum), tier_bounds=tier_bounds[None], routing_idx=one(routing_idx),
        pred_t=one(pred_t), cost_t=one(cost_t))
    return MetricsRing(*(t[0] for t in out))


def update_ring_slots(
    ring: MetricsRing,
    hist_edges,
    *,
    x_t,
    state_t,
    vpn_t,
    cci_t,
    d_pair,
    d_row,
    month_cum,
    tier_bounds,
    routing_idx=None,
    pred_t=None,
    cost_t=None,
) -> MetricsRing:
    """:func:`update_ring_chunk` with a leading slot axis: the gateway's
    pooled ring (:func:`init_tenant_ring`) over a bucket's (S, K, rows)
    planes, numpy arrays or tensors (``tier_bounds`` (S, P, Kt),
    ``routing_idx`` (S, P)). Slot s's ring gets the bits of
    :func:`update_ring_chunk` over its own planes: every reduction runs over
    one (slot, hour) row, each slot's gauges land in its own ``ticks + k``
    columns, and the counts are exact. Every slot's window must hold the
    chunk."""
    dev = ring.gauges.device
    small0, prev_state, gauges0 = (_host(t) for t in ring)
    f = gauges0.dtype
    x, vpn, cci = _host(x_t), _host(vpn_t), _host(cci_t)
    d_pair, d_row, month_cum = _host(d_pair), _host(d_row), _host(month_cum)
    S, K = x.shape[:2]
    cap = gauges0.shape[-1]
    i = small0[:, 0].astype(np.int64)       # ticks = each slot's next gauge column
    over = i + K > cap
    if over.any():
        raise ValueError(f"{K} ticks from gauge column {int(i[over][0])} overrun the window "
                         f"of {cap}")
    edges = np.asarray(_host(hist_edges), f)
    B = edges.shape[0] - 1
    bounds = np.asarray(_host(tier_bounds), f)
    Kt = bounds.shape[-1]
    st = _host(state_t).astype(np.int8)     # the FSM's three states
    prev = np.concatenate([prev_state[:, None].astype(np.int8), st[:, :-1]], axis=1)
    on = x == 1
    realized = np.where(on, cci, vpn) if cost_t is None else _host(cost_t)
    cell = np.arange(S * K, dtype=np.int64).reshape(S, K, 1)   # one (slot, hour) a cell

    # Lease lifecycle edges against the previous tick's FSM state, counted
    # exactly: one count a (previous, current) pair of the FSM's three states
    # a cell.
    pair = (prev * 3 + st).astype(np.int64) + 9 * cell
    edge = np.bincount(pair.ravel(), minlength=9 * S * K).reshape(S, K, 3, 3).astype(f)
    req = edge[..., OFF, :].sum(-1) - edge[..., OFF, OFF]     # OFF -> WAITING or ON
    act = edge[..., :, ON].sum(-1) - edge[..., ON, ON]        # anything but ON -> ON
    rel = edge[..., ON, OFF]                                  # ON -> OFF

    # Billed volume: the VPN path by start-of-hour tier as the reference's
    # cumulative sums differenced, w[j] = sum vol·[cum >= bound_j]; the CCI
    # path in one bucket. Every float sum is one row's (numpy's pairwise sum
    # over the last axis, one thread, row by row): an (S, K, n) block's rows
    # give the bits of S·K (n,) sums, and a mask of all ones gives the
    # total's bits.
    on_pair = (on if routing_idx is None
               else np.take_along_axis(on, _host(routing_idx)[:, None, :], axis=2))
    vpn_vol = d_pair * ~on_pair             # d·(1 − on): d, or d·0.0 (NaN stays NaN)
    total_vol = vpn_vol.sum(-1)
    if Kt == 1:
        tier = total_vol[..., None]
    else:
        cols = np.ascontiguousarray(np.swapaxes(bounds, -1, -2))    # (S, Kt, P)
        w = np.stack([(vpn_vol * (month_cum >= cols[:, None, j]).astype(f)).sum(-1)
                      for j in range(Kt - 1)], axis=-1)
        tier = np.concatenate([(total_vol - w[..., 0])[..., None], w[..., :-1] - w[..., 1:],
                               w[..., -1:]], axis=-1)
    cci_gb = (d_pair * on_pair).sum(-1)

    # Per-row realized-cost histogram: the bin is the count of interior edges
    # strictly below the value, so under- and overflow clip into the end bins
    # and NaN, above no edge, lands in bin 0 (the reference's cumulative
    # counts, differenced, give the same counts).
    bins = np.zeros(realized.shape, np.int8 if B <= 128 else np.int16)
    for e in edges[1:B]:
        np.add(bins, (realized > e).view(np.int8), out=bins, casting="unsafe")
    hist = np.bincount((bins + B * cell).ravel(),
                       minlength=S * K * B).reshape(S, K, B).astype(f)

    zero = np.zeros((S, K), f)
    if pred_t is not None:
        pred = _host(pred_t).astype(f)
        err, pred_sum = np.abs(pred - d_row).sum(-1), pred.sum(-1)
    else:
        err, pred_sum = zero, zero
    gauges = gauges0.copy()
    gauges[np.arange(S)[:, None], :, i[:, None] + np.arange(K)] = np.stack(
        [np.count_nonzero(on, axis=-1).astype(f), realized.sum(-1), vpn.sum(-1), cci.sum(-1),
         d_pair.sum(-1), err, pred_sum, d_row.sum(-1)], axis=-1)

    delta = np.concatenate([np.ones((S, K, 1), f), req[..., None], act[..., None],
                            rel[..., None], cci_gb[..., None], hist, tier], axis=-1)
    small = small0
    for k in range(K):                      # hour by hour, as K ticks add them
        small = small + delta[:, k]
    out = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return MetricsRing(small=out(small), prev_state=out(st[:, -1].astype(np.int32)),
                       gauges=out(gauges))


def ring_layout(cap: int, n_bins: int, n_tiers: int) -> Tuple[Tuple[str, int], ...]:
    """(name, length) spec of the flattened drain vector, shared by
    :func:`flatten_ring` and :meth:`DrainedMetrics.from_flat`."""
    return tuple(
        [(s, 1) for s in SCALARS]
        + [(g, cap) for g in GAUGES]
        + [("cost_hist", n_bins), ("tier_gb", n_tiers)]
    )


def ring_size(cap: int, n_bins: int, n_tiers: int) -> int:
    return sum(n for _, n in ring_layout(cap, n_bins, n_tiers))


def flatten_ring(ring: MetricsRing) -> torch.Tensor:
    """The drain payload: every drained field as one flat float64 vector in
    :func:`ring_layout` order (``prev_state`` stays in the carry)."""
    n = len(SCALARS)
    return torch.cat([ring.small[:n], ring.gauges.reshape(-1), ring.small[n:]])


@dataclasses.dataclass(frozen=True)
class DrainedMetrics:
    """One drained window, host-side. Gauge arrays carry ``ticks`` valid
    entries (a final partial drain can close a window early)."""

    hour: int  # stream hour at which the drain happened (exclusive end)
    ticks: int
    requests: int
    activations: int
    releases: int
    cci_gb: float
    lease_on: np.ndarray
    realized_cost: np.ndarray
    vpn_cost: np.ndarray
    cci_cost: np.ndarray
    billed_gb: np.ndarray
    forecast_abs_err: np.ndarray
    pred_total: np.ndarray
    demand_total: np.ndarray
    cost_hist: np.ndarray
    tier_gb: np.ndarray

    @classmethod
    def from_flat(cls, hour: int, vec, *, cap: int, n_bins: int,
                  n_tiers: int) -> "DrainedMetrics":
        vec = np.asarray(vec.cpu() if isinstance(vec, torch.Tensor) else vec, np.float64)
        layout = ring_layout(cap, n_bins, n_tiers)
        assert vec.shape == (sum(n for _, n in layout),), (vec.shape, sum(n for _, n in layout))
        fields = {}
        off = 0
        for name, n in layout:
            chunk = vec[off:off + n]
            off += n
            if name in SCALARS:
                fields[name] = float(chunk[0]) if name == "cci_gb" else int(chunk[0])
            else:
                fields[name] = chunk.copy()
        ticks = fields["ticks"]
        for g in GAUGES:
            fields[g] = fields[g][:ticks]
        return cls(hour=hour, **fields)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in d.items()}

    def cost_quantiles(self, edges: np.ndarray,
                       qs: Sequence[float] = (0.5, 0.95, 0.99)) -> dict:
        """Per-row hourly realized-cost quantiles from the binned histogram
        (log-interpolated within the hit bin; exact to bin resolution)."""
        edges = np.asarray(edges, np.float64)
        counts = np.asarray(self.cost_hist, np.float64)
        total = counts.sum()
        out = {}
        if total <= 0:
            return {f"p{int(100 * q)}": float("nan") for q in qs}
        cum = np.cumsum(counts)
        lo, hi = np.log(edges[:-1]), np.log(edges[1:])
        for q in qs:
            target = q * total
            b = int(np.searchsorted(cum, target))
            b = min(b, counts.shape[0] - 1)
            prev = cum[b - 1] if b > 0 else 0.0
            frac = (target - prev) / counts[b] if counts[b] > 0 else 0.5
            out[f"p{int(100 * q)}"] = float(np.exp(lo[b] + frac * (hi[b] - lo[b])))
        return out
