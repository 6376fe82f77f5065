"""The host-side observer: config, per-tick hooks, and the obs report.

Port of :mod:`repro.obs.observer`. :class:`FleetObserver` is what
:class:`repro_torch.fleet.runtime.FleetRuntime` talks to when built with
``obs=ObsConfig(...)``: the runtime calls ``record_step`` after every
committed tick and ``record_chunk`` after every committed chunk,
``record_drain`` whenever the metrics ring closes a window, and
``record_reroute`` / ``record_sync_domains`` on actuation-layer events. The
observer fans these out to the trace recorder, the profiler, and the
contract monitors — a :class:`~repro_torch.obs.monitors.ContractViolation`
raised by a monitor is recorded (and traced) before propagating to the
caller.

Everything here is off the device: numpy float64 accumulation and
vectorized state diffs, a few microseconds per hour at fleet scale.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from .metrics import DrainedMetrics, default_hist_edges
from .monitors import (
    BillingMonitor,
    CalibrationMonitor,
    ContractViolation,
    DivergenceMonitor,
    RegretMonitor,
)
from .profile import TickProfiler
from .trace import TraceRecorder


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs for the fleet observability layer.

    ``cadence`` is the drain period in ticks — the metrics ring holds
    exactly that many per-tick gauge slots and closes a window every
    ``cadence`` hours (a chunk may end on a drain hour, never cross one).

    ``monitors`` gates the cheap always-on monitors (billing reconciliation,
    regret tracking, forecast calibration). ``divergence`` additionally
    records the full demand/decision history and replays it through the
    offline engines — exact but O(T) memory and O(T) device work per check,
    so it defaults off and checks only at ``divergence_check_every`` hours
    (``None``: only when :meth:`FleetObserver.check` is called, e.g. at end
    of stream).

    The ``max_*`` thresholds arm the corresponding monitor to RAISE; left
    ``None`` the quantity is tracked and reported but never fatal.
    """

    cadence: int = 64
    hist_bins: int = 16
    hist_lo: float = 1e-2
    hist_hi: float = 1e4
    trace: bool = True
    monitors: bool = True
    divergence: bool = False
    divergence_check_every: Optional[int] = None
    billing_rtol: float = 1e-9
    max_regret_vs_static: Optional[float] = None
    max_oracle_ratio: Optional[float] = None
    max_forecast_bias: Optional[float] = None
    trace_hour_us: float = 1000.0
    row_names: Optional[Sequence[str]] = None

    def __post_init__(self):
        assert self.cadence >= 1, "drain cadence must be >= 1 tick"
        assert self.hist_bins >= 2


@dataclasses.dataclass
class ObsReport:
    """Everything ``FleetRuntime.obs_report()`` surfaces, JSON-ready."""

    hours: int
    n_rows: int
    cadence: int
    drains: int
    requests: int
    activations: int
    releases: int
    lease_on_mean: float
    realized_cost: float
    vpn_cost: float
    cci_cost: float
    billed_gb: float
    vpn_tier_gb: List[float]
    cci_path_gb: float
    cost_quantiles: Dict[str, float]
    profile: dict
    monitors: Dict[str, dict]
    violations: List[str]
    trace_events: int

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=float)

    def render_text(self) -> str:
        mb = lambda b: f"{b / 1e6:.1f} MB"
        p = self.profile
        q = self.cost_quantiles
        lines = [
            f"observability report — {self.hours} h streamed, "
            f"{self.drains} drains (cadence {self.cadence})",
            f"  leases : {self.requests} requests, {self.activations} "
            f"activations, {self.releases} releases; mean "
            f"{self.lease_on_mean:.1f}/{self.n_rows} rows leased",
            f"  billing: realized ${self.realized_cost:,.0f}  "
            f"(counterfactuals: vpn ${self.vpn_cost:,.0f} / "
            f"cci ${self.cci_cost:,.0f})",
            f"  volume : {self.billed_gb:,.1f} GB billed — vpn tiers "
            f"[{', '.join(f'{g:,.1f}' for g in self.vpn_tier_gb)}] GB, "
            f"cci path {self.cci_path_gb:,.1f} GB",
            f"  cost/row/h: p50 ${q.get('p50', float('nan')):.3g}  "
            f"p95 ${q.get('p95', float('nan')):.3g}  "
            f"p99 ${q.get('p99', float('nan')):.3g}",
            f"  ticks  : p50 {p['tick_us_p50']:.0f}µs  "
            f"p95 {p['tick_us_p95']:.0f}µs  p99 {p['tick_us_p99']:.0f}µs  "
            f"(h2d {mb(p['h2d_bytes'])}, d2h {mb(p['d2h_bytes'])}, "
            f"{p['compiles']} compiles)",
        ]
        mons = []
        for name, s in self.monitors.items():
            if s.get("enabled") is False:
                mons.append(f"{name} off ({s.get('reason')})")
            elif name == "regret":
                mons.append(
                    f"regret {100 * s['regret_vs_static']:+.2f}% vs best-static"
                    + (
                        f", {s['oracle_ratio']:.3f}x oracle"
                        if s.get("oracle_ratio") else ""
                    )
                )
            elif name == "calibration":
                mons.append(f"calibration bias {s['bias']:.3f}")
            else:
                mons.append(f"{name} ok ({s['checks']} checks)")
        if mons:
            lines.append("  monitors: " + " · ".join(mons))
        lines.append(
            "  violations: "
            + (f"{len(self.violations)} — {self.violations[0]}"
               if self.violations else "none")
        )
        return "\n".join(lines)


class FleetObserver:
    """Fans runtime events out to trace / profiler / monitors (see module
    docstring). Built by ``FleetRuntime(..., obs=ObsConfig(...))`` — not
    usually constructed by hand."""

    def __init__(self, config: ObsConfig, runtime):
        self.config = config
        self.rt = runtime
        self.cadence = int(config.cadence)
        self.hist_edges = default_hist_edges(
            config.hist_bins, config.hist_lo, config.hist_hi
        )
        self.n_tiers = int(runtime.arrays.tier_bounds.shape[1])
        self._init_run()

    def _init_run(self) -> None:
        cfg = self.config
        rt = self.rt
        self.hours = 0
        self.endo_seen = False
        self.drained: List[DrainedMetrics] = []
        self.violations: List[ContractViolation] = []
        self.profiler = TickProfiler()
        self.trace: Optional[TraceRecorder] = None
        if cfg.trace:
            self.trace = TraceRecorder(
                rt.n_rows,
                row_names=cfg.row_names,
                hour_us=cfg.trace_hour_us,
                kind="port" if rt.topology else "link",
            )
        self.billing = self.regret = self.calibration = None
        if cfg.monitors:
            self.billing = BillingMonitor(rt, rtol=cfg.billing_rtol)
            self.regret = RegretMonitor(
                rt,
                max_regret_vs_static=cfg.max_regret_vs_static,
                max_oracle_ratio=cfg.max_oracle_ratio,
            )
            self.calibration = CalibrationMonitor(
                rt, max_forecast_bias=cfg.max_forecast_bias
            )
        self.divergence = (
            DivergenceMonitor(rt, check_every=cfg.divergence_check_every)
            if cfg.divergence
            else None
        )

    def on_reset(self) -> None:
        """The runtime rewound to tick 0 — start a fresh observation run."""
        self._init_run()

    # -- runtime hooks -----------------------------------------------------

    def _guard(self, hour: int, fn, *args, **kw) -> None:
        try:
            fn(*args, **kw)
        except ContractViolation as v:
            self.violations.append(v)
            if self.trace is not None:
                self.trace.instant(
                    v.hour if v.hour is not None else hour, "violation",
                    monitor=v.monitor, row=v.row, message=str(v),
                )
            raise

    def record_step(
        self,
        t: int,
        out: dict,
        *,
        d_pair: np.ndarray,
        demand_t: np.ndarray,
        endo: bool,
        h2d_bytes: int,
        d2h_bytes: int,
        dt_s: float,
    ) -> None:
        self.hours = t + 1
        self.endo_seen |= endo
        self.profiler.record(dt_s, h2d_bytes, d2h_bytes)
        if self.trace is not None:
            self.trace.observe_states(t, out["state"])
        if self.billing is not None:
            self.billing.on_step(t, out, d_pair)
        if self.regret is not None:
            self.regret.on_step(t, out)
        if self.divergence is not None:
            self.divergence.on_step(t, out, demand_t, endo)

    def record_chunk(
        self,
        t: int,
        outs_by_hour: Sequence[dict],
        *,
        d_pair: np.ndarray,
        demand: np.ndarray,
        endo: bool,
        h2d_bytes: int,
        d2h_bytes: int,
        dt_s: float,
    ) -> None:
        """One ``step_many`` dispatch covering hours ``t .. t+K-1``.

        ``outs_by_hour`` is the chunk's K per-hour step dicts, ``d_pair``
        is (K, P) and ``demand`` (P, K). The profiler gets one per-chunk
        record (latency amortized per hour, transfers counted once); every
        per-hour consumer — trace, billing/regret/divergence monitors —
        sees exactly the per-tick event stream, so a chunked run's traces
        and monitor verdicts match a per-tick run's.
        """
        K = len(outs_by_hour)
        self.hours = t + K
        self.endo_seen |= endo
        self.profiler.record_chunk(dt_s, h2d_bytes, d2h_bytes, K)
        for k, out in enumerate(outs_by_hour):
            if self.trace is not None:
                self.trace.observe_states(t + k, out["state"])
            if self.billing is not None:
                self.billing.on_step(t + k, out, d_pair[k])
            if self.regret is not None:
                self.regret.on_step(t + k, out)
            if self.divergence is not None:
                self.divergence.on_step(t + k, out, demand[:, k], endo)

    def record_drain(self, hour: int, vec) -> None:
        dm = DrainedMetrics.from_flat(
            hour, vec,
            cap=self.cadence,
            n_bins=self.config.hist_bins,
            n_tiers=self.n_tiers,
        )
        self.drained.append(dm)
        self.profiler.note_drain()
        if self.trace is not None and dm.ticks > 0:
            self.trace.counter(hour, "lease_on", {
                "rows": float(np.mean(dm.lease_on)),
            })
            self.trace.counter(hour, "cost_per_h", {
                "realized": float(np.mean(dm.realized_cost)),
                "vpn": float(np.mean(dm.vpn_cost)),
                "cci": float(np.mean(dm.cci_cost)),
            })
        if self.billing is not None:
            self._guard(hour, self.billing.on_drain, hour, dm)
        if self.calibration is not None:
            self._guard(hour, self.calibration.on_drain, hour, dm)
        if self.divergence is not None:
            self._guard(hour, self.divergence.on_drain, hour, dm)
        if self.regret is not None:
            self._guard(hour, self.regret.check, hour)

    def record_reroute(
        self, t: int, old_idx: np.ndarray, new_idx: np.ndarray, plan=None
    ) -> None:
        """``old_idx``/``new_idx`` are the (P,) first-hop views (what the
        trace counts moves over); ``plan`` optionally carries the full
        typed RoutingPlan so the divergence oracle replays multi-hop and
        tree segments exactly."""
        if self.trace is not None:
            self.trace.instant(
                t, "reroute",
                moved_pairs=int(np.sum(old_idx != new_idx)),
                pairs=int(new_idx.shape[0]),
            )
        if self.divergence is not None:
            self.divergence.on_reroute(
                t, plan if plan is not None else new_idx
            )

    def record_sync_domains(self, t: int, n_domains: int, n_jobs: int) -> None:
        if self.trace is not None:
            self.trace.instant(
                t, "sync_domains", domains=int(n_domains), jobs=int(n_jobs)
            )

    def note_compile(self) -> None:
        self.profiler.note_compile()

    # -- checks / report ---------------------------------------------------

    def check(self, *, final: bool = True) -> None:
        """Run every armed monitor now (the runtime flushes the ring first
        when called through ``FleetRuntime.obs_check``). Raises the first
        :class:`ContractViolation`; a clean return means all contracts held."""
        hour = self.hours
        if self.billing is not None:
            self._guard(hour, self.billing.check, hour)
        if self.divergence is not None:
            self._guard(hour, self.divergence.check, hour)
        if self.regret is not None:
            self._guard(hour, self.regret.check, hour, final=final)
        if self.calibration is not None:
            self._guard(hour, self.calibration.check, hour)

    def monitor_summaries(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for m in (self.billing, self.divergence, self.regret, self.calibration):
            if m is not None:
                out[m.name] = m.summary()
        return out

    def report(self) -> ObsReport:
        d = self.drained
        hist = (
            np.sum([x.cost_hist for x in d], axis=0)
            if d else np.zeros(self.config.hist_bins)
        )
        tiers = (
            np.sum([x.tier_gb for x in d], axis=0)
            if d else np.zeros(self.n_tiers)
        )
        lease = np.concatenate([x.lease_on for x in d]) if d else np.zeros(0)
        quant = DrainedMetrics(
            hour=self.hours, ticks=int(sum(x.ticks for x in d)),
            requests=0, activations=0, releases=0, cci_gb=0.0,
            lease_on=lease, realized_cost=np.zeros(0), vpn_cost=np.zeros(0),
            cci_cost=np.zeros(0), billed_gb=np.zeros(0),
            forecast_abs_err=np.zeros(0), pred_total=np.zeros(0),
            demand_total=np.zeros(0), cost_hist=hist, tier_gb=tiers,
        ).cost_quantiles(self.hist_edges)
        return ObsReport(
            hours=self.hours,
            n_rows=self.rt.n_rows,
            cadence=self.cadence,
            drains=len(d),
            requests=int(sum(x.requests for x in d)),
            activations=int(sum(x.activations for x in d)),
            releases=int(sum(x.releases for x in d)),
            lease_on_mean=float(np.mean(lease)) if lease.size else 0.0,
            realized_cost=float(sum(x.realized_cost.sum() for x in d)),
            vpn_cost=float(sum(x.vpn_cost.sum() for x in d)),
            cci_cost=float(sum(x.cci_cost.sum() for x in d)),
            billed_gb=float(sum(x.billed_gb.sum() for x in d)),
            vpn_tier_gb=[float(g) for g in tiers],
            cci_path_gb=float(sum(x.cci_gb for x in d)),
            cost_quantiles=quant,
            profile=self.profiler.summary(),
            monitors=self.monitor_summaries(),
            violations=[str(v) for v in self.violations],
            trace_events=self.trace.n_events if self.trace is not None else 0,
        )
