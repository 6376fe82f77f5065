"""Live contract monitors: online invariant checks over the streaming runtime.

Port of :mod:`repro.obs.monitors`: the same contracts, texts and verdicts.

Each monitor audits one of the repo's load-bearing contracts WHILE a stream
runs, instead of only in offline tests:

* :class:`BillingMonitor`     — three-way billing reconciliation per drain:
  the drained ring totals vs the runtime's host-side float64 prefix
  accumulators vs the monitor's own independent numpy sums (catches
  ulp-class accumulator drift, with per-row attribution of any
  discrepancy);
* :class:`DivergenceMonitor`  — streamed-vs-offline decision divergence:
  replays the observed demand prefix through the offline engines
  (:func:`repro_torch.fleet.engine.offline_stream_oracle` — ``plan_fleet`` in
  fleet mode, ``replay_plan_topology`` with the recorded routing schedule in
  topology mode) and demands bit-identical decisions;
* :class:`RegretMonitor`      — live regret vs the best-STATIC policy (the
  paper's headline claim) and optionally vs the offline DP oracle (one
  ``oracle_dp`` launch over the recorded series);
* :class:`CalibrationMonitor` — SSM forecast calibration (bias ratio and
  MAE from the drained gauges).

A failed check raises a typed :class:`ContractViolation` carrying the
monitor name, the offending row (port/link) and hour, and a details dict —
an operator's pager line, not an assert.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import to_host

from .metrics import DrainedMetrics


class ContractViolation(Exception):
    """A runtime contract broke: which monitor, where, and the numbers."""

    def __init__(
        self,
        monitor: str,
        message: str,
        *,
        hour: Optional[int] = None,
        row: Optional[int] = None,
        details: Optional[dict] = None,
    ):
        self.monitor = monitor
        self.hour = hour
        self.row = row
        self.details = dict(details or {})
        where = "".join(
            [f" [row {row}]" if row is not None else "",
             f" [hour {hour}]" if hour is not None else ""]
        )
        super().__init__(f"{monitor}{where}: {message}")


class BillingMonitor:
    """Reconcile three independent billing paths at every drain.

    1. the monitor's own float64 numpy accumulation of the per-tick outputs;
    2. the runtime's host-side prefix accumulators (``vpn_pref``/``cci_pref``/
       ``dcum`` — the decision-critical state);
    3. the drained ring totals (the host ring's own reductions).

    (1) vs (2) is compared PER ROW (same summation order — exact up to the
    ulp tolerance, and a mismatch names the offending port); (3) is compared
    on fleet aggregates (its reduction order differs, rtol covers it). The
    ring's internal split must also close: ``tier_gb + cci_gb == billed_gb``.
    """

    name = "billing"

    def __init__(self, runtime, *, rtol: float = 1e-9, atol: float = 1e-6):
        self.rt = runtime
        self.rtol = float(rtol)
        self.atol = float(atol)
        M, P = runtime.n_rows, runtime.n_demand_rows
        self.vpn = np.zeros(M)
        self.cci = np.zeros(M)
        self.realized = np.zeros(M)
        self.gb = np.zeros(P)
        self.dev = {"vpn": 0.0, "cci": 0.0, "realized": 0.0, "gb": 0.0}
        self.tier_gb = 0.0
        self.cci_gb = 0.0
        self.checks = 0

    def on_step(self, t: int, out: dict, d_pair: np.ndarray) -> None:
        np.add(self.vpn, out["vpn_cost"], out=self.vpn)
        np.add(self.cci, out["cci_cost"], out=self.cci)
        np.add(self.realized, out["cost"], out=self.realized)
        np.add(self.gb, d_pair, out=self.gb)

    def on_drain(self, hour: int, dm: DrainedMetrics) -> None:
        self.dev["vpn"] += float(dm.vpn_cost.sum())
        self.dev["cci"] += float(dm.cci_cost.sum())
        self.dev["realized"] += float(dm.realized_cost.sum())
        self.dev["gb"] += float(dm.billed_gb.sum())
        self.tier_gb += float(dm.tier_gb.sum())
        self.cci_gb += dm.cci_gb
        self.check(hour)

    def _close(self, a: float, b: float) -> bool:
        return bool(np.isclose(a, b, rtol=self.rtol, atol=self.atol))

    def check(self, hour: int) -> None:
        st = self.rt._state
        for k, mine, theirs in (
            ("vpn_pref", self.vpn, st.vpn_pref),
            ("cci_pref", self.cci, st.cci_pref),
            ("dcum", self.gb, st.dcum),
        ):
            if not np.allclose(mine, theirs, rtol=self.rtol, atol=self.atol):
                diff = np.abs(mine - theirs)
                row = int(np.argmax(diff))
                raise ContractViolation(
                    self.name,
                    f"host accumulator {k} disagrees with independent "
                    f"re-accumulation (max |Δ| = {diff[row]:.6g})",
                    hour=hour, row=row,
                    details={
                        "accumulator": k,
                        "runtime": float(theirs[row]),
                        "recomputed": float(mine[row]),
                    },
                )
        for k, mine in (
            ("vpn", float(self.vpn.sum())),
            ("cci", float(self.cci.sum())),
            ("realized", float(self.realized.sum())),
            ("gb", float(self.gb.sum())),
        ):
            if not self._close(self.dev[k], mine):
                raise ContractViolation(
                    self.name,
                    f"device-drained {k} total {self.dev[k]:.6g} disagrees "
                    f"with host accumulation {mine:.6g}",
                    hour=hour, details={"metric": k},
                )
        split = self.tier_gb + self.cci_gb
        if not self._close(split, self.dev["gb"]):
            raise ContractViolation(
                self.name,
                f"ring volume split broke: tier_gb + cci_gb = {split:.6g} "
                f"vs billed_gb = {self.dev['gb']:.6g}",
                hour=hour,
            )
        self.checks += 1

    def summary(self) -> dict:
        return {
            "checks": self.checks,
            "vpn_cost": float(self.vpn.sum()),
            "cci_cost": float(self.cci.sum()),
            "realized_cost": float(self.realized.sum()),
            "billed_gb": float(self.gb.sum()),
            "vpn_path_gb": self.tier_gb,
            "cci_path_gb": self.cci_gb,
        }


class DivergenceMonitor:
    """Streamed decisions must match the offline engines bit for bit.

    Records the observed demand columns, decisions, and routing schedule
    (including mid-stream ``reroute()`` swaps), and at check time replays the
    prefix through :func:`repro_torch.fleet.engine.offline_stream_oracle` on
    the runtime's device. Checks are O(T) work each, so they run at a coarse
    ``check_every`` hour
    cadence (or only at the final :meth:`check`), not per drain.

    Unsupported regimes disable the monitor with a recorded reason instead
    of guessing: a LIVE forecaster has no precomputed offline twin, and
    endogenous CCI demand prices two demand shapes the offline engines don't
    model.
    """

    name = "divergence"

    def __init__(self, runtime, *, check_every: Optional[int] = None):
        self.rt = runtime
        self.check_every = check_every
        self.enabled = runtime.pred_source != "live"
        self.reason = (
            None if self.enabled
            else "live forecaster carries SSM state the offline engines lack"
        )
        self.demand: List[np.ndarray] = []
        self.x: List[np.ndarray] = []
        self.state: List[np.ndarray] = []
        # Schedule segments carry the typed RoutingPlan (multi-hop/tree
        # aware); the offline oracle normalizes each segment itself.
        self.schedule = (
            [(0, runtime.routing_plan)] if runtime.topology else None
        )
        self.checks = 0

    def _disable(self, reason: str) -> None:
        self.enabled = False
        self.reason = reason
        self.demand.clear()
        self.x.clear()
        self.state.clear()

    def on_step(self, t: int, out: dict, demand_t: np.ndarray, endo: bool) -> None:
        if not self.enabled:
            return
        if endo:
            self._disable(
                "endogenous CCI demand (offline engines price one demand shape)"
            )
            return
        self.demand.append(np.array(demand_t, np.float64))
        self.x.append(np.asarray(out["x"], np.int8))
        self.state.append(np.asarray(out["state"], np.int8))

    def on_reroute(self, t: int, new_routing) -> None:
        """``new_routing`` is the RoutingPlan now in effect (a bare index
        array keeps working — the oracle's normalizer accepts both)."""
        if self.schedule is not None and self.enabled:
            self.schedule.append((int(t), new_routing))

    def on_drain(self, hour: int, dm: DrainedMetrics) -> None:
        if (
            self.enabled
            and self.check_every
            and hour % self.check_every == 0
            and self.x
        ):
            self.check(hour)

    def check(self, hour: Optional[int] = None) -> None:
        if not self.enabled or not self.x:
            return
        from repro_torch.fleet.engine import offline_stream_oracle

        T = len(self.x)
        demand = np.stack(self.demand, axis=1)
        policy = self.rt.policy
        if self.rt.pred_source == "replay" and policy.pred_demand.shape[1] > T:
            # The offline scan consumes one prediction column per hour —
            # truncate to the observed prefix.
            policy = policy._replace(pred_demand=policy.pred_demand[:, :T])
        plan = offline_stream_oracle(
            self.rt.arrays, demand, policy=policy, schedule=self.schedule,
            hours_per_month=self.rt.hours_per_month, device=self.rt.device,
        )
        x_off = to_host(plan["x"])[:, :T]
        st_off = to_host(plan["state"])[:, :T]
        x_live = np.stack(self.x, axis=1).astype(x_off.dtype)
        st_live = np.stack(self.state, axis=1).astype(st_off.dtype)
        if not (
            np.array_equal(x_live, x_off) and np.array_equal(st_live, st_off)
        ):
            bad = np.nonzero((x_live != x_off) | (st_live != st_off))
            row, h = int(bad[0][0]), int(bad[1][0])
            raise ContractViolation(
                self.name,
                "streamed decisions diverged from the offline replay "
                f"(streamed x={int(x_live[row, h])} "
                f"state={int(st_live[row, h])}, offline "
                f"x={int(x_off[row, h])} state={int(st_off[row, h])})",
                hour=h, row=row,
                details={"observed_hours": T, "mismatches": int(bad[0].size)},
            )
        self.checks += 1

    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "reason": self.reason,
            "checks": self.checks,
            "recorded_hours": len(self.x),
            "routing_segments": (
                len(self.schedule) if self.schedule is not None else 1
            ),
        }


class RegretMonitor:
    """Live regret vs best-static (and optionally the offline DP oracle).

    The static comparators honor the provisioning delay the paper's
    comparison does: an always-CCI row still serves its first ``D`` hours on
    VPN. Oracle tracking records the per-hour counterfactual cost series
    (only when ``max_oracle_ratio`` is set — O(M·T) memory) and runs the
    exact DP at final check: every row in one ``ops.oracle_dp`` launch on
    the runtime's device, each total bit-equal to
    :func:`repro_torch.core.oracle.offline_optimal` on the row's series
    (zero leases, as the reference's row loop builds them).
    """

    name = "regret"

    def __init__(
        self,
        runtime,
        *,
        max_regret_vs_static: Optional[float] = None,
        max_oracle_ratio: Optional[float] = None,
    ):
        self.rt = runtime
        self.max_regret = max_regret_vs_static
        self.max_oracle_ratio = max_oracle_ratio
        M = runtime.n_rows
        self.realized = np.zeros(M)
        self.vpn = np.zeros(M)
        self.cci_delayed = np.zeros(M)
        self.D = to_host(runtime.arrays.toggle.D, np.int64)
        self.T_cci = to_host(runtime.arrays.toggle.T_cci, np.int64)
        self.vpn_hist: List[np.ndarray] = []
        self.cci_hist: List[np.ndarray] = []
        self.oracle_ratio: Optional[float] = None
        self.checks = 0

    def on_step(self, t: int, out: dict) -> None:
        vpn_c = np.asarray(out["vpn_cost"])
        cci_c = np.asarray(out["cci_cost"])
        np.add(self.realized, out["cost"], out=self.realized)
        np.add(self.vpn, vpn_c, out=self.vpn)
        np.add(
            self.cci_delayed, np.where(t >= self.D, cci_c, vpn_c),
            out=self.cci_delayed,
        )
        if self.max_oracle_ratio is not None:
            self.vpn_hist.append(vpn_c.copy())
            self.cci_hist.append(cci_c.copy())

    def best_static(self) -> np.ndarray:
        return np.minimum(self.vpn, self.cci_delayed)

    def regret_vs_static(self) -> float:
        bs = float(self.best_static().sum())
        return (float(self.realized.sum()) - bs) / bs if bs > 0 else 0.0

    def oracle_cost(self) -> np.ndarray:
        """Per-row offline DP on the recorded counterfactual series: one
        ``oracle_dp`` call over the (M, T) planes on the runtime's device
        (the kernel on the card, its plain version on the CPU)."""
        from repro_torch.kernels import ops

        assert self.vpn_hist, "oracle tracking needs max_oracle_ratio set"
        dev = self.rt.device
        vpn = np.stack(self.vpn_hist, axis=1)
        cci = np.stack(self.cci_hist, axis=1)
        zeros = np.zeros(vpn.shape)   # HourlyCosts(vpn_lease=0, ...).vpn, as the reference sums it
        f64 = lambda a: torch.from_numpy(zeros + a).to(dev)
        i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
        total, _ = ops.oracle_dp(f64(vpn), f64(cci), i32(self.D), i32(self.T_cci))
        return to_host(total, np.float64)

    def check(self, hour: Optional[int] = None, *, final: bool = False) -> None:
        self.checks += 1
        if self.max_regret is not None:
            regret = self.regret_vs_static()
            if regret > self.max_regret:
                bs = self.best_static()
                per_row = np.where(bs > 0, (self.realized - bs) / np.maximum(bs, 1e-30), 0.0)
                row = int(np.argmax(per_row))
                raise ContractViolation(
                    self.name,
                    f"realized cost exceeds best-static by "
                    f"{100 * regret:.2f}% (threshold "
                    f"{100 * self.max_regret:.2f}%)",
                    hour=hour, row=row,
                    details={
                        "regret_vs_static": regret,
                        "worst_row_regret": float(per_row[row]),
                    },
                )
        if final and self.max_oracle_ratio is not None and self.vpn_hist:
            oracle = float(self.oracle_cost().sum())
            realized = float(self.realized.sum())
            self.oracle_ratio = realized / oracle if oracle > 0 else 1.0
            if self.oracle_ratio > self.max_oracle_ratio:
                raise ContractViolation(
                    self.name,
                    f"realized / oracle = {self.oracle_ratio:.3f} exceeds "
                    f"{self.max_oracle_ratio:.3f}",
                    hour=hour,
                    details={"oracle_cost": oracle, "realized_cost": realized},
                )

    def summary(self) -> dict:
        return {
            "checks": self.checks,
            "realized_cost": float(self.realized.sum()),
            "best_static_cost": float(self.best_static().sum()),
            "regret_vs_static": self.regret_vs_static(),
            "oracle_ratio": self.oracle_ratio,
        }


class CalibrationMonitor:
    """SSM forecast calibration from the drained gauges.

    Bias = Σ pred / Σ realized row demand over the run (the forecaster
    predicts forward-WINDOW mean demand, so per-hour comparison is a proxy —
    over a long run the window means and the hourly means converge); MAE in
    GB/h per row. Inactive (with reason) for memoryless policies.
    """

    name = "calibration"

    def __init__(self, runtime, *, max_forecast_bias: Optional[float] = None):
        self.rt = runtime
        self.max_bias = max_forecast_bias
        self.enabled = runtime.pred_source is not None
        self.reason = None if self.enabled else "policy carries no forecast"
        self.pred = 0.0
        self.demand = 0.0
        self.abs_err = 0.0
        self.ticks = 0
        self.checks = 0

    def on_drain(self, hour: int, dm: DrainedMetrics) -> None:
        if not self.enabled:
            return
        self.pred += float(dm.pred_total.sum())
        self.demand += float(dm.demand_total.sum())
        self.abs_err += float(dm.forecast_abs_err.sum())
        self.ticks += dm.ticks
        self.check(hour)

    def bias(self) -> float:
        return self.pred / self.demand if self.demand > 0 else float("nan")

    def mae(self) -> float:
        n = self.ticks * self.rt.n_rows
        return self.abs_err / n if n > 0 else float("nan")

    def check(self, hour: Optional[int] = None) -> None:
        if not self.enabled:
            return
        self.checks += 1
        if self.max_bias is None or self.demand <= 0:
            return
        b = self.bias()
        if b > self.max_bias or b < 1.0 / self.max_bias:
            raise ContractViolation(
                self.name,
                f"forecast bias {b:.3f} outside "
                f"[{1.0 / self.max_bias:.3f}, {self.max_bias:.3f}]",
                hour=hour,
                details={"bias": b, "mae_gb_per_h": self.mae()},
            )

    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "reason": self.reason,
            "checks": self.checks,
            "bias": self.bias() if self.enabled else None,
            "mae_gb_per_h": self.mae() if self.enabled else None,
        }


class TenantSLOMonitor:
    """Per-tenant SLO + billing reconciliation over a gateway pool slot.

    The gateway's pooled twin of :class:`BillingMonitor`: one instance per
    tenant, fed at every gateway drain with (a) the tenant's slot of the
    pooled metrics ring (already pad-corrected and unpacked to a
    :class:`DrainedMetrics`) and (b) the tenant's host-side float64 billing
    accumulators. Checks two contracts:

    * **billing** — the cumulative drained realized/vpn/cci/volume totals
      must reconcile with the host accumulators (the ring's reduction order
      differs, so aggregates compare under ``rtol``);
    * **slo**     — when the tenant declared a cost budget, the drained
      window's mean realized $/h must not exceed it.

    Violations are RECORDED (returned as typed :class:`ContractViolation`
    values, tenant-attributed via ``details``), not raised — the gateway
    keeps serving the other tenants and surfaces breaches through its
    ``check()``, mirroring ``FleetRuntime.obs_check()``.
    """

    name = "tenant_slo"

    def __init__(
        self,
        tenant: str,
        *,
        max_hourly_cost: Optional[float] = None,
        rtol: float = 1e-9,
        atol: float = 1e-6,
    ):
        self.tenant = str(tenant)
        self.max_hourly_cost = (
            None if max_hourly_cost is None else float(max_hourly_cost)
        )
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.dev = {"realized": 0.0, "vpn": 0.0, "cci": 0.0, "gb": 0.0}
        self.ticks = 0
        self.checks = 0

    def on_drain(
        self, hour: int, dm: DrainedMetrics, *, host_totals: dict
    ) -> List[ContractViolation]:
        """One drained window: accumulate device totals, then check. ``hour``
        is the TENANT-local stream hour; ``host_totals`` carries the host
        f64 accumulator sums (``realized``/``vpn``/``cci``/``gb``)."""
        out: List[ContractViolation] = []
        self.dev["realized"] += float(dm.realized_cost.sum())
        self.dev["vpn"] += float(dm.vpn_cost.sum())
        self.dev["cci"] += float(dm.cci_cost.sum())
        self.dev["gb"] += float(dm.billed_gb.sum())
        self.ticks += dm.ticks
        self.checks += 1
        for k in ("realized", "vpn", "cci", "gb"):
            mine, theirs = self.dev[k], float(host_totals[k])
            if not np.isclose(mine, theirs, rtol=self.rtol, atol=self.atol):
                out.append(ContractViolation(
                    self.name,
                    f"tenant {self.tenant!r}: device-drained {k} total "
                    f"{mine:.6g} disagrees with host billing {theirs:.6g}",
                    hour=hour,
                    details={"tenant": self.tenant, "metric": k,
                             "device": mine, "host": theirs},
                ))
        if self.max_hourly_cost is not None and dm.ticks > 0:
            rate = float(dm.realized_cost.sum()) / dm.ticks
            if rate > self.max_hourly_cost * (1.0 + self.rtol) + self.atol:
                out.append(ContractViolation(
                    self.name,
                    f"tenant {self.tenant!r}: realized {rate:.6g} $/h over "
                    f"the drained window exceeds the SLO budget "
                    f"{self.max_hourly_cost:.6g} $/h",
                    hour=hour,
                    details={"tenant": self.tenant, "rate": rate,
                             "budget": self.max_hourly_cost},
                ))
        return out

    def summary(self) -> dict:
        return {
            "tenant": self.tenant,
            "checks": self.checks,
            "ticks": self.ticks,
            "realized_cost": self.dev["realized"],
            "billed_gb": self.dev["gb"],
            "budget": self.max_hourly_cost,
        }
