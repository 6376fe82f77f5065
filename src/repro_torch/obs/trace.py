"""Structured event tracing: lease lifecycles as Perfetto-renderable tracks.

Port of :mod:`repro.obs.trace` (host numpy; the same events and exports).

The :class:`TraceRecorder` turns the streaming runtime's per-tick FSM state
vector into a structured event log — one track (Chrome trace ``tid``) per
decision row (port/link), with each lease cycle rendered as two slices:

* ``provisioning`` — the D_cci delay edge, from the OFF→WAITING request to
  the WAITING→ON activation (zero-length when D = 0);
* ``leased``       — activation to the ON→OFF release.

plus instant events for ``reroute()`` swaps, sync-domain fusion changes from
:class:`repro_torch.fleet.runtime.ElasticFleetPlanner`, contract violations, and
counter tracks sampled at drain cadence. Time axis: 1 stream hour = a fixed
number of trace microseconds (default 1000, i.e. 1 h → 1 ms), so a whole
8760-hour year spans ~8.76 trace-seconds — comfortably renderable.

Two export formats:

* :meth:`chrome_trace` / :meth:`save_chrome` — Chrome trace-event JSON
  (``{"traceEvents": [...]}``), loadable directly in Perfetto / chrome://tracing;
* :meth:`save_jsonl` — one raw event dict per line, grep/pandas friendly.

:func:`trace_from_plan` builds the same trace from an offline plan's
``state`` matrix, so streamed and batch runs render identically.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.togglecci import OFF, ON, WAITING


class TraceRecorder:
    """Accumulates events host-side; feed FSM state columns per tick.

    ``observe_states`` is vectorized over rows (one int compare + nonzero per
    tick); per-event work only happens on actual transitions, so tracing a
    quiet fleet costs ~a numpy compare per tick.
    """

    def __init__(
        self,
        n_rows: int,
        *,
        row_names: Optional[Sequence[str]] = None,
        hour_us: float = 1000.0,
        kind: str = "port",
    ):
        assert hour_us > 0
        self.n_rows = int(n_rows)
        self.row_names = (
            list(row_names)
            if row_names is not None
            else [f"{kind}{r}" for r in range(n_rows)]
        )
        assert len(self.row_names) == self.n_rows
        self.hour_us = float(hour_us)
        self.events: List[dict] = []          # raw structured log (JSONL)
        self._slices: List[dict] = []         # closed chrome "X" slices
        self._open: Dict[int, dict] = {}      # row -> open slice
        self._prev = np.full(self.n_rows, OFF, np.int64)
        self._last_hour = 0

    # -- structured log ----------------------------------------------------

    def _log(self, type_: str, hour: int, **kw) -> None:
        self.events.append({"type": type_, "hour": int(hour), **kw})

    def _begin(self, row: int, hour: int, name: str) -> None:
        self._open[row] = {"row": int(row), "name": name, "start": int(hour)}

    def _end(self, row: int, hour: int) -> None:
        s = self._open.pop(row, None)
        if s is not None:
            self._slices.append({**s, "end": int(hour)})

    def observe_states(self, hour: int, state) -> None:
        """One tick: diff the FSM state vector against the previous tick and
        log lease lifecycle edges. ``hour`` is the hour just SERVED."""
        st = np.asarray(state, np.int64)
        self._last_hour = max(self._last_hour, int(hour) + 1)
        changed = np.nonzero(st != self._prev)[0]
        for r in changed:
            r = int(r)
            p, s = int(self._prev[r]), int(st[r])
            if p == OFF and s == WAITING:
                self._log("toggle", hour, event="request", row=r)
                self._begin(r, hour, "provisioning")
            elif p != ON and s == ON:
                if p == OFF:  # D = 0: request and activation in one hour
                    self._log("toggle", hour, event="request", row=r)
                    self._begin(r, hour, "provisioning")
                self._log("toggle", hour, event="activate", row=r)
                self._end(r, hour)
                self._begin(r, hour, "leased")
            elif p == ON and s == OFF:
                self._log("toggle", hour, event="release", row=r)
                self._end(r, hour)
            else:  # defensive: unexpected edge (e.g. WAITING→OFF)
                self._log("toggle", hour, event=f"edge{p}->{s}", row=r)
                self._end(r, hour)
        self._prev = st

    def instant(self, hour: int, name: str, **args) -> None:
        """Global instant event (reroute, violation, sync-domain change)."""
        self._log(name, hour, **args)

    def counter(self, hour: int, name: str, values: Dict[str, float]) -> None:
        """Counter-track sample (drain-cadence gauges)."""
        self._log("counter", hour, name=name, values=values)

    # -- exports -----------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON: per-row tracks + instants + counters."""
        us = self.hour_us
        evs: List[dict] = [
            {
                "ph": "M", "pid": 0, "tid": r, "name": "thread_name",
                "args": {"name": self.row_names[r]},
            }
            for r in range(self.n_rows)
        ]
        open_end = self._last_hour  # close still-open leases at horizon end
        slices = self._slices + [
            {**s, "end": open_end} for s in self._open.values()
        ]
        for s in slices:
            evs.append({
                "ph": "X", "pid": 0, "tid": s["row"], "cat": "lease",
                "name": s["name"], "ts": s["start"] * us,
                "dur": max(s["end"] - s["start"], 0.05) * us,
            })
        for e in self.events:
            if e["type"] == "counter":
                evs.append({
                    "ph": "C", "pid": 0, "name": e["name"],
                    "ts": e["hour"] * us, "args": e["values"],
                })
            elif e["type"] != "toggle":
                args = {k: v for k, v in e.items() if k not in ("type", "hour")}
                evs.append({
                    "ph": "i", "pid": 0, "tid": 0, "s": "g",
                    "name": e["type"], "ts": e["hour"] * us, "args": args,
                })
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def save_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def save_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for e in self.events:
                f.write(json.dumps(e) + "\n")
        return path

    @property
    def n_events(self) -> int:
        return len(self.events)


def trace_from_plan(
    state,
    *,
    row_names: Optional[Sequence[str]] = None,
    hour_us: float = 1000.0,
    kind: str = "port",
) -> TraceRecorder:
    """Build a :class:`TraceRecorder` from an OFFLINE plan's (rows, T) FSM
    state matrix (``plan["state"]``) — batch and streamed runs render the
    same way in Perfetto."""
    state = state.cpu().numpy() if hasattr(state, "cpu") else np.asarray(state)
    rec = TraceRecorder(
        state.shape[0], row_names=row_names, hour_us=hour_us, kind=kind
    )
    for t in range(state.shape[1]):
        rec.observe_states(t, state[:, t])
    return rec
