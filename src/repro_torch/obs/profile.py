"""Profiling hooks: tick latency, transfer bytes, compile counters.

Port of :mod:`repro.obs.profile`. Host-side and allocation-light: one
``perf_counter`` pair per tick or chunk (taken by the runtime, only when
observability is on) appended to a float list, plus integer byte counters
for the transfers the step pays: the chunk's packed host-to-device block and
its packed result copied back. The latency distribution is the replanning
latency the paper's online algorithm imposes per simulated hour; a p99 far
above p50 points at a device synchronisation or a rebuild.

The port compiles nothing per shape (its kernels are built once, up front,
by :mod:`repro_torch.kernels._lib`), so no runtime calls
:meth:`TickProfiler.note_compile` and ``compiles`` stays 0; the counter keeps
the reference's report layout.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class TickProfiler:
    def __init__(self):
        self.tick_s: List[float] = []
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.drains = 0
        self.compiles = 0      # kernel variants built while stepping: none in the port
        self.chunks = 0        # chunked step_many dispatches recorded
        self.chunk_ticks = 0   # hours covered by those dispatches

    def record(self, dt_s: float, h2d_bytes: int, d2h_bytes: int) -> None:
        self.tick_s.append(float(dt_s))
        self.h2d_bytes += int(h2d_bytes)
        self.d2h_bytes += int(d2h_bytes)

    def record_chunk(
        self, dt_s: float, h2d_bytes: int, d2h_bytes: int, ticks: int
    ) -> None:
        """One chunked dispatch covering ``ticks`` hours: wall time is
        attributed per covered hour (so tick percentiles stay comparable
        across chunked and per-tick streams), transfer bytes count once —
        the per-chunk packing IS what chunking amortizes."""
        ticks = max(1, int(ticks))
        self.tick_s.extend([float(dt_s) / ticks] * ticks)
        self.h2d_bytes += int(h2d_bytes)
        self.d2h_bytes += int(d2h_bytes)
        self.chunks += 1
        self.chunk_ticks += ticks

    def note_compile(self) -> None:
        self.compiles += 1

    def note_drain(self) -> None:
        self.drains += 1

    @property
    def ticks(self) -> int:
        return len(self.tick_s)

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)) -> Dict[str, float]:
        """Tick-latency percentiles in MICROSECONDS (µs)."""
        if not self.tick_s:
            return {f"p{int(q)}": float("nan") for q in qs}
        arr = np.asarray(self.tick_s) * 1e6
        return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> dict:
        pct = self.percentiles()
        return {
            "ticks": self.ticks,
            "tick_us_p50": pct["p50"],
            "tick_us_p95": pct["p95"],
            "tick_us_p99": pct["p99"],
            "tick_us_mean": (
                float(np.mean(self.tick_s) * 1e6) if self.tick_s else float("nan")
            ),
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "drains": self.drains,
            "compiles": self.compiles,
            "chunks": self.chunks,
            "chunk_ticks": self.chunk_ticks,
        }
