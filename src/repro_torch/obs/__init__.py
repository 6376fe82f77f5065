"""Fleet observability in the port: the metrics ring, event tracing, live
contract monitors, and profiling hooks for the streaming runtime (port of
:mod:`repro.obs`, the same names).

Quickstart::

    from repro_torch.fleet.stream import FleetRuntime
    from repro_torch.obs import ObsConfig

    rt = FleetRuntime(spec, obs=ObsConfig(cadence=72, divergence=True))
    for t in range(0, T, 24):
        rt.step_many(demand[:, t:t + 24])    # a chunk may end on a drain hour
    rt.obs_check()                           # raises ContractViolation on breach
    print(rt.obs_report().render_text())
    rt.obs.trace.save_chrome("trace.json")   # open in Perfetto

Design notes live in the submodules: :mod:`repro_torch.obs.metrics` (the
ring, and why the port keeps it on the host), :mod:`repro_torch.obs.trace`
(Chrome trace-event export), :mod:`repro_torch.obs.monitors` (the
contracts), :mod:`repro_torch.obs.profile` (step latency and transfer
accounting). Decisions are bit-identical with observability on or off — the
ring consumes the chunk's outputs, it never feeds back.
"""
from .metrics import (
    DrainedMetrics,
    MetricsRing,
    default_hist_edges,
    flatten_ring,
    init_ring,
    init_tenant_ring,
    reset_ring,
    reset_ring_slot,
    ring_layout,
    ring_size,
    update_ring,
    update_ring_chunk,
)
from .monitors import (
    BillingMonitor,
    CalibrationMonitor,
    ContractViolation,
    DivergenceMonitor,
    RegretMonitor,
    TenantSLOMonitor,
)
from .observer import FleetObserver, ObsConfig, ObsReport
from .profile import TickProfiler
from .trace import TraceRecorder, trace_from_plan

__all__ = [
    "BillingMonitor",
    "CalibrationMonitor",
    "ContractViolation",
    "DivergenceMonitor",
    "DrainedMetrics",
    "FleetObserver",
    "MetricsRing",
    "ObsConfig",
    "ObsReport",
    "RegretMonitor",
    "TenantSLOMonitor",
    "TickProfiler",
    "TraceRecorder",
    "default_hist_edges",
    "flatten_ring",
    "init_ring",
    "init_tenant_ring",
    "reset_ring",
    "reset_ring_slot",
    "ring_layout",
    "ring_size",
    "trace_from_plan",
    "update_ring",
    "update_ring_chunk",
]
