"""``repro_torch.fleet.observe`` — the observability surface.

Facade of :mod:`repro.fleet.observe`: one import point for everything a
fleet operator watches: the metrics ring (and its tenant-axis pooled form),
drained-window records, contract monitors (including the gateway's
per-tenant SLO/billing reconciler), the runtime observer, tracing and
profiling. These re-export :mod:`repro_torch.obs`, which stays importable
directly, so streaming code can stay within the ``repro_torch.fleet.*``
namespaces (:mod:`~repro_torch.fleet.stream` and here).
"""
from repro_torch.obs import (  # noqa: F401
    BillingMonitor,
    CalibrationMonitor,
    ContractViolation,
    DivergenceMonitor,
    DrainedMetrics,
    FleetObserver,
    MetricsRing,
    ObsConfig,
    ObsReport,
    RegretMonitor,
    TenantSLOMonitor,
    TickProfiler,
    TraceRecorder,
    default_hist_edges,
    flatten_ring,
    init_ring,
    init_tenant_ring,
    reset_ring,
    reset_ring_slot,
    ring_layout,
    ring_size,
    trace_from_plan,
    update_ring,
    update_ring_chunk,
)

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
