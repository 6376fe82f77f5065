"""``repro_torch.fleet.stream`` — the streaming surface, as far as it is ported.

Facade of :mod:`repro.fleet.stream`: the incremental runtime
(:class:`FleetRuntime`, its frozen :class:`RuntimeConfig`, and the operand
resolution it shares), the live forecaster it streams the forecast-gated
policy with (:class:`StreamingForecaster`, trained by its ``fit``), the
live-mode policy factory that trains it (:func:`streaming_forecast_policy`)
and the endogenous-demand planner over it (:class:`ElasticFleetPlanner`, per
link or per port).
"""
from .runtime import (  # noqa: F401
    ElasticFleetPlanner,
    FleetPlannerReport,
    FleetRuntime,
    ResolvedRuntime,
    RuntimeConfig,
    StreamingForecaster,
    resolve_runtime_operands,
    streaming_forecast_policy,
)


__all__ = [
    "ElasticFleetPlanner",
    "FleetPlannerReport",
    "FleetRuntime",
    "ResolvedRuntime",
    "RuntimeConfig",
    "StreamingForecaster",
    "resolve_runtime_operands",
    "streaming_forecast_policy",
]
