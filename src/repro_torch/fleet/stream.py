"""``repro_torch.fleet.stream`` — the streaming surface, as far as it is ported.

Facade of :mod:`repro.fleet.stream`: the incremental runtime
(:class:`FleetRuntime`, its frozen :class:`RuntimeConfig`, and the operand
resolution it shares), the live forecaster it streams the forecast-gated
policy with (:class:`StreamingForecaster`) and the endogenous-demand planner
over it (:class:`ElasticFleetPlanner`, per link or per port). Training the
forecaster (``StreamingForecaster.fit``, :func:`streaming_forecast_policy`)
raises ``NotImplementedError`` naming the ROADMAP item that ports it (6c).
"""
from .runtime import (  # noqa: F401
    _FORECAST,
    ElasticFleetPlanner,
    FleetPlannerReport,
    FleetRuntime,
    ResolvedRuntime,
    RuntimeConfig,
    StreamingForecaster,
    not_ported,
    resolve_runtime_operands,
)


def streaming_forecast_policy(*args, **kwargs):
    """Not ported yet (ROADMAP Queue 1, item 6c): the live-mode forecast
    policy factory, which trains the forecaster. Build the policy with
    :func:`repro_torch.fleet.policy.forecast_gated_policy` (``cost_coef=``
    given) and the forecaster with :meth:`StreamingForecaster.from_history`."""
    raise not_ported(_FORECAST)


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
