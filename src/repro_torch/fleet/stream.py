"""``repro_torch.fleet.stream`` — the streaming surface, as far as it is ported.

Facade of :mod:`repro.fleet.stream`: the incremental runtime
(:class:`FleetRuntime`, its frozen :class:`RuntimeConfig`, and the operand
resolution it shares) and the endogenous-demand planner over it
(:class:`ElasticFleetPlanner`, per link or per port). The runtime streams
the forecast-gated policy in replay mode (its predictions given); the live
forecaster keeps its names here and raises ``NotImplementedError`` naming
the ROADMAP item that ports it (6b-2).
"""
from .runtime import (  # noqa: F401
    _FORECAST,
    ElasticFleetPlanner,
    FleetPlannerReport,
    FleetRuntime,
    ResolvedRuntime,
    RuntimeConfig,
    not_ported,
    resolve_runtime_operands,
)


class StreamingForecaster:
    """Not ported yet (ROADMAP Queue 1, item 6b-2): the live SSM demand forecaster."""

    def __init__(self, *args, **kwargs):
        raise not_ported(_FORECAST)

    @classmethod
    def fit(cls, *args, **kwargs):
        raise not_ported(_FORECAST)


def streaming_forecast_policy(*args, **kwargs):
    """Not ported yet (ROADMAP Queue 1, item 6b-2): the live-mode forecast
    policy factory."""
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
