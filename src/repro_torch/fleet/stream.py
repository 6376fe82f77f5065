"""``repro_torch.fleet.stream`` — the streaming surface, as far as it is ported.

Facade of :mod:`repro.fleet.stream`: the incremental runtime
(:class:`FleetRuntime`, its frozen :class:`RuntimeConfig`, and the operand
resolution it shares). The live forecaster and the endogenous-demand
elastic planner keep their names here and raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from .runtime import (  # noqa: F401
    _FORECAST,
    FleetRuntime,
    ResolvedRuntime,
    RuntimeConfig,
    not_ported,
    resolve_runtime_operands,
)

_ELASTIC = "ElasticFleetPlanner (the actuation layer) is ROADMAP Queue 1, item 10"


class StreamingForecaster:
    """Not ported yet: the live SSM demand forecaster."""

    def __init__(self, *args, **kwargs):
        raise not_ported(_FORECAST)

    @classmethod
    def fit(cls, *args, **kwargs):
        raise not_ported(_FORECAST)


class ElasticFleetPlanner:
    """Not ported yet: per-link modes actuating the collectives."""

    def __init__(self, *args, **kwargs):
        raise not_ported(_ELASTIC)


def streaming_forecast_policy(*args, **kwargs):
    """Not ported yet: the live-mode forecast policy factory."""
    raise not_ported(_FORECAST)


__all__ = [
    "ElasticFleetPlanner",
    "FleetRuntime",
    "ResolvedRuntime",
    "RuntimeConfig",
    "StreamingForecaster",
    "resolve_runtime_operands",
    "streaming_forecast_policy",
]
