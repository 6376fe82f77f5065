"""The multi-tenant gateway of :mod:`repro.gateway`: not ported yet.

``FleetGateway`` keeps its name and raises ``NotImplementedError`` naming
the ROADMAP item that ports it (Queue 1, item 9).
"""
from repro_torch.fleet.runtime import not_ported


class FleetGateway:
    """Not ported yet: pooled tenants behind one batched tick."""

    def __init__(self, *args, **kwargs):
        raise not_ported("the multi-tenant gateway is ROADMAP Queue 1, item 9")
