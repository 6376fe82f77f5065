"""Collective-mode mapping of the actuation layer.

Only :func:`collective_mode` is ported from :mod:`repro.core.planner` (a
copy; the streaming runtime's :meth:`~repro_torch.fleet.runtime.FleetRuntime.modes`
uses it). The single-link ``InterconnectPlanner`` waits for the actuation
slice (ROADMAP Queue 1, item 10).
"""
from __future__ import annotations

from .togglecci import ON


def collective_mode(state: int) -> str:
    """Map one link's FSM state to its cross-pod collective mode.

    ON means the leased link serves traffic: full-precision hierarchical
    all-reduce. OFF/WAITING ride the pay-per-GB path: int8 + error-feedback
    compressed sync (``repro.dist.collectives.sync_grads`` modes).
    """
    return "hierarchical" if state == ON else "compressed"
