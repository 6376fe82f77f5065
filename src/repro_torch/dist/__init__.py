"""Distribution layer of the port: the gradient sync modes on
``torch.distributed``.

Modules
  collectives   direct / hierarchical / int8-compressed (error feedback)
                gradient sync over a ``DeviceMesh`` — the planners'
                endogenous-demand actuator — and its wire-byte model

Port of :mod:`repro.dist.collectives`. The sharding rules, activation
constraints and HLO telemetry of :mod:`repro.dist` are ROADMAP Queue 1,
item 12.
"""
from . import collectives  # noqa: F401
from .collectives import (  # noqa: F401
    INT8_MAX,
    fleet_sync_grads,
    init_error_state,
    sync_domain_label,
    sync_grads,
    sync_wire_bytes,
)
