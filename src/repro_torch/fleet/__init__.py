"""Fleet planning in PyTorch: batched multi-link ToggleCCI portfolios.

Port of the fleet-mode half of :mod:`repro.fleet`: specs
(:mod:`~repro_torch.fleet.spec`), the reactive and hysteresis policies
(:mod:`~repro_torch.fleet.policy`), the engine
(:mod:`~repro_torch.fleet.engine`) and the scenario builder
(:mod:`~repro_torch.fleet.scenario`). Quick start, on an NVIDIA GPU::

    from repro_torch.fleet import build_fleet_scenario, plan_fleet
    sc = build_fleet_scenario(128, horizon=8760, seed=0)
    out = plan_fleet(sc.fleet, sc.demand)              # device="cuda"
"""
from .engine import (  # noqa: F401
    RoutedSeries,
    plan_fleet,
    plan_fleet_reference,
    routed_cost_series,
)
from .policy import (  # noqa: F401
    POLICY_KINDS,
    HysteresisPolicy,
    ReactivePolicy,
    hysteresis_policy,
    make_policy,
    policy_scan,
    reactive_policy,
)
from .scenario import (  # noqa: F401
    FAMILIES,
    FleetScenario,
    build_fleet_scenario,
    link_capacity_gb_hr,
)
from .spec import (  # noqa: F401
    PAD_BOUND,
    FleetArrays,
    FleetSpec,
    LinkSpec,
    fleet_arrays_from_numpy,
    fleet_from_params,
    pad_tier_tables,
)
