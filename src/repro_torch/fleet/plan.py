"""``repro_torch.fleet.plan`` — the offline planning surface.

Port of :mod:`repro.fleet.plan`, limited to the names the port has: the
fleet and topology specs and their stacked tensor forms, the routing
currency, the engines, oracles and their numpy references, the policies
(reactive, hysteresis and forecast-gated, with the forecast factories,
three of which train the forecaster), the scenario generators and the reports. The
implementations stay in their submodules; this module only re-exports
them. The streaming twins live in :mod:`repro_torch.fleet.stream`.
"""
from .engine import (  # noqa: F401
    RoutedSeries,
    fleet_oracle,
    offline_stream_oracle,
    plan_fleet,
    plan_fleet_reference,
    plan_topology,
    plan_topology_reference,
    replay_plan_topology,
    routed_cost_series,
    topology_oracle,
    topology_port_costs_reference,
)
from .policy import (  # noqa: F401
    FAMILY_MARGINS,
    POLICY_KINDS,
    ForecastGatedPolicy,
    HysteresisPolicy,
    ReactivePolicy,
    family_margins,
    fit_cost_coef,
    forecast_fleet_policy,
    forecast_gated_policy,
    forecast_port_demand,
    forecast_topology_policy,
    hysteresis_policy,
    make_policy,
    policy_scan,
    reactive_policy,
)
from .report import (  # noqa: F401
    FleetReport,
    LinkReport,
    PortReport,
    TopologyReport,
    build_report,
    build_topology_report,
    lease_intervals,
    toggle_events,
)
from .routing import (  # noqa: F401
    RoutingOperand,
    RoutingPlan,
    as_routing_plan,
)
from .scenario import (  # noqa: F401
    FAMILIES,
    FleetScenario,
    TopologyScenario,
    broadcast_burst_trace,
    build_fleet_scenario,
    build_multicast_scenario,
    build_relay_scenario,
    build_reroute_scenario,
    build_topology_scenario,
    link_capacity_gb_hr,
    port_capacity_gb_hr,
    vlan_access_gb_hr,
)
from .spec import (  # noqa: F401
    FleetArrays,
    FleetSpec,
    LinkSpec,
    fleet_from_params,
)
from .topology import (  # noqa: F401
    MulticastSpec,
    PairSpec,
    PathSpec,
    PortSpec,
    TopologyArrays,
    TopologySpec,
    dedicated_fleet,
    identity_topology,
    multicast_unicast_expansion,
    optimize_routing,
    refine_routing,
    routing_matrix,
)

__all__ = [
    # specs
    "FleetArrays", "FleetSpec", "LinkSpec", "fleet_from_params",
    "MulticastSpec", "PairSpec", "PathSpec", "PortSpec",
    "TopologyArrays", "TopologySpec",
    "dedicated_fleet", "identity_topology",
    "multicast_unicast_expansion", "optimize_routing",
    "refine_routing", "routing_matrix",
    # routing currency
    "RoutingOperand", "RoutingPlan", "as_routing_plan",
    # engines
    "RoutedSeries", "fleet_oracle", "offline_stream_oracle", "plan_fleet",
    "plan_fleet_reference", "plan_topology", "plan_topology_reference",
    "replay_plan_topology", "routed_cost_series", "topology_oracle",
    "topology_port_costs_reference",
    # policies
    "FAMILY_MARGINS", "POLICY_KINDS", "ForecastGatedPolicy",
    "HysteresisPolicy", "ReactivePolicy", "family_margins",
    "fit_cost_coef", "forecast_fleet_policy", "forecast_gated_policy",
    "forecast_port_demand", "forecast_topology_policy",
    "hysteresis_policy", "make_policy", "policy_scan", "reactive_policy",
    # scenarios
    "FAMILIES", "FleetScenario", "TopologyScenario",
    "broadcast_burst_trace", "build_fleet_scenario",
    "build_multicast_scenario", "build_relay_scenario",
    "build_reroute_scenario", "build_topology_scenario",
    "link_capacity_gb_hr", "port_capacity_gb_hr", "vlan_access_gb_hr",
    # reports
    "FleetReport", "LinkReport", "PortReport", "TopologyReport",
    "build_report", "build_topology_report", "lease_intervals", "toggle_events",
]
