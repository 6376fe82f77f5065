"""Fleet planning in PyTorch: batched multi-link ToggleCCI portfolios.

Port of :mod:`repro.fleet`: specs (:mod:`~repro_torch.fleet.spec`), the
topology model and routing heuristics (:mod:`~repro_torch.fleet.topology`,
:mod:`~repro_torch.fleet.routing`), the reactive, hysteresis and
forecast-gated policies (:mod:`~repro_torch.fleet.policy`), the engine with ``plan_fleet``,
``plan_topology`` and the offline oracles (:mod:`~repro_torch.fleet.engine`;
the offline namespace :mod:`~repro_torch.fleet.plan`), the reports
(:mod:`~repro_torch.fleet.report`), the scenario builders
(:mod:`~repro_torch.fleet.scenario`) and the streaming runtime in fleet mode
(:mod:`~repro_torch.fleet.runtime`, facade :mod:`~repro_torch.fleet.stream`)
with the elastic planner that actuates the gradient sync
(:class:`~repro_torch.fleet.runtime.ElasticFleetPlanner`) and its
observability surface (:mod:`~repro_torch.fleet.observe`).
Quick start, on an NVIDIA GPU::

    from repro_torch.fleet import FleetRuntime, build_fleet_scenario, plan_fleet
    sc = build_fleet_scenario(128, horizon=8760, seed=0)
    out = plan_fleet(sc.fleet, sc.demand)              # device="cuda"
    rt = FleetRuntime(sc.fleet)                        # streams the same plan
    day = rt.step_many(sc.demand[:, :24])              # 24 hours, one chunk
    hour = rt.step(sc.demand[:, 24])                   # then one hour

    from repro_torch.fleet.observe import ObsConfig
    ort = FleetRuntime(sc.fleet, obs=ObsConfig(cadence=72))   # ring, trace, monitors
    for t in range(0, 8760, 24):
        ort.step_many(sc.demand[:, t:t + 24])
    ort.obs_check()                                    # raises ContractViolation on a breach
    print(ort.obs_report().render_text())

    from repro_torch.fleet import build_topology_scenario, plan_topology
    ts = build_topology_scenario(64, n_facilities=8, ports_per_facility=4, seed=0)
    plan = plan_topology(ts.topo, ts.demand)           # routes, then plans ports

    from repro_torch.fleet import build_report
    rep = build_report(sc, out, include_oracle=True)   # OPT column: one oracle_dp launch
    print(rep.render_text())

    # the forecast-gated policy, from given forecaster parameters
    import numpy as np, torch
    from repro_torch.models.ssm import demand_forecaster_init, demand_forecaster_predict
    from repro_torch.fleet import forecast_gated_policy
    arrays = sc.fleet.stack(torch.float64, "cuda")
    scale = np.maximum(sc.demand.mean(axis=1), 1e-9)
    pred = demand_forecaster_predict(demand_forecaster_init(), sc.demand, scale)
    fplan = plan_fleet(arrays, sc.demand, policy=forecast_gated_policy(arrays.toggle, pred))

    # ... or trained on a history (300 AdamW steps, the backward kernel on the card)
    from repro_torch.fleet import forecast_fleet_policy
    hs = build_fleet_scenario(128, horizon=8760, history_hours=4380, seed=0)
    harr = hs.fleet.stack(torch.float64, "cuda")
    hplan = plan_fleet(harr, hs.demand, policy=forecast_fleet_policy(harr, hs.demand, hs.history))
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
    fsm_carry,
    ForecastGatedPolicy,
    HysteresisPolicy,
    ReactivePolicy,
    family_margins,
    fit_cost_coef,
    forecast_fleet_policy,
    forecast_gated_policy,
    forecast_horizon_hours,
    forecast_port_demand,
    forecast_topology_policy,
    hysteresis_policy,
    make_policy,
    policy_scan,
    policy_to,
    predicted_mode_costs,
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
    LegIndex,
    RoutingOperand,
    RoutingPlan,
    as_routing_plan,
    index_legs,
    padded_operand_np,
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
    PAD_BOUND,
    FleetArrays,
    FleetSpec,
    LinkSpec,
    fleet_arrays_from_numpy,
    fleet_from_params,
    pad_tier_tables,
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
    topology_arrays_from_numpy,
)
from .runtime import (  # noqa: F401
    ElasticFleetPlanner,
    FleetPlannerReport,
    FleetRuntime,
    ResolvedRuntime,
    RuntimeConfig,
    RuntimeState,
    StreamingForecaster,
    resolve_runtime_operands,
)
from .stream import streaming_forecast_policy  # noqa: F401

from . import observe, stream  # noqa: F401,E402  (the namespaces, as repro.fleet's)
