"""Multi-tenant fleet gateway: pooled runtimes, one launch a bucket.

Port of :mod:`repro.gateway`. Thousands of independent tenants, each a full
streaming planning problem (its own
:class:`~repro_torch.fleet.topology.TopologySpec` and routing or fleet spec,
policy, billing calendar, horizon and demand stream), are served from
capacity-bucketed, free-list-allocated padded pools. One launch of the
pooled instance of ``stream_chunk`` or ``stream_chunk_routed`` (each row
with its own clock) advances every tenant of a bucket one hour, or K hours;
membership churn is operand traffic, so each bucket prepares its launch
shape once. Decisions and costs equal each tenant's standalone
:class:`~repro_torch.fleet.runtime.FleetRuntime` bit for bit.

Quick start::

    from repro_torch.fleet import RuntimeConfig, build_topology_scenario, optimize_routing
    from repro_torch.gateway import FleetGateway, GatewayConfig, TenantSpec, TenantSLO

    gw = FleetGateway(GatewayConfig(slots_per_bucket=8, cadence=32))   # the card
    sc = build_topology_scenario(6, horizon=720, seed=0)
    routing = optimize_routing(sc.topo, sc.demand)
    gw.join("acme", TenantSpec(spec=sc.topo, demand=sc.demand,
                               config=RuntimeConfig(routing=routing),
                               slo=TenantSLO(max_hourly_cost=50.0)))
    for hour in range(720):
        outs = gw.tick()          # one launch per non-empty bucket
        # outs["acme"] is the standalone FleetRuntime.step() dict
    print(gw.billing("acme"))     # host float64 lifetime totals
    print(gw.check())             # typed per-tenant ContractViolations

``FleetGateway(config, device="cpu")`` runs the kernels' plain versions.
Admission is bounded: when no bucket has headroom, joins queue FIFO up to
``queue_limit`` and then raise a typed :class:`AdmissionError`
(``reason="queue_full"`` / ``"too_large"``). ``gw.compiles`` counts the
launch shapes prepared; churn holds it constant.
"""
from .gateway import (
    AdmissionError,
    FleetGateway,
    GatewayConfig,
    TenantHandle,
    TenantSLO,
    TenantSpec,
)
from .pool import BucketKey, bucket_key_for, ceil_pow2, pack_tenant

__all__ = [
    "AdmissionError",
    "BucketKey",
    "FleetGateway",
    "GatewayConfig",
    "TenantHandle",
    "TenantSLO",
    "TenantSpec",
    "bucket_key_for",
    "ceil_pow2",
    "pack_tenant",
]
