"""The paper's contribution in PyTorch: pricing, cost model, ToggleCCI.

Port of :mod:`repro.core` (the pricing catalogs are a copy; the cost model
and ToggleCCI have torch paths beside their numpy references; the offline
oracle, the baselines, the adversary and the interconnect planner that
drives the gradient sync's mode are copies).

Public API:
    pricing.CostParams / make_scenario / TieredRate / breakeven_rate_gb_per_hour
    costmodel.hourly_cost_series / evaluate_schedule / cost_breakdown
    togglecci.run_togglecci / run_togglecci_scan
    baselines.BASELINES / evaluate_all
    oracle.offline_optimal / best_static
    adversary.instance_for_ratio / competitive_ratio
    planner.InterconnectPlanner
"""
from .pricing import (  # noqa: F401
    CostParams,
    TieredRate,
    breakeven_rate_gb_per_hour,
    flat_rate,
    make_scenario,
)
from .costmodel import (  # noqa: F401
    HourlyCosts,
    cost_breakdown,
    evaluate_schedule,
    hourly_cost_series,
    monthly_cumsum,
    tiered_marginal_cost_np,
    tiered_marginal_cost_tables,
)
from .planner import (  # noqa: F401
    COMPRESS_RATIO,
    InterconnectPlanner,
    PlannerReport,
    ToggleCCIController,
    collective_mode,
    cross_pod_bytes_per_step,
    dci_scenario,
    fleet_planner,
)
from .togglecci import (  # noqa: F401
    ToggleParams,
    ToggleResult,
    run_togglecci,
    run_togglecci_scan,
    window_sums,
)
from .baselines import BASELINES, evaluate_all  # noqa: F401
from .oracle import best_static, offline_optimal  # noqa: F401
from .adversary import competitive_ratio, instance_for_ratio  # noqa: F401
