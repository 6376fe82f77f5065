"""The paper's contribution in PyTorch: pricing, cost model, ToggleCCI.

Port of :mod:`repro.core` (the pricing catalogs are a copy; the cost model
and ToggleCCI have torch paths beside their numpy references).
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
    hourly_cost_series,
    monthly_cumsum,
    tiered_marginal_cost_np,
    tiered_marginal_cost_tables,
)
from .togglecci import (  # noqa: F401
    ToggleParams,
    ToggleResult,
    run_togglecci,
    run_togglecci_scan,
    window_sums,
)
