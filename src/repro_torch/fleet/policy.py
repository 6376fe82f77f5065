"""Toggle policies: the decision layer of the fleet planner, in PyTorch.

Port of :mod:`repro.fleet.policy`:

* :class:`ReactivePolicy`      — the paper's ToggleCCI FSM;
* :class:`HysteresisPolicy`    — reactive plus consecutive-hour hold counts on
  both transitions (hold 1 is :class:`ReactivePolicy` exactly);
* :class:`ForecastGatedPolicy` — the FSM with its request and release gated
  by predicted mode costs: demand predictions (from the SSM forecaster of
  :mod:`repro_torch.models.ssm`) mapped through log-space demand→cost fits
  (:func:`fit_cost_coef`, :func:`predicted_mode_costs`).

A policy is a NamedTuple of per-row tensors (the JAX package's pytree),
with the static ``renew_in_chunks`` flag beside them. :func:`policy_scan`
runs one over (N, T) cost planes: on CUDA through the FSM scan kernel (its
gated instance for the forecast policy, which reads the predicted demand and
the cost coefficients and decides the gates itself), on the CPU through its
plain per-hour loop over :func:`_fsm_cascade` (the predicted-cost planes
formed by torch ops first). ``make_policy("forecast", ...)`` raises, as
it does in the JAX package: the policy is built from predictions with
:func:`forecast_gated_policy`, or by the factories that train the
forecaster on a history first (:func:`forecast_port_demand`,
:func:`forecast_fleet_policy`, :func:`forecast_topology_policy`; the
training is :func:`repro_torch.models.ssm.train_demand_forecaster`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.togglecci import OFF, ON, WAITING, ToggleParams
from repro_torch.device import DeviceLike, resolve_device, to_host
from repro_torch.kernels import ops

POLICY_KINDS = ("reactive", "hysteresis", "forecast")


def _fsm_cascade(tp: ToggleParams, renew_in_chunks: bool, carry, req_cond, rel_cond):
    """One hour of the OFF→WAITING→ON cascade, vectorised over rows.

    The transition spec of :func:`repro_torch.core.togglecci.run_togglecci`
    (start-of-hour transitions, ``t_state`` counts hours served in-state),
    with the request and release conditions given by the policy. The plain
    version of the FSM scan kernel steps through T hours with this.
    """
    state, t_state = carry

    go_wait = (state == OFF) & req_cond
    s1 = torch.where(go_wait, WAITING, state)
    ts1 = torch.where(go_wait, 0, t_state)

    wait_done = (s1 == WAITING) & (ts1 >= tp.D)
    s2 = torch.where(wait_done, ON, s1)
    ts2 = torch.where(wait_done, 0, ts1)

    past_commit = ts2 >= tp.T_cci
    at_renewal = (ts2 % tp.T_cci) == 0
    check = past_commit & at_renewal if renew_in_chunks else past_commit
    go_off = (s2 == ON) & check & rel_cond
    s3 = torch.where(go_off, OFF, s2)
    ts3 = torch.where(go_off, 0, ts2)

    x_t = (s3 == ON).to(torch.int32)
    return (s3, ts3 + 1), (x_t, s3)


class ReactivePolicy(NamedTuple):
    """The paper's ToggleCCI decision rule: request when ``R_CCI < θ₁·R_VPN``,
    release when ``R_CCI > θ₂·R_VPN``."""

    toggle: ToggleParams
    renew_in_chunks: bool = False  # release only at T_cci multiples

    kind = "reactive"

    def init_carry(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row FSM carry at hour 0: ``(state, t_state)``, (N,) int32."""
        z = torch.zeros_like(self.toggle.h)
        return (z, z)

    def holds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(up_hold, down_hold)``: 1, which makes the hold rule reactive."""
        one = torch.ones_like(self.toggle.h)
        return (one, one)


class HysteresisPolicy(NamedTuple):
    """Reactive thresholds debounced by consecutive-hour hold counts.

    A request (release) fires only after its window condition has held for
    ``up_hold`` (``down_hold``) consecutive hours.
    """

    toggle: ToggleParams
    up_hold: torch.Tensor    # (N,) int32 ≥ 1
    down_hold: torch.Tensor  # (N,) int32 ≥ 1
    renew_in_chunks: bool = False

    kind = "hysteresis"

    def init_carry(self) -> Tuple[torch.Tensor, ...]:
        """Per-row FSM carry at hour 0: ``(state, t_state, up, down)``, (N,)
        int32 — the consecutive-hour counters ride beside the FSM."""
        z = torch.zeros_like(self.toggle.h)
        return (z, z, z, z)

    def holds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.up_hold, self.down_hold)


_LOG_COST_EPS = 1e-9  # idle rows (no routed pairs) have zero cost series


def fit_cost_coef(demand: torch.Tensor, vpn_hourly: torch.Tensor,
                  cci_hourly: torch.Tensor) -> torch.Tensor:
    """Log-space demand→cost maps, least squares on the first half.

    ``(..., T)`` inputs → ``(..., 4)`` coefficients ``[a_vpn, b_vpn, a_cci,
    b_cci]`` such that ``cost ≈ exp(a + b·log1p(demand))``, fitted on the
    first ``max(T // 2, 2)`` hours (the formula of
    :func:`repro.fleet.policy.fit_cost_coef`; an idle row's zero costs are
    floored at 1e-9 before the log, and a row whose ``log1p(demand)`` has
    variance ≤ 1e-12 gets a slope of 0). The pricing function is static, so
    this is structure recovery, not lookahead.
    """
    T = vpn_hourly.shape[-1]
    fit_T = max(T // 2, 2)
    x = torch.log1p(demand[..., :fit_T])
    xm = x.mean(dim=-1, keepdim=True)
    dx = x - xm
    var = (dx * dx).mean(dim=-1)
    eps = torch.tensor(_LOG_COST_EPS, dtype=x.dtype, device=x.device)

    def loglin(y):
        y0 = torch.log(torch.maximum(y[..., :fit_T], eps))
        cov = (dx * (y0 - y0.mean(dim=-1, keepdim=True))).mean(dim=-1)
        beta = torch.where(var > 1e-12, cov / torch.clamp(var, min=1e-12),
                           torch.zeros_like(var))
        return y0.mean(dim=-1) - beta * xm[..., 0], beta

    av, bv = loglin(vpn_hourly)
    ac, bc = loglin(cci_hourly)
    return torch.stack([av, bv, ac, bc], dim=-1)


def predicted_mode_costs(pred: torch.Tensor, cost_coef: torch.Tensor,
                         dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map predicted demand through the log-space fit → ``(p_vpn, p_cci)``:
    ``exp(a + b·log1p(pred))`` per mode, elementwise, for ``pred`` (..., T)
    and ``cost_coef`` (..., 4)."""
    lp = torch.log1p(pred.to(dtype))
    coef = cost_coef.to(dtype)
    p_vpn = torch.exp(coef[..., 0, None] + coef[..., 1, None] * lp)
    p_cci = torch.exp(coef[..., 2, None] + coef[..., 3, None] * lp)
    return p_vpn, p_cci


class ForecastGatedPolicy(NamedTuple):
    """SSM-forecast-gated ToggleCCI (:class:`repro.fleet.policy.ForecastGatedPolicy`).

    ``pred_demand[:, t]`` is a causal estimate of mean demand over the next
    ``D + T_cci``-ish window, made from history through hour ``t − 1``.
    :meth:`features` maps it to predicted per-hour mode costs ``p_vpn``,
    ``p_cci`` through ``cost_coef`` (fitted on the realized series inside
    :func:`policy_scan` when ``None``). The gates, with per-row margin ``m``:

    * request — ``p_cci < (θ₁ − m)·p_vpn``, or the realized trigger
      ``R_CCI < θ₁·R_VPN`` with ``p_cci < (θ₁ + m)·p_vpn``;
    * release — ``p_cci > (θ₂ + m)·p_vpn``, or the realized trigger with
      ``p_cci > (θ₂ − m)·p_vpn``;

    then the reactive cascade. m → ∞ is reactive ToggleCCI; a NaN
    prediction fires and vetoes nothing (every comparison is false).
    """

    toggle: ToggleParams
    margin: torch.Tensor                       # (N,) float64 confidence margin m ≥ 0
    pred_demand: torch.Tensor                  # (N, T) float64 forward-window mean demand
    cost_coef: Optional[torch.Tensor] = None   # (N, 4) [a_vpn, b_vpn, a_cci, b_cci] or None
    renew_in_chunks: bool = False

    kind = "forecast"

    def init_carry(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-row FSM carry at hour 0: ``(state, t_state)``, (N,) int32."""
        z = torch.zeros_like(self.toggle.h)
        return (z, z)

    def holds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(1, 1)``: the gated cascade is the reactive one."""
        one = torch.ones_like(self.toggle.h)
        return (one, one)

    def coefficients(self, demand: Optional[torch.Tensor], vpn_hourly: torch.Tensor,
                     cci_hourly: torch.Tensor) -> torch.Tensor:
        """The (N, 4) cost coefficients: ``cost_coef``, or fitted on the
        realized series (:func:`fit_cost_coef`) when it is None."""
        if self.cost_coef is not None:
            return self.cost_coef
        if demand is None:
            raise ValueError(
                "ForecastGatedPolicy needs the demand series to map predicted demand "
                "to predicted mode costs (or pass explicit cost_coef)")
        return fit_cost_coef(demand.to(vpn_hourly.dtype), vpn_hourly, cci_hourly)

    def features(self, demand: Optional[torch.Tensor], vpn_hourly: torch.Tensor,
                 cci_hourly: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (N, T) predicted mode costs the gates compare, in the cost
        planes' dtype."""
        return predicted_mode_costs(self.pred_demand,
                                    self.coefficients(demand, vpn_hourly, cci_hourly),
                                    vpn_hourly.dtype)


Policy = Union[ReactivePolicy, HysteresisPolicy, ForecastGatedPolicy]


def policy_to(policy: Policy, device) -> Policy:
    """The policy with every tensor on ``device`` (its toggle parameters too)."""
    move = lambda f: f.to(device) if hasattr(f, "to") else f
    return type(policy)(*(move(f) for f in policy))


def policy_scan(policy: Policy, vpn_hourly: torch.Tensor, cci_hourly: torch.Tensor,
                *, demand: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Run a toggle policy over (N, T) per-hour mode costs, one row per link.

    The counterpart of :func:`repro.fleet.policy.policy_scan` vmapped over
    rows. Every policy goes through :func:`repro_torch.kernels.ops.fsm_scan`
    (the reactive rule as hold counts of 1; the forecast-gated policy with
    its predicted demand, cost coefficients and margins as the gate, the
    coefficients fitted first on ``demand`` (N, T) when the policy carries
    no ``cost_coef``). Returns ``x`` and ``state`` (N, T) int32 and
    ``total_cost`` (N,) float64.
    """
    tp = policy.toggle
    if not isinstance(policy, (ReactivePolicy, HysteresisPolicy, ForecastGatedPolicy)):
        raise TypeError(f"policy_scan: unsupported policy {type(policy).__name__}")
    vpn = vpn_hourly.to(torch.float64)
    cci = cci_hourly.to(torch.float64)
    gate = None
    if isinstance(policy, ForecastGatedPolicy):
        if policy.pred_demand.shape != vpn.shape:
            raise ValueError(f"pred_demand {tuple(policy.pred_demand.shape)} does not match "
                             f"the cost planes {tuple(vpn.shape)}")
        gate = (policy.pred_demand.to(torch.float64),
                policy.coefficients(demand, vpn, cci).to(torch.float64),
                policy.margin.to(torch.float64))
    up, down = policy.holds()
    return ops.fsm_scan(
        vpn, cci, tp.theta1, tp.theta2, tp.h, tp.D, tp.T_cci, up, down,
        renew_in_chunks=policy.renew_in_chunks, gate=gate,
    )


def fsm_carry(policy: Policy) -> torch.Tensor:
    """The (4, N) int32 carry the FSM kernels step: ``state``, ``t_state``,
    ``up``, ``down``. A reactive policy's carry is ``(state, t_state)``; its
    hold counters are carried as zeros and never gate (its holds are 1)."""
    c = policy.init_carry()
    z = torch.zeros_like(c[0])
    return torch.stack(c + (z,) * (4 - len(c)))


def reactive_policy(toggle: ToggleParams, *, renew_in_chunks: bool = False
                    ) -> ReactivePolicy:
    return ReactivePolicy(toggle=toggle, renew_in_chunks=bool(renew_in_chunks))


def hysteresis_policy(
    toggle: ToggleParams,
    *,
    up_hold: int = 6,
    down_hold: int = 6,
    renew_in_chunks: bool = False,
) -> HysteresisPolicy:
    return HysteresisPolicy(
        toggle=toggle,
        up_hold=torch.full_like(toggle.h, up_hold),
        down_hold=torch.full_like(toggle.h, down_hold),
        renew_in_chunks=bool(renew_in_chunks),
    )


def forecast_gated_policy(
    toggle: ToggleParams,
    pred_demand,
    *,
    margin=0.05,
    cost_coef=None,
    renew_in_chunks: bool = False,
) -> ForecastGatedPolicy:
    """Wrap forward-window demand predictions (rows, T) as a gated policy, on
    the toggle parameters' device, in float64.

    ``margin`` is a scalar or a per-row array matching ``toggle.theta1``
    (see :func:`family_margins`). ``cost_coef`` (rows, 4) bakes the
    demand→cost maps in; ``None`` defers the fit to scan time.
    """
    dev, f = toggle.theta1.device, torch.float64
    as_f64 = lambda a: (a if torch.is_tensor(a)
                        else torch.from_numpy(np.array(a, np.float64))).to(dev, f)
    return ForecastGatedPolicy(
        toggle=toggle,
        margin=torch.broadcast_to(as_f64(margin), toggle.theta1.shape).contiguous(),
        pred_demand=as_f64(pred_demand),
        cost_coef=None if cost_coef is None else as_f64(cost_coef),
        renew_in_chunks=bool(renew_in_chunks),
    )


def make_policy(kind: str, toggle: ToggleParams, *, renew_in_chunks=False, **kw):
    """Build a policy by name — the ``FleetSpec.policy`` selection hook the
    engine resolves when no policy object is passed."""
    if kind == "reactive":
        if kw:
            raise ValueError(f"reactive policy takes no extra options, got {kw}")
        return reactive_policy(toggle, renew_in_chunks=renew_in_chunks)
    if kind == "hysteresis":
        return hysteresis_policy(toggle, renew_in_chunks=renew_in_chunks, **kw)
    if kind == "forecast":
        raise ValueError(
            "the forecast policy needs a trained forecaster: build it with "
            "forecast_fleet_policy(...) / forecast_topology_policy(...) (or "
            "forecast_gated_policy on your own predictions) and pass it as "
            "policy=... to the planner"
        )
    raise ValueError(f"unknown toggle policy {kind!r} (known: {POLICY_KINDS})")


# Per-family confidence margins for the forecast gates (the JAX package's
# table, from its `bench_policy` margin sweeps): mirage's user-growth traces
# need a wider bar than the stationary and bursty families.
FAMILY_MARGINS = {
    "constant": 0.05,
    "bursty": 0.05,
    "mirage": 0.15,
    "puffer": 0.05,
}


def family_margins(families, *, default: float = 0.05, overrides=None) -> np.ndarray:
    """Per-row confidence margins from demand-family labels (one per
    link/port row, e.g. ``[l.family for l in fleet.links]``); unknown labels
    take ``default``. A (rows,) float64 array for ``margin=``."""
    table = dict(FAMILY_MARGINS)
    if overrides:
        table.update(overrides)
    return np.asarray([table.get(f, default) for f in families], np.float64)


def forecast_horizon_hours(toggle: ToggleParams) -> int:
    """The fleet-wide forecast window: mean ``D + T_cci`` over the rows."""
    return int(np.mean(to_host(toggle.D, np.float64) + to_host(toggle.T_cci, np.float64)))


def forecast_port_demand(
    history,
    live,
    window: int,
    *,
    state_dim: int = 8,
    steps: int = 300,
    lr: float = 2e-2,
    seed: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Causal forward-window demand forecasts for every row of ``live``, a
    float64 (N, T) tensor on ``device`` (CUDA unless the caller says
    otherwise).

    :func:`repro.fleet.policy.forecast_port_demand`: trains the forecaster on
    ``history`` (N, H), strictly earlier hours, then runs it over
    ``concat(history, live)`` so that ``pred[:, t]`` (the predicted mean
    demand over live hours ``[t, t + window)``) uses demand strictly before
    live hour ``t``. With ``history=None`` the first ``max(T // 2, 2)`` hours
    of ``live`` are the training data, and hour 0 predicts the fit's mean
    (``scale``).
    """
    from repro_torch.models.ssm import demand_forecaster_predict, train_demand_forecaster

    dev = resolve_device(device)
    live = to_host(live, np.float64)
    n, T = live.shape
    if history is None:
        train, full, offset = live[:, :max(T // 2, 2)], live, 0
    else:
        history = to_host(history, np.float64)
        if history.shape[0] != n:
            raise ValueError(f"history has {history.shape[0]} rows, live {n}")
        train, full, offset = history, np.concatenate([history, live], axis=1), history.shape[1]
    params, scale = train_demand_forecaster(train, window, state_dim=state_dim, steps=steps,
                                            lr=lr, seed=seed, device=dev)
    y = demand_forecaster_predict(params, full, scale, device=dev)
    # y[:, j] predicts the window starting at hour j+1 from full[:, :j+1]; live
    # hour t is full hour offset+t, so its forecast is y[:, offset+t-1].
    if offset > 0:
        return y[:, offset - 1:offset - 1 + T].contiguous()
    pred = torch.empty((n, T), dtype=torch.float64, device=dev)
    pred[:, 1:] = y[:, :T - 1]
    pred[:, 0] = torch.from_numpy(scale).to(dev)
    return pred


def _forecast_policy(arrays, series, demand, history, *, margin, hours_per_month,
                     renew_in_chunks, device, train_kw) -> ForecastGatedPolicy:
    """The forecast factories' shared tail: forecasts of the rows' clipped
    series (``series`` maps a (P, T) block to the rows' demand), cost
    coefficients fitted on the engine's cost series of ``demand``."""
    from .engine import routed_cost_series

    dev = resolve_device(device)
    arrays = arrays.to(dev)
    pred = forecast_port_demand(None if history is None else series(history), series(demand),
                                forecast_horizon_hours(arrays.toggle), device=dev, **train_kw)
    s = routed_cost_series(arrays, demand, hours_per_month=hours_per_month, device=dev)
    coef = fit_cost_coef(s.row_demand, s.vpn, s.cci)
    return forecast_gated_policy(arrays.toggle, pred, margin=margin, cost_coef=coef,
                                 renew_in_chunks=renew_in_chunks)


def forecast_fleet_policy(
    arrays,
    demand,
    history=None,
    *,
    margin=0.05,
    hours_per_month: int = 730,
    renew_in_chunks=False,
    device: DeviceLike = None,
    **train_kw,
) -> ForecastGatedPolicy:
    """Train the forecaster on per-link demand history and wrap it as a
    policy, on ``device`` (CUDA unless the caller says otherwise).

    :func:`repro.fleet.policy.forecast_fleet_policy`: ``arrays`` is a
    :class:`~repro_torch.fleet.spec.FleetArrays`, ``demand``/``history``
    (N, T)/(N, H) GB/hr, clipped at link capacity for the forecaster; the
    demand→cost coefficients are fitted on the engine's own cost series
    (:func:`repro_torch.fleet.engine.routed_cost_series`) and baked into the
    policy, so the streaming runtime can gate on them. ``train_kw`` goes to
    :func:`forecast_port_demand` (``steps``, ``lr``, ``state_dim``, ``seed``).
    """
    cap = to_host(arrays.capacity, np.float64)[:, None]
    clip = lambda d: np.minimum(to_host(d, np.float64), cap)
    return _forecast_policy(arrays, clip, demand, history, margin=margin,
                            hours_per_month=hours_per_month, renew_in_chunks=renew_in_chunks,
                            device=device, train_kw=train_kw)


def forecast_topology_policy(
    arrays,
    demand,
    history=None,
    *,
    margin=0.05,
    hours_per_month: int = 730,
    renew_in_chunks=False,
    device: DeviceLike = None,
    **train_kw,
) -> ForecastGatedPolicy:
    """Per-PORT forecast policy: pair demand aggregated onto the routed ports
    first, on ``device`` (CUDA unless the caller says otherwise).

    :func:`repro.fleet.policy.forecast_topology_policy`: ``arrays`` is a
    routed :class:`~repro_torch.fleet.topology.TopologyArrays`; the
    aggregate mirrors the engine (VLAN access clip per pair, a multi-hot (M,
    P) membership matrix off the routing operand's legs, so a multi-hop row
    adds its demand to every hop's port, then the hard CCI clip per port),
    formed in numpy on the host as the JAX package forms it. Cost
    coefficients as in :func:`forecast_fleet_policy`, on the engine's
    port-aggregated series.
    """
    op = arrays.routing
    R = np.zeros((int(arrays.L_cci.shape[0]), int(arrays.L_vpn.shape[0])))
    np.add.at(R, (to_host(op.leg_port), to_host(op.leg_pair)), to_host(op.attach_w, np.float64))
    pair_cap = to_host(arrays.pair_capacity, np.float64)[:, None]
    port_cap = to_host(arrays.port_capacity, np.float64)[:, None]
    agg = lambda d: np.minimum(R @ np.minimum(to_host(d, np.float64), pair_cap), port_cap)
    return _forecast_policy(arrays, agg, demand, history, margin=margin,
                            hours_per_month=hours_per_month, renew_in_chunks=renew_in_chunks,
                            device=device, train_kw=train_kw)
