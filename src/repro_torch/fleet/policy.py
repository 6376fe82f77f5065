"""Toggle policies: the decision layer of the fleet planner, in PyTorch.

Port of :mod:`repro.fleet.policy` for the reactive and hysteresis rules:

* :class:`ReactivePolicy`   — the paper's ToggleCCI FSM;
* :class:`HysteresisPolicy` — reactive plus consecutive-hour hold counts on
  both transitions (hold 1 is :class:`ReactivePolicy` exactly).

A policy is a NamedTuple of per-row tensors (the JAX package's pytree),
with the static ``renew_in_chunks`` flag beside them. :func:`policy_scan`
runs one over (N, T) cost planes: on CUDA through the FSM scan kernel, on
the CPU through its plain per-hour loop over :func:`_fsm_cascade`. The
forecast-gated policy needs the SSM forecaster, which is not ported yet;
``make_policy("forecast", ...)`` raises, as it does in the JAX package.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch

from repro_torch.core.togglecci import OFF, ON, WAITING, ToggleParams
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


Policy = Union[ReactivePolicy, HysteresisPolicy]


def policy_scan(policy: Policy, vpn_hourly: torch.Tensor,
                cci_hourly: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Run a toggle policy over (N, T) per-hour mode costs, one row per link.

    The counterpart of :func:`repro.fleet.policy.policy_scan` vmapped over
    rows. Both policies go through :func:`repro_torch.kernels.ops.fsm_scan`
    (the reactive rule as hold counts of 1). Returns ``x`` and ``state``
    (N, T) int32 and ``total_cost`` (N,) float64.
    """
    tp = policy.toggle
    if isinstance(policy, HysteresisPolicy):
        up, down = policy.up_hold, policy.down_hold
    elif isinstance(policy, ReactivePolicy):
        up = down = torch.ones_like(tp.h)
    else:
        raise TypeError(f"policy_scan: unsupported policy {type(policy).__name__}")
    return ops.fsm_scan(
        vpn_hourly.to(torch.float64), cci_hourly.to(torch.float64),
        tp.theta1, tp.theta2, tp.h, tp.D, tp.T_cci, up, down,
        renew_in_chunks=policy.renew_in_chunks,
    )


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
            "the forecast policy needs a trained forecaster, which the PyTorch "
            "port does not have yet; use 'reactive' or 'hysteresis'"
        )
    raise ValueError(f"unknown toggle policy {kind!r} (known: {POLICY_KINDS})")
