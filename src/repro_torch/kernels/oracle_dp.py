"""Batched offline-optimal DP kernel wrapper — the reports' OPT column.

Replaces the reference's row-by-row numpy DP (:func:`repro.core.oracle.offline_optimal`'s
backward pass, run link by link by ``repro.fleet.engine.fleet_oracle`` and
port by port by ``topology_oracle``): the CUDA C++ kernels
(``csrc/oracle_dp.cu``) run every row's cost-to-go, every add
``__dadd_rn``, so each row's total and start state equal the numpy DP's bit
for bit, NaN included. Each row takes one of two forms, by its ``D`` and
``T_cci`` alone (:func:`launch_plan`):

- the register form, one warp a row and 4 to 16 rows a block
  (:func:`rows_per_block`): the ON states a ring of ``R1`` slots in
  registers, the WAITING states a shift register of ``R2``, OFF and ON free
  two scalars; ``K1 = ceil(R1 / 32)`` registers a lane for the ring and
  :data:`K2_MAX` for the WAITING states (none without them), each pair a
  compile-time instance. The fleet and topology scenarios' rows all take
  it.
- the large-row form, one block a row with the states in shared memory, for
  the rows past those limits.

A call launches each form that has rows: one launch, unless a batch mixes
them. Its plain PyTorch version, :func:`repro_torch.kernels.ref.oracle_dp_ref`,
is the same batched recurrence over (N, S_max) states with a Python loop
over hours. This wrapper takes CUDA tensors only;
:mod:`repro_torch.kernels.ops` dispatches CPU tensors to the plain version.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from . import _lib

#: The most states (D + T_cci + 2) a row of the large-row form may have: two
#: buffers of states and two 512-hour cost tiles, float64, in a block's 227 KB
#: of shared memory.
MAX_STATES = 232448 // 16 - 512
#: The register form's largest instance: K1 registers a lane hold the ON
#: ring's R1 = T_cci (T_cci - 1 when D == 0) slots, K2 the R2 = D - 1
#: WAITING positions, 32 lanes each (so T_cci up to 384, D up to 97).
K1_MAX, K2_MAX = 12, 3
#: The most rows a block of the register form takes (``kMaxWarps`` in
#: ``csrc/oracle_dp.cu``).
WARPS_MAX = 16
FORMS = ("auto", "register", "large")


class LaunchPlan(NamedTuple):
    order: torch.Tensor   # (N,) int32: the large-row form's rows, then the register form's
    regs: torch.Tensor    # (N,) int32: K1 * 4 + K2 of each row's register-form instance
    large: torch.Tensor   # (N,) bool: the row takes the large-row form
    fits: torch.Tensor    # (N,) bool: the register form holds the row


def launch_plan(D: torch.Tensor, T_cci: torch.Tensor, form: str = "auto") -> LaunchPlan:
    """Which form each row takes and the order the kernels walk the rows in,
    a pure function of ``D`` and ``T_cci`` (any device; on the card it stays
    there, the cost planes are not gathered). A row's instance is ``K1 =
    ceil(R1 / 32)`` and ``K2 = K2_MAX`` when it has a WAITING chain (``R2 >
    0``; three registers a lane, so a lane's carry into the next is every
    third hour and half the instances suffice), else 0. ``"auto"`` sends a
    row to the large-row form exactly when ``K1 > K1_MAX`` or ``R2 > 32 *
    K2_MAX``; ``"large"`` sends every row there; ``"register"`` none (the
    caller refuses a batch with a row that does not ``fit``). The order puts
    the large-row form's rows first, most states first, then the register
    form's by descending ``(K1, K2)``, each instance's rows together, so the
    heaviest rows start first and a block's rows mostly share one instance
    (:func:`rows_per_block`)."""
    if form not in FORMS:
        raise ValueError(f"form must be one of {FORMS}, got {form!r}")
    D, T_cci = D.to(torch.int64), T_cci.to(torch.int64)
    r1 = T_cci - (D == 0).to(torch.int64)
    r2 = (D - 1).clamp(min=0)
    k1 = (r1 + 31).div(32, rounding_mode="floor")
    k2 = torch.where(r2 > 0, K2_MAX, 0)
    fits = (k1 <= K1_MAX) & (r2 <= 32 * K2_MAX)
    if form == "auto":
        large = ~fits
    else:
        large = torch.full_like(fits, form == "large")
    regs = k1 * 4 + k2
    key = torch.where(large, (1 << 40) + D + T_cci, regs)
    order = torch.argsort(key, descending=True, stable=True)
    return LaunchPlan(order.to(torch.int32), regs.to(torch.int32), large, fits)


def rows_per_block(n_rows: int, n_sms: int) -> int:
    """The register form's rows (warps) a block: about one block an SM,
    from 4 to 16 rows. Up to four rows an SM, each warp has a scheduler of
    its own; past that, a block's rows are consecutive in the plan's order,
    so an SM's warps mostly run one instance's code (warps of different
    instances on one SM thrash its instruction cache)."""
    return max(4, min(WARPS_MAX, -(-n_rows // max(n_sms, 1))))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def oracle_dp(
    vpn: torch.Tensor,       # (N, T) float64 hourly VPN cost per row
    cci: torch.Tensor,       # (N, T) float64 hourly CCI cost per row
    D: torch.Tensor,         # (N,) int32 provisioning delay, >= 0
    T_cci: torch.Tensor,     # (N,) int32 minimum commitment, >= 1
    *,
    allow_head_start: bool = True,
    form: str = "auto",      # "register" / "large" force one form (tests, chip_smoke.py)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(total (N,) float64, start_on (N,) bool)`` of every row's offline
    optimum (CUDA). Reads the rows' bounds and form counts back to the host
    once, to size the launches."""
    if vpn.dim() != 2:
        raise ValueError(f"vpn must be (N, T), got {tuple(vpn.shape)}")
    N, T = vpn.shape
    dev = vpn.device
    for a in (vpn, cci, D, T_cci):
        if not a.is_cuda or a.device != dev or not a.is_contiguous():
            raise ValueError("oracle_dp takes contiguous CUDA tensors on one device")
    if cci.shape != (N, T) or vpn.dtype != torch.float64 or cci.dtype != torch.float64:
        raise ValueError(f"vpn and cci must be float64 of one shape, got "
                         f"{tuple(vpn.shape)} {vpn.dtype} and {tuple(cci.shape)} {cci.dtype}")
    if D.shape != (N,) or T_cci.shape != (N,) or D.dtype != torch.int32 \
            or T_cci.dtype != torch.int32:
        raise ValueError(f"D and T_cci must be ({N},) int32")
    plan = launch_plan(D, T_cci, form)
    total = torch.empty(N, dtype=torch.float64, device=dev)
    start_on = torch.empty(N, dtype=torch.bool, device=dev)
    if N == 0:
        return total, start_on
    d_min, tc_min, s_max, n_large, n_fit = torch.stack(
        [D.min().long(), T_cci.min().long(), (D.long() + T_cci).max(),
         plan.large.sum(), plan.fits.sum()]).tolist()
    if d_min < 0 or tc_min < 1:
        raise ValueError(f"oracle_dp needs D >= 0 and T_cci >= 1, got min D {d_min}, "
                         f"min T_cci {tc_min}")
    if form == "register" and n_fit < N:
        raise ValueError(f"{N - n_fit} rows exceed the register form (T_cci past "
                         f"{32 * K1_MAX} or D past {32 * K2_MAX + 1})")
    S_max = s_max + 2
    if n_large and S_max > MAX_STATES:
        raise ValueError(f"a row has {S_max} states; a block holds at most {MAX_STATES}")
    warps = rows_per_block(N - n_large, _sm_count(dev))
    lib = _lib.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.oracle_dp_f64(
            vpn.data_ptr(), cci.data_ptr(), D.data_ptr(), T_cci.data_ptr(),
            plan.order.data_ptr(), plan.regs.data_ptr(), N, T, n_large, S_max, warps,
            int(bool(allow_head_start)), total.data_ptr(), start_on.data_ptr(), stream,
        )
    _lib.check(status, "oracle_dp_f64")
    _lib.LAUNCHES["oracle_dp"] += int(n_large > 0) + int(n_large < N)
    return total, start_on
