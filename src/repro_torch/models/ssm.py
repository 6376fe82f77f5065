"""The demand forecaster of the fleet's forecast-gated policy, in PyTorch.

Port of the demand-forecaster part of :mod:`repro.models.ssm`: a tiny
diagonal linear SSM over scalar demand series. Its state is a bank of S
exponential moving averages (``h_t = a ⊙ h_{t-1} + (1 − a)·u_t``, ``a =
sigmoid(raw_a)``), read out in deviation-from-persistence form, ``y_t = u_t
+ w·(h_t − u_t) + bias``, in log1p space of the mean-normalised demand. The
init (``w = 0``, ``bias = 0``) is the persistence forecast.

Parameters are a dict ``{"raw_a": (S,), "w": (S,), "bias": ()}`` of float32
tensors, the JAX package's pytree; a JAX-trained one comes across with
:func:`repro_torch.models.convert.tree_from_reference`. Every batch form runs
one :func:`repro_torch.kernels.ops.forecaster_scan` (the ``forecaster_scan``
kernel on CUDA, its plain version on the CPU); ``a`` and ``1 − a`` are formed
by ``torch.sigmoid`` on the host, so the card and the CPU scan the same bits.

:func:`train_demand_forecaster` fits the parameters with AdamW
(:mod:`repro_torch.optim`). :func:`demand_forecaster_apply` runs the scan as
a ``torch.autograd.Function`` whose backward is
:func:`repro_torch.kernels.ops.forecaster_scan_bwd` (the
``forecaster_scan_bwd`` kernel on CUDA); autograd carries the gradients of
``a`` and ``1 − a`` back through the host's sigmoid to ``raw_a``. The inputs,
targets and mask are formed once on the host, so a training step on the card
has the bits of the same step on the CPU.

Not ported yet, each raising ``NotImplementedError``: the LM mixers of the
JAX module (Mamba, mLSTM, sLSTM; item 11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_host
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

_MIXERS = "the Mamba, mLSTM and sLSTM mixers are not ported yet (ROADMAP Queue 1, item 11)"


def demand_forecaster_init(key=None, state_dim: int = 8, *, device: DeviceLike = None
                           ) -> Params:
    """The persistence forecast: EMA timescales geometric from 2 to 512 hours
    (``raw_a = logit(exp(−1/τ))``), zero readout. ``key`` is ignored, as in
    the JAX package (the init is deterministic). On ``device`` (CUDA unless
    the caller says otherwise)."""
    del key
    dev = resolve_device(device)
    taus = np.geomspace(2.0, 512.0, state_dim)
    a = np.exp(-1.0 / taus)
    raw_a = (np.log(a) - np.log1p(-a)).astype(np.float32)
    return {
        "raw_a": torch.from_numpy(raw_a).to(dev),
        "w": torch.zeros(state_dim, dtype=torch.float32, device=dev),
        "bias": torch.zeros((), dtype=torch.float32, device=dev),
    }


def _operands(params: Params, device: torch.device):
    """``(a, 1 − a, w, bias)`` on ``device``: the sigmoid and the subtraction
    on the host, once, so every device scans the same bits. Autograd follows
    them back to the parameters that require a gradient."""
    a = torch.sigmoid(params["raw_a"].to("cpu", torch.float32))
    f32 = lambda t: t.to(device=device, dtype=torch.float32).contiguous()
    return (a.to(device), (1.0 - a).to(device), f32(params["w"]),
            f32(params["bias"]).reshape(()))


class _ForecasterScan(torch.autograd.Function):
    """``y`` of the forecaster's scan from zeros, differentiable in ``a``,
    ``1 − a``, ``w`` and ``bias``: forward one ``ops.forecaster_scan``, which
    also stores the chain's state at every tile's start, backward one
    ``ops.forecaster_scan_bwd`` from those checkpoints. The graph takes ``a``
    and ``1 − a`` as two operands, as the reference's does, and autograd adds
    their gradients at the host's ``1 − a``. No gradient with respect to
    ``u``: training needs none, and the kernel forms none."""

    @staticmethod
    def forward(ctx, u, a, one_minus_a, w, bias):
        if ctx.needs_input_grad[0]:
            raise ValueError("the forecaster's scan has no gradient with respect to u; "
                             "detach the input")
        ckpt = ops.forecaster_checkpoints(u, a.shape[0])
        y, _ = ops.forecaster_scan(u, a, one_minus_a, w, bias, ckpt=ckpt)
        ctx.save_for_backward(u, a, one_minus_a, w, ckpt)
        return y

    @staticmethod
    def backward(ctx, dy):
        u, a, one_minus_a, w, ckpt = ctx.saved_tensors
        da, doma, dw, dbias = ops.forecaster_scan_bwd(u, dy.contiguous(), a, one_minus_a, w,
                                                      ckpt=ckpt)
        return None, da, doma, dw, dbias


@torch.no_grad()
def _scan(params: Params, u: torch.Tensor, h0: Optional[torch.Tensor], write_y: bool):
    """The scan that also hands back its last state, ``(y, h)`` (a tick, the
    warm-up, the state alone): not differentiable."""
    u = torch.as_tensor(u)
    a, oma, w, bias = _operands(params, u.device)
    return ops.forecaster_scan(u.to(torch.float32), a, oma, w, bias, h0, write_y=write_y)


def demand_forecaster_step(params: Params, h: torch.Tensor, u_t: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent tick: ``h`` (N, S) the state after ``u_{<t}``, ``u_t``
    (N,) the hour's log1p-normalised demand. Returns ``(h', y_t)``, exactly
    one column of :func:`demand_forecaster_apply` (the same scan with T = 1)."""
    y, h = _scan(params, torch.as_tensor(u_t)[:, None], h.to(torch.float32), True)
    return h, y[:, 0]


def demand_forecaster_state(params: Params, u: torch.Tensor) -> torch.Tensor:
    """Warm-up: the (N, S) state after consuming all of ``u`` (N, T), from
    zeros (the scan without its readout)."""
    return _scan(params, u, None, False)[1]


def demand_forecaster_apply(params: Params, u: torch.Tensor) -> torch.Tensor:
    """``u`` (N, T) log1p of mean-normalised demand → ``y`` (N, T) float32,
    ``y[:, t]`` estimating log1p of the mean normalised demand over the window
    starting at hour ``t+1`` from ``u[:, :t+1]`` only. One
    :class:`_ForecasterScan`, so differentiable in the parameters that
    require a gradient."""
    u = torch.as_tensor(u)
    return _ForecasterScan.apply(u.to(torch.float32).contiguous(), *_operands(params, u.device))


def demand_forecaster_predict(params: Params, series, scale, *,
                              device: DeviceLike = None) -> torch.Tensor:
    """Forward-window mean-demand forecasts in original units, on ``device``
    (CUDA unless the caller says otherwise).

    ``series`` (N, T) raw demand and ``scale`` (N,) the normalisers, numpy or
    tensors. ``u = log1p(float32(series / scale))`` (the quotient in
    float64), then :func:`demand_forecaster_apply`; returns the (N, T)
    float64 tensor ``max(expm1(y), 0)·scale``, column t the predicted mean
    over the window starting at hour t+1 (causal). A NaN hour keeps its row
    NaN from there on, as in the JAX package.
    """
    dev = resolve_device(device)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64).to(dev)
    scale = f64(scale)[:, None]
    u = torch.log1p((f64(series) / scale).to(torch.float32))
    y = demand_forecaster_apply(params, u).to(torch.float64)
    return torch.maximum(torch.expm1(y), torch.zeros((), dtype=torch.float64, device=dev)) * scale


def demand_forecaster_warmup(params: Params, series, scale, *,
                             device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The live forecaster's start after ``series`` (N, H) raw demand with
    ``scale`` (N,): ``(h (N, S) float32, pred (N,) float64)``, the state
    after the last hour and the forecast made after it. One scan (one
    ``forecaster_scan`` launch on CUDA), with ``u`` formed as
    :func:`demand_forecaster_predict` forms it, so ``h`` is
    :func:`demand_forecaster_state`'s and ``pred`` the last column of
    :func:`demand_forecaster_predict` over the same series, bit for bit."""
    dev = resolve_device(device)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64).to(dev)
    scale = f64(scale)
    u = torch.log1p((f64(series) / scale[:, None]).to(torch.float32))
    y, h = _scan(params, u, None, True)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    return h, torch.maximum(torch.expm1(y[:, -1].to(torch.float64)), zero) * scale


def _training_inputs(s: np.ndarray, window: int):
    """``(scale, u, target, dy_weight)`` of
    :func:`train_demand_forecaster`, formed once on the host (float32 from
    the float64 quotient, as the JAX package forms them): ``u = log1p(s /
    scale)``; the target at hour t is log1p of the mean normalised demand
    over hours t+1 .. t+W, from a sequential float32 prefix sum; ``dy_weight
    = mask · float32(1 / denom)`` with ``mask`` 1 where the window lies
    inside the horizon and ``denom = max(Σ mask, 1)·N``."""
    scale = np.maximum(s.mean(axis=1), 1e-9)
    u_lin = (s / scale[:, None]).astype(np.float32)
    N, H = u_lin.shape
    W = int(max(1, min(window, H - 1)))
    csum = np.zeros((N, H + 1), np.float32)
    np.cumsum(u_lin, axis=1, dtype=np.float32, out=csum[:, 1:])   # in order, float32
    t = np.arange(H)
    hi = np.minimum(t + 1 + W, H)
    target = torch.log1p(torch.from_numpy((csum[:, hi] - csum[:, t + 1]) / np.float32(W)))
    mask = (t + 1 + W <= H).astype(np.float32)
    denom = np.float32(max(float(mask.sum()), 1.0) * N)
    dy_weight = torch.from_numpy(np.broadcast_to(mask * (np.float32(1.0) / denom), (N, H)).copy())
    return scale, torch.log1p(torch.from_numpy(u_lin)), target, dy_weight


def _loss_and_grads(params: Params, u: torch.Tensor, target: torch.Tensor,
                    dy_weight: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """One training step's loss and gradients (:func:`_training_inputs`'
    operands on the parameters' device): the scan forward, the loss's
    gradient ``((y − target)·2)·dy_weight`` elementwise, the scan backward
    and autograd through the host's sigmoid. The loss is ``Σ (y −
    target)²·dy_weight``, for reporting only."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    y = demand_forecaster_apply(p, u)
    diff = y.detach() - target
    grads = torch.autograd.grad(y, list(p.values()), (diff * 2.0) * dy_weight)
    return (diff * diff * dy_weight).sum(), dict(zip(p, grads))


def train_demand_forecaster(
    series,
    window: int,
    *,
    state_dim: int = 8,
    steps: int = 300,
    lr: float = 2e-2,
    seed: int = 0,
    device: DeviceLike = None,
    losses: Optional[list] = None,
) -> Tuple[Params, np.ndarray]:
    """Fit the forecaster on (N, H) non-negative demand history (numpy or a
    tensor), on ``device`` (CUDA unless the caller says otherwise).

    :func:`repro.models.ssm.train_demand_forecaster`: one model shared across
    the N series, each normalised by its own mean (``scale``, numpy
    float64); inputs and targets in log1p space, the target at hour t the
    mean normalised demand over the next ``W = max(1, min(window, H − 1))``
    hours, masked where the window runs off the horizon; the loss
    ``Σ (y − target)²·mask / (max(Σ mask, 1)·N)``; ``steps`` AdamW steps
    (``weight_decay=0``, ``clip_norm=1``) from the persistence init. Each
    step is one forward scan, one backward scan and the update. ``seed`` is
    unused, as in the JAX package (the init is deterministic). A NaN hour
    makes the loss and, after one step, the parameters NaN, as there.

    The loss's gradient with respect to ``y`` is formed as ``((y − target)
    · 2)·(mask / denom)``, elementwise; with every input formed on the host
    and every reduction in a fixed order, the card trains to the CPU's bits.
    ``losses``, when given a list, receives each step's loss before its
    update, as ``Σ (y − target)²·(mask / denom)`` (a 0-dim tensor on
    ``device``). Returns ``(params, scale)``.
    """
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    del seed
    dev = resolve_device(device)
    s = to_host(series, np.float64)
    if s.ndim != 2 or s.shape[1] < 2:
        raise ValueError(f"train_demand_forecaster needs (N, H >= 2) series, got {s.shape}")
    scale, u, target, dy_weight = _training_inputs(s, window)
    u, target, dy_weight = (x.to(dev) for x in (u, target, dy_weight))
    params = demand_forecaster_init(None, state_dim, device=dev)
    cfg = AdamWConfig(lr=lr, weight_decay=0.0, clip_norm=1.0)
    opt = adamw_init(params, cfg)
    for _ in range(steps):
        loss, grads = _loss_and_grads(params, u, target, dy_weight)
        if losses is not None:
            losses.append(loss)
        params, opt, _ = adamw_update(params, grads, opt, cfg)
    return params, scale


def _mixer(name: str):
    def not_ported(*args, **kwargs):
        raise NotImplementedError(f"{name}: {_MIXERS}")

    not_ported.__name__ = name
    not_ported.__doc__ = f"Not ported yet (ROADMAP Queue 1, item 11): ``{name}``."
    return not_ported


mamba_init = _mixer("mamba_init")
mamba_cache_init = _mixer("mamba_cache_init")
mamba_apply = _mixer("mamba_apply")
mamba_decode = _mixer("mamba_decode")
mlstm_init = _mixer("mlstm_init")
mlstm_cache_init = _mixer("mlstm_cache_init")
mlstm_apply = _mixer("mlstm_apply")
mlstm_decode = _mixer("mlstm_decode")
slstm_init = _mixer("slstm_init")
slstm_cache_init = _mixer("slstm_cache_init")
slstm_apply = _mixer("slstm_apply")
slstm_decode = _mixer("slstm_decode")
