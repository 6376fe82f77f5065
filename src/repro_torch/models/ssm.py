"""The demand forecaster of the fleet's forecast-gated policy, in PyTorch.

Port of the demand-forecaster part of :mod:`repro.models.ssm`: a tiny
diagonal linear SSM over scalar demand series. Its state is a bank of S
exponential moving averages (``h_t = a ⊙ h_{t-1} + (1 − a)·u_t``, ``a =
sigmoid(raw_a)``), read out in deviation-from-persistence form, ``y_t = u_t
+ w·(h_t − u_t) + bias``, in log1p space of the mean-normalised demand. The
init (``w = 0``, ``bias = 0``) is the persistence forecast.

Parameters are a dict ``{"raw_a": (S,), "w": (S,), "bias": ()}`` of float32
tensors, the JAX package's pytree; a trained one comes across with
:func:`repro_torch.models.convert.tree_from_reference`. Every batch form runs
one :func:`repro_torch.kernels.ops.forecaster_scan` (the ``forecaster_scan``
kernel on CUDA, its plain version on the CPU); ``a`` and ``1 − a`` are formed
by ``torch.sigmoid`` on the host, so the card and the CPU scan the same bits.

Not ported yet, each raising ``NotImplementedError``: the forecaster's
training (ROADMAP Queue 1, item 6c) and the LM mixers of the JAX module
(Mamba, mLSTM, sLSTM; item 11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

_TRAINING = ("not ported to repro_torch yet: training the demand forecaster "
             "(train_demand_forecaster, optim/adamw.py and the scan's backward kernel) is "
             "ROADMAP Queue 1, item 6c; run the forecaster with given parameters "
             "(demand_forecaster_predict) and wrap its predictions with "
             "repro_torch.fleet.policy.forecast_gated_policy")
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
    on the host, once, so every device scans the same bits."""
    raw_a = params["raw_a"].detach().to("cpu", torch.float32)
    a = torch.sigmoid(raw_a)
    f32 = lambda t: t.detach().to(device=device, dtype=torch.float32).contiguous()
    return (a.to(device), (1.0 - a).to(device), f32(params["w"]),
            f32(params["bias"]).reshape(()))


def _scan(params: Params, u: torch.Tensor, h0: Optional[torch.Tensor], write_y: bool):
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
    starting at hour ``t+1`` from ``u[:, :t+1]`` only."""
    return _scan(params, u, None, True)[0]


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


def train_demand_forecaster(*args, **kwargs):
    """Not ported yet (ROADMAP Queue 1, item 6c): the forecaster's training."""
    raise NotImplementedError(_TRAINING)


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
