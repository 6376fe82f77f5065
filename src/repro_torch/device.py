"""Device resolution and the copy to the host, shared by the port's entry
points."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: ``cuda`` when PyTorch sees a card, else a
    ``RuntimeError`` (the port never carries on on the CPU unasked). Pass
    ``"cpu"`` explicitly to run the plain PyTorch versions of the kernels.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_host(x, dtype=None) -> np.ndarray:
    """A tensor (on any device), an array or a nested sequence as a numpy
    array on the host, of ``dtype`` when given (one copy off the card)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)
