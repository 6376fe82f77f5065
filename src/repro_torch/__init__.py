"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The subpackages mirror :mod:`repro` (``core``, ``traffic``, ``kernels``,
``fleet``, ``models``, ``dist``, ``launch``) and keep its function names, so each function has an obvious
counterpart there. Inside, the port is plain PyTorch: functions on
tensors, NamedTuples of tensors or nested dicts and lists
(:mod:`repro_torch.tree`) where the JAX package used pytrees, an explicit
``device``, and ``torch.distributed`` process groups for the mesh. The
kernels of the hot paths are CUDA C++ sources under ``csrc/``, built on
first use (see :mod:`repro_torch.kernels`).

Entry points run on ``torch.device("cuda")`` unless the caller passes
``device="cpu"`` (:func:`resolve_device`); without a device on a host with
no CUDA they raise rather than carry on on the CPU.

This package imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``. Modules of ``repro`` that are numpy-only are copied here.
"""
from .device import resolve_device  # noqa: F401
