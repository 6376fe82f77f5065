"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Per-kernel contract (the three layers of :mod:`repro.kernels`):
  ../csrc/<name>.cu  the CUDA C++ kernel for sm_90a, with a plain C entry
  <name>.py          its wrapper: checks, allocates, launches, counts
  ref.py             the plain PyTorch version of every kernel
  ops.py             the dispatcher: CUDA tensors to the kernel, CPU tensors
                     to the plain version

Kernels: ``tiered_cost_batched`` (the paper's Eq. 2 pricing over an (N, T)
plane; replaces the Pallas kernel of the same name) and ``fsm_scan`` (the
ToggleCCI scan over rows; replaces ``lax.scan`` in ``policy_scan``).
"""
from . import ops, ref  # noqa: F401
