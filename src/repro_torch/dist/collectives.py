"""Gradient synchronization modes over the (pod, data, model) mesh.

Port of :mod:`repro.dist.collectives` on ``torch.distributed``.
``sync_grads`` is the cross-pod actuator the interconnect planners drive
(:class:`repro_torch.core.planner.InterconnectPlanner` for one link,
:class:`repro_torch.fleet.runtime.ElasticFleetPlanner` for a fleet — each
link's FSM mode selects this module's path per tick):

* ``direct``        one mean over every data-parallel axis;
* ``hierarchical``  mean within each pod, then across pods — the
                    full-precision mode used when the leased link is ON;
* ``compressed``    intra-pod mean in full precision, then per-row int8 with
                    error feedback for the pod hop only — about 4x fewer
                    wire (billed) bytes on the pay-per-GB path.

The mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` (see
:mod:`repro_torch.launch.mesh`). A mean over axes is JAX's ``pmean``: one
``all_reduce(SUM)`` over a group that spans all of them (``mesh.get_group``
for one axis, the flattened sub-mesh's group for ``("pod", "data")``), then
a true division by the number of ranks, held as a tensor on the gradient's
device (PyTorch's CUDA ``div`` by a Python number multiplies by its
reciprocal, which rounds differently). The pod hop gathers the int8 rows
(``all_gather`` of int8) and their float32 scales and averages them as
``jnp.mean`` does: the sum over the pod index in order, times ``1/pods``
as a float32. For replicated gradients, the only ones the JAX sync takes,
every output equals the JAX sync bit for bit on gloo meshes of 1 to 6
ranks, 3, 5 and 6 among them (``tests/test_torch_actuation.py``); for
gradients that differ per rank the order of the all-reduce is gloo's or
NCCL's, not XLA's. The
quantize and dequantize steps are the port's kernels
(:func:`repro_torch.kernels.ops.int8_quantize` /
:func:`~repro_torch.kernels.ops.int8_dequantize`): per leaf, one quantize
and two dequantize launches (the residual, and the gathered stack in one
launch). :func:`sync_wire_bytes` prices a sync's cross-pod bytes under each
mode — the demand the planners feed back into the next hour's toggle
decision.

The quantize kernel runs with ``guard="collectives"``: its scale is
``repro.dist.collectives._quantize``'s ``max(amax / 127, 1e-30)``, not the
Pallas kernel's ``max(amax, 1e-30) / 127``, so the compressed sync equals
the JAX one bit for bit on every row, tiny ones included.

Pytrees are dicts, lists and tuples of tensors (:mod:`repro_torch.tree`);
the tensors stay on their device (CUDA tensors with an NCCL group, CPU
tensors with gloo). Each sync domain of :func:`fleet_sync_grads` runs
inside ``torch.profiler.record_function(sync_domain_label(...))``, so the
label shows in a profiler trace. The HLO telemetry that parses the label
in the JAX package is ROADMAP Queue 1, item 12.
"""
from __future__ import annotations

import math
import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.launch.mesh import dp_axes
from repro_torch.tree import tree_leaves, tree_map

INT8_MAX = 127.0
MODES = ("direct", "hierarchical", "compressed")
# Gather into one flat tensor: ``all_gather_single`` from torch 2.13 on,
# ``all_gather_into_tensor`` (the same collective) before it.
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def init_error_state(grads, mesh=None):
    """Zero error-feedback residuals (one float32 tensor per gradient leaf)."""
    del mesh
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


class _Reducer:
    """The groups and divisors of one ``sync_grads`` call, looked up once
    per call and not once per leaf."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._groups: dict = {}
        self._consts: dict = {}

    def group(self, axes: tuple):
        """One group over every axis in ``axes`` (for several, a flattened
        sub-mesh, which the mesh caches): an all-reduce per axis would add
        partial sums, not the ranks' values in one sum."""
        if axes not in self._groups:
            self._groups[axes] = (self.mesh.get_group(axes[0]) if len(axes) == 1
                                  else self.mesh[axes]._flatten().get_group())
        return self._groups[axes]

    def const(self, value, like: torch.Tensor) -> torch.Tensor:
        """``value`` as a 0-d tensor of ``like``'s type on its device: PyTorch's
        CUDA ``div`` by a Python number multiplies by its reciprocal."""
        key = (value, like.dtype, like.device)
        if key not in self._consts:
            self._consts[key] = torch.full((), value, dtype=like.dtype, device=like.device)
        return self._consts[key]

    def pmean(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``jax.lax.pmean(x, axes)``: a new tensor, the sum over all of
        ``axes`` in one all-reduce, divided by the number of ranks summed."""
        group = self.group(tuple(axes))
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out / self.const(float(dist.get_world_size(group)), out)


def _quantize(v: torch.Tensor):
    """Per-row symmetric int8 over the last dim with the JAX collectives'
    scale guard, through the quantize kernel on a ``(-1, last)`` view:
    ``(q, scale)`` shaped ``v.shape`` and ``(*v.shape[:-1], 1)``."""
    q, scale = ops.int8_quantize(v.reshape(-1, v.shape[-1]), guard="collectives")
    return q.view(v.shape), scale.view(*v.shape[:-1], 1)


def _sync_leaf(g: torch.Tensor, err: Optional[torch.Tensor], red: _Reducer, *, mode: str,
               dp: tuple, has_pod: bool):
    intra = tuple(a for a in dp if a != "pod")
    if mode == "direct":
        return (red.pmean(g, dp) if dp else g), None
    if mode == "hierarchical":
        out = red.pmean(g, intra) if intra else g
        if has_pod:
            out = red.pmean(out, ("pod",))
        return out, None
    # compressed: full precision inside the pod, int8 + error feedback across.
    out = red.pmean(g, intra) if intra else g
    if not has_pod:
        return out, (torch.zeros_like(out) if err is not None else None)
    u = out + err if err is not None else out
    q, scale = _quantize(u)
    last = u.shape[-1]
    deq = ops.int8_dequantize(q.view(-1, last), scale.view(-1, 1)).view(u.shape)
    new_err = u - deq
    group = red.group(("pod",))
    pods = dist.get_world_size(group)
    rows = q.numel() // last
    qs = torch.empty((pods * rows, last), dtype=torch.int8, device=q.device)
    ss = torch.empty((pods * rows, 1), dtype=torch.float32, device=q.device)
    _all_gather_flat(qs, q.reshape(rows, last), group=group)      # int8 on the wire
    _all_gather_flat(ss, scale.reshape(rows, 1), group=group)    # f32 sidecar
    stack = ops.int8_dequantize(qs, ss).view(pods, *u.shape)
    total = stack[0]
    for i in range(1, pods):                   # jnp.mean: in order, then times 1/n
        total = total + stack[i]
    inv = red.const(float(np.float32(1) / np.float32(pods)), total)
    return (total * inv).to(g.dtype), new_err


def sync_grads(grads, mesh, *, mode: str = "direct", err_state=None):
    """Average a gradient pytree over the mesh's data-parallel axes.

    Returns ``(synced_grads, err_state)``; ``err_state`` is the updated
    error-feedback residual pytree for ``mode='compressed'`` (else
    ``None``). Every rank passes its own gradients; the inputs are not
    modified.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dp = dp_axes(mesh)
    has_pod = "pod" in (mesh.mesh_dim_names or ())
    use_err = mode == "compressed"
    if err_state is None and use_err:
        err_state = init_error_state(grads, mesh)
    err_in = err_state if use_err else tree_map(lambda g: None, grads)
    red = _Reducer(mesh)
    pairs = []

    def leaf(g, e):
        pairs.append(_sync_leaf(g, e, red, mode=mode, dp=dp, has_pod=has_pod))
        return len(pairs) - 1

    index = tree_map(leaf, grads, err_in)
    outs = tree_map(lambda i: pairs[i][0], index)
    errs = tree_map(lambda i: pairs[i][1], index)
    return outs, (errs if use_err else None)


def sync_wire_bytes(grads, mode: str) -> int:
    """Cross-pod wire (billed) bytes of ONE ``sync_grads`` call under ``mode``.

    ``hierarchical``/``direct`` move every leaf at its own precision;
    ``compressed`` moves the int8 payload plus one float32 scale per
    quantization row (last-dim rows) — the ~4x shrink that makes the
    pay-per-GB path cheap (cf. ``COMPRESS_RATIO`` in
    :mod:`repro_torch.core.planner`). Leaves are tensors (or anything with
    ``shape`` and a torch ``dtype``).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    total = 0
    for g in tree_leaves(grads):
        shape = tuple(g.shape)
        n = int(math.prod(shape)) if shape else 1
        if mode == "compressed":
            rows = n // (shape[-1] if shape else 1)
            total += n + max(rows, 1) * 4        # int8 payload + f32 scales
        else:
            total += n * torch.empty((), dtype=g.dtype).element_size()
    return total


def sync_domain_label(gid, mode: str, *, tenant=None) -> str:
    """The profiler label of one leased sync domain:
    ``syncdom_g{gid}_{mode}``, or ``syncdom_t.<tenant>.g{gid}_{mode}`` with
    a tenant, whose name is sanitized to ``[\\w.-]`` (anything else becomes
    ``-``) so the label stays a single token, as in the JAX package."""
    t = ""
    if tenant is not None:
        t = "t." + re.sub(r"[^\w.-]", "-", str(tenant)) + "."
    return f"syncdom_{t}g{gid}_{mode}"


def fleet_sync_grads(grads_per_link, mesh, modes, err_states=None, *, groups=None,
                     tenant=None):
    """Actuate a fleet plan: job ``i``'s gradients sync under ``modes[i]``.

    The bridge between :class:`repro_torch.fleet.runtime.ElasticFleetPlanner`
    and the collective layer: each training job (one per interconnect link)
    syncs hierarchically at full precision while its leased link is ON, and
    int8-compressed over the pay-per-GB path otherwise. Returns ``(synced,
    err_states, billed_bytes)`` lists; feed ``billed_bytes`` (× steps per
    hour) back as the planner's next-hour demand to close the endogenous
    loop.

    ``groups`` (optional, one hashable id per job, e.g.
    ``ElasticFleetPlanner.sync_groups()``) declares leased sync domains:
    jobs sharing a group id and mode sync in ONE ``sync_grads`` call (their
    pytrees batched into a list). Results equal the ungrouped path (the
    average is per leaf), and wire bytes stay metered per job. A domain may
    mix carried and fresh residuals after a re-grouping: fresh jobs start
    from zero. Each domain runs under a profiler range named
    :func:`sync_domain_label`.
    """
    n = len(grads_per_link)
    if len(modes) != n:
        raise ValueError(f"{n} jobs but {len(modes)} modes")
    err_states = err_states or [None] * n
    if groups is None:
        domains = [(i,) for i in range(n)]
    else:
        if len(groups) != n:
            raise ValueError(f"{n} jobs but {len(groups)} groups")
        by_key: dict = {}
        for i, (g, m) in enumerate(zip(groups, modes)):
            by_key.setdefault((g, m), []).append(i)
        domains = [tuple(v) for v in by_key.values()]
    synced, errs, billed = [None] * n, [None] * n, [None] * n
    for idx in domains:
        mode = modes[idx[0]]
        dom_errs = [err_states[i] for i in idx]
        if all(e is None for e in dom_errs):
            dom_errs = None
        else:
            dom_errs = [e if e is not None else init_error_state(grads_per_link[i], mesh)
                        for e, i in zip(dom_errs, idx)]
        gid = groups[idx[0]] if groups is not None else idx[0]
        with torch.profiler.record_function(sync_domain_label(gid, mode, tenant=tenant)):
            out, new_err = sync_grads([grads_per_link[i] for i in idx], mesh, mode=mode,
                                      err_state=dom_errs)
        for k, i in enumerate(idx):
            synced[i] = out[k]
            errs[i] = new_err[k] if new_err is not None else None
            billed[i] = sync_wire_bytes(grads_per_link[i], mode)
    return synced, errs, billed
