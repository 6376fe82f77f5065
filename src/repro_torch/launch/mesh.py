"""Meshes of the port on ``torch.distributed``.

Port of :func:`repro.launch.mesh.make_host_mesh` and :func:`dp_axes`. A
mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group: with a pod axis, ``("pod", "data",
"model")``; without one, ``("data", "model")``, as the JAX package names
them. The gradient sync (:mod:`repro_torch.dist.collectives`) reduces over
the ``"pod"`` and ``"data"`` axes through ``mesh.get_group(axis)``.

A caller that needs a pod axis of one rank (one card) builds it directly,
``init_device_mesh(dev, (1, 1, 1), mesh_dim_names=("pod", "data",
"model"))``, as ``jax.make_mesh((1, 1, 1), ...)`` does in the JAX package.

The production meshes (``make_production_mesh``) are ROADMAP Queue 1,
item 12.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device

#: The data-parallel axes a gradient sync averages over, in reduction order.
DP_AXES = ("pod", "data")


def make_host_mesh(*, data: int = 2, model: int = 2, pod: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """A ``(pod, data, model)`` mesh when ``pod > 1``, else ``(data, model)``,
    over the default process group on ``device`` (``None``: the card, with
    NCCL; ``"cpu"``: gloo).

    The world size must equal the mesh size. With no process group yet and
    a mesh of one rank, this creates the default group itself (world 1, an
    in-memory store: no file, no port) and leaves it to the caller to
    destroy; a larger mesh needs the caller's ``init_process_group``.
    """
    shape, names = (((pod, data, model), ("pod", "data", "model")) if pod > 1
                    else ((data, model), ("data", "model")))
    dev = resolve_device(device)
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(f"a mesh of {size} ranks needs a process group: call "
                               "torch.distributed.init_process_group first")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world != size:
        raise ValueError(f"mesh {dict(zip(names, shape))} has {size} ranks, the world {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def dp_axes(mesh: DeviceMesh) -> tuple:
    """The mesh's data-parallel axes: ``("pod", "data")`` where present."""
    return tuple(a for a in DP_AXES if a in (mesh.mesh_dim_names or ()))
