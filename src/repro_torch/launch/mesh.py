"""Device meshes: the production shapes and the one-card host mesh.

Functions, not module-level constants, so importing this module starts no
process group.  The shapes are the JAX package's, so that the dry-run
records of the two packages join cell for cell:

* single pod: ``(16, 16)`` over ``("data", "model")``, 256 ranks;
* multi-pod:  ``(2, 16, 16)`` over ``("pod", "data", "model")``, 512 ranks.

On H100s a ``model`` axis of 16 spans two 8-GPU NVLink nodes, so a
collective over it also crosses the nodes' network: a collective time
taken over NVLink's ``link_bw`` (:mod:`repro_torch.analysis.roofline`) is
a lower bound.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
caller's process group (one rank per card;
``torch.distributed.init_process_group`` with an explicit address, world
size and rank).  :func:`make_mesh` builds one of any shape the running
world covers, the counterpart of ``jax.make_mesh``; :func:`make_host_mesh`
is the 1x1 mesh of one process and starts a world-1 group (an in-process
store, no address) when none is running.  The dry run (:mod:`repro_torch.launch.dryrun`) needs none of
this: it reads shapes from an :class:`~repro_torch.models.params.AbstractMesh`.
"""
from __future__ import annotations

import math

import numpy as np
import torch.distributed as dist

__all__ = ["PRODUCTION_SHAPES", "make_mesh", "make_production_mesh", "make_host_mesh",
           "mesh_devices"]

# name -> (axis sizes, axis names)
PRODUCTION_SHAPES = {
    "single": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
}


def mesh_devices(n: int) -> np.ndarray:
    """The first ``n`` ranks of the running process group (a process
    without one is a world of 1); raises when the world is smaller."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"mesh needs {n} ranks, found {world}: start the process group with a "
            "world of at least that size (one rank per card)"
        )
    return np.arange(n)


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the named ``axes`` on the first
    ``prod(shape)`` ranks of the running process group, row-major as
    ``jax.make_mesh`` lays out its devices; raises when the world is
    smaller.  Every rank of the world calls it (a rank beyond the mesh
    holds no coordinate on it)."""
    from torch.distributed.device_mesh import DeviceMesh

    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} vs axes {tuple(axes)}")
    ranks = mesh_devices(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = PRODUCTION_SHAPES["multipod" if multi_pod else "single"]
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """The 1x1 ``("data", "model")`` mesh of this process, on the card
    (``device_type="cpu"``: gloo on the host)."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), device_type)
