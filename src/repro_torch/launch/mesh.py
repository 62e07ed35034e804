"""Production meshes of the dry-run (port of ``repro.launch.mesh``), for
a cluster of NVIDIA H100 SXM GPUs.  Importing this module makes no
process group.

Topology: 32 nodes of 8 GPUs, (data 32, model 8) = 256 GPUs, so that the
"model" axis stays inside one node's NVLink domain and "data" spans the
nodes; multi-pod is two such clusters, (pod 2, data 32, model 8) = 512.
The production mesh is a named ``DeviceMesh`` over a fake process group
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once and moves nothing), which the dry-run traces under
``FakeTensorMode``; the abstract mesh is ``dist.mesh.AbstractMesh`` (the
specs need only shape and names); the host mesh is the local
``torch.distributed`` world (``dist.mesh.world_mesh``; a world that
``torchrun`` started is joined by ``make_host_mesh``), a world of one
when there is none.

Roofline constants, per GPU, from NVIDIA's H100 SXM data sheet (dense,
no sparsity, at the 700 W limit): 989e12 FLOP/s in bf16 on the tensor
cores and 3.35e12 B/s of HBM3.  One collective rate, as the reference
keeps one (``ICI_BW_PER_LINK``): 50e9 B/s per GPU, one 400 Gb/s NDR
InfiniBand port, the rate between nodes.  NVLink inside a node moves 900
GB/s per GPU (both directions together), so this one rate overstates
every collective on the "model" axis, which stays inside a node;
splitting the collective term by axis is later work (ROADMAP).
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.dist.mesh import (AbstractMesh, abstract_mesh, init_mesh,
                                   world_mesh)

_worlds = 0                  # fake worlds this process has made
PEAK_FLOPS_BF16 = 989e12     # FLOP/s, H100 SXM dense bf16
HBM_BW = 3.35e12             # B/s, H100 SXM HBM3
COLL_BW_PER_GPU = 50e9       # B/s, one 400 Gb/s NDR port per GPU


def production_topology(*, multi_pod: bool = False):
    """(shape, axis_names) of the production mesh — the single source of
    truth for both the device mesh and its abstract twin."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def init_fake_world(world: int) -> None:
    """This process's default process group: a fake one of ``world``
    ranks, this process rank 0.  A process holds one default group, so a
    fake world of another size replaces a fake world (never a real one,
    which raises)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "fake production world needs a process of "
                               "its own")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    global _worlds
    _worlds += 1


_meshes: dict = {}


def make_mesh(shape, names, device_type: str = "cuda"):
    """A named ``DeviceMesh`` of ``shape`` over a fake world of
    prod(shape) ranks (made or replaced here; the mesh is made once per
    world)."""
    from torch.distributed.device_mesh import init_device_mesh
    init_fake_world(math.prod(shape))
    key = (tuple(shape), tuple(names), device_type)
    world = _worlds
    if _meshes.get(key, (None,))[0] != world:
        _meshes[key] = (world, init_device_mesh(
            device_type, tuple(shape), mesh_dim_names=tuple(names)))
    return _meshes[key][1]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh over a fake world of 256 (512) ranks."""
    shape, axes = production_topology(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type)


def make_abstract_production_mesh(*, multi_pod: bool = False
                                  ) -> AbstractMesh:
    """Shape and names of the production mesh, with no process group —
    for the specs (``dist.sharding``)."""
    shape, axes = production_topology(multi_pod=multi_pod)
    return abstract_mesh(shape, axes)


def make_host_mesh(device_type: str | None = None):
    """The local world on one "data" dim, its DTensors on ``device_type``
    (default the card where there is one): every rank of an initialized
    process group; in a process that ``torchrun`` started (``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR`` set), every rank of that world,
    joined here through ``env://`` (NCCL where each local rank has a card
    of its own, else gloo: ranks sharing a card, or the host); else a
    world of one (an AbstractMesh)."""
    env = os.environ
    if not dist.is_initialized() and all(
            k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        on_card = (device_type or ("cuda" if torch.cuda.is_available()
                                   else "cpu")) == "cuda"
        local = int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"]))
        own = on_card and torch.cuda.device_count() >= local
        return init_mesh((int(env["WORLD_SIZE"]),), ("data",),
                         backend="nccl" if own else "gloo",
                         init_method="env://", rank=int(env["RANK"]),
                         device_type=device_type)
    return world_mesh("data", device_type)
