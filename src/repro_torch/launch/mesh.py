"""Mesh construction over torch ``DeviceMesh``.

Port of the JAX reference's ``repro/launch/mesh.py``.  Single pod: 256
ranks as (data=16, model=16).  Multi-pod: 512 ranks as (pod=2, data=16,
model=16) -- the pod axis is pure data parallelism; TP/EP stay inside a
pod.  The port runs one rank per card, so the production meshes need a
process group of 256 or 512 ranks (``torch.distributed``); the host
mesh is whatever group there is, (world size, 1), made of one rank when
there is none.  Functions, never module-level meshes: importing this
module touches no process group and no device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or with ``multi_pod`` the
    (2, 16, 16) ``("pod", "data", "model")`` one, over the default
    process group, which must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {need} ranks; there are {have}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(device: str = "cuda"):
    """The default process group's ranks as a (world size, 1) ``("data",
    "model")`` mesh on ``device``.  Without a process group it first
    makes one of world size 1 over an in-process ``HashStore`` (nccl on
    CUDA, gloo on the CPU): no environment variable, no port."""
    device = torch.device(device).type
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the host mesh is on the card and CUDA is not "
                           "available; pass device='cpu' for the host")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if device == "cuda" and not torch.cuda.is_initialized():
        # one rank a card: this rank's, before the mesh picks one
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
