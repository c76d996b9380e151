"""Production and host meshes.

Port of ``repro/launch/mesh.py``.  Functions, not module-level
constants: importing this module touches no device.  The production
meshes are descriptions (``sharding.logical.LogicalMesh`` with no
devices): the dry-run sizes every cell on them, and one process places
nothing on 256 or 512 chips.  Inside a process group the host mesh
spans its ranks (``launch/ranks.py``).
"""
from __future__ import annotations

import torch

from ..sharding.logical import LogicalMesh


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """The reference's pod mesh: 16×16 = 256 chips, ("data", "model");
    2×16×16 = 512 across two pods, ("pod", "data", "model"), the "pod"
    axis carrying only data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return LogicalMesh(axes, shape)


def make_host_mesh(model_parallel: int = 1, devices=None,
                   device=None) -> LogicalMesh:
    """("data", "model") over ``devices`` (default: every visible card;
    ``RuntimeError`` where there is none — a mesh of CPU devices is
    named explicitly), the model degree halved until it divides them.

    Inside an initialized ``torch.distributed`` group (and with no
    ``devices``) the mesh spans the group's processes instead, one card
    each (``launch.ranks``): rank r at data coordinate r // model degree,
    on ``device`` (default: the current card under ``nccl``; ``gloo``
    ranks name theirs)."""
    import torch.distributed as dist
    if devices is None and dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        mp = model_parallel
        while mp > 1 and world % mp:
            mp //= 2
        if device is None:
            if dist.get_backend() != "nccl":
                raise ValueError("a gloo rank names its device")
            device = torch.device("cuda", torch.cuda.current_device())
        return LogicalMesh(("data", "model"), (world // mp, mp),
                           group=dist.group.WORLD, device=device)
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("no CUDA device is available for the host "
                               "mesh; pass devices=[...] explicitly")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    mp = model_parallel
    while mp > 1 and len(devices) % mp:
        mp //= 2
    data = len(devices) // mp
    return LogicalMesh(("data", "model"), (data, mp),
                       tuple(devices[:data * mp]))


__all__ = ["make_production_mesh", "make_host_mesh"]
