"""Mesh construction over the ranks of ``torch.distributed``.

The JAX package builds meshes of devices; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of ranks, with the same
shapes and dimension names.  Every builder needs an initialised default
process group (the caller's ``init_process_group``: this package starts
no processes) and must be called by every rank of it, since each mesh
dimension gets a group of its own.  ``device`` is the mesh's device type:
the card by default, ``"cpu"`` for gloo worlds of CPU tensors.

The single-pod production mesh is 16 × 16 = 256 ranks (data × model);
the multi-pod mesh adds a leading "pod" dimension (2 pods = 512 ranks).
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.errors import ValidationError


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValidationError("no initialised process group: call "
                              "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh(ranks: Sequence[int], shape: tuple, names: tuple,
          device: str) -> DeviceMesh:
    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device, grid, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """(16, 16) as ("data", "model"), or (2, 16, 16) with "pod" first;
    :class:`ValidationError` in a world of any other size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, world = math.prod(shape), _world()
    if world != need:
        raise ValidationError(f"the {'multi-pod' if multi_pod else 'single-pod'}"
                              f" production mesh needs {need} ranks; the "
                              f"world has {world}")
    return _mesh(range(need), shape, names, device)


def make_elastic_mesh(devices: Optional[Sequence[int]] = None, *,
                      model_parallel: int = 1,
                      device: str = "cuda") -> DeviceMesh:
    """("data", "model") mesh over ``devices`` (ranks; default every rank
    of the world), the data dimension absorbing every rank not used by
    model parallelism, so a checkpoint written on N ranks restores onto M
    with only the data sharding re-derived.  A rank count not divisible by
    ``model_parallel`` raises :class:`ValidationError` (a ``ValueError``,
    as in the JAX package)."""
    world = _world()
    ranks = list(range(world) if devices is None else devices)
    if sorted(set(ranks)) != sorted(ranks) \
            or not all(0 <= r < world for r in ranks):
        raise ValidationError(f"devices must be distinct ranks below the "
                              f"world size {world}, got {ranks}")
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValidationError(f"{n} devices not divisible by "
                              f"model_parallel={model_parallel}")
    return _mesh(ranks, (n // model_parallel, model_parallel),
                 ("data", "model"), device)


def make_host_mesh(num: Optional[int] = None, axis: str = "data", *,
                   device: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``num`` ranks (default all), dimension
    ``axis``: the JAX package's mesh over its first ``num`` devices.  Every
    rank of the world calls it; with ``num`` below the world size the ranks
    from ``num`` on hold a mesh they are not in, and the sharded engines
    raise :class:`ValidationError` there.  ``num`` < 1 raises too."""
    world = _world()
    count = world if num is None else min(num, world)
    if count < 1:
        raise ValidationError(f"a mesh needs at least one rank, got num={num}")
    return _mesh(range(count), (count,), (axis,), device)


def init_distributed(device: str = "cuda") -> None:
    """Join the world of the ``torchrun`` environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``env://``): NCCL
    on the card (each rank on its ``LOCAL_RANK``'s card), gloo on the CPU.
    A process group the caller initialised already is kept as it is."""
    if dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def world_mesh(model_parallel: int, device: str = "cuda"):
    """The launchers' mesh: :func:`make_elastic_mesh` over every rank when
    the world holds more than one (as the JAX launchers build one only on
    more than one device), else None."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return None
    return make_elastic_mesh(model_parallel=model_parallel,
                             device=torch.device(device).type)
