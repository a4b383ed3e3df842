"""The collectives of the sharded engines, over one dimension of a
``torch.distributed.device_mesh.DeviceMesh``.

The JAX package's sharded engines run their bodies under ``shard_map`` and
name a mesh axis; here every rank of the mesh dimension calls the engine
with the same global inputs, takes its own contiguous shard
(:func:`shard_padded`) and meets the other ranks only in
:func:`all_gather` and :func:`all_reduce_sum`, on the dimension's group
(:func:`mesh_axis`).  Both take tensors of any shape on any device the
group's backend takes: gloo takes CPU and CUDA tensors for both (a list
``all_gather``, so the output needs no flat layout), NCCL CUDA tensors.
Every rank must make the same calls with tensors of the same shapes, as
the engines do: their shapes follow from the global inputs alone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core.errors import ValidationError


class MeshAxis(NamedTuple):
    """One mesh dimension as this rank sees it."""

    group: object      # the dimension's process group
    size: int          # P, the shard count
    index: int         # this rank's coordinate along the dimension


def mesh_axis(mesh, axis_name: str) -> MeshAxis:
    """The group, size and this rank's index of ``mesh``'s dimension
    ``axis_name``; :class:`ValidationError` for an unknown name or a rank
    that is not in the mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValidationError(f"mesh has no dimension {axis_name!r} "
                              f"(its dimensions: {names})")
    if mesh.get_coordinate() is None:
        raise ValidationError(f"rank {dist.get_rank()} is not in the mesh "
                              f"{mesh.mesh.tolist()}")
    dim = names.index(axis_name)
    return MeshAxis(mesh.get_group(dim), mesh.size(dim),
                    mesh.get_local_rank(dim))


def shard_padded(x: torch.Tensor, size: int, index: int,
                 fill: float) -> torch.Tensor:
    """Shard ``index`` of ``size`` contiguous shards of ``x``'s last axis,
    padded first with ``fill`` to a multiple of ``size`` (contiguous)."""
    pad = (-x.shape[-1]) % size
    if pad:
        x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], dim=-1)
    shard = x.shape[-1] // size
    return x[..., index * shard:(index + 1) * shard].contiguous()


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order: ``(P, *t.shape)``."""
    p = dist.get_world_size(group)
    if t.numel() == 0:        # a backend need not take empty buffers
        return t.new_empty((p,) + tuple(t.shape))
    t = t.contiguous()
    outs = [torch.empty_like(t) for _ in range(p)]
    dist.all_gather(outs, t, group=group)
    return torch.stack(outs)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's ``t`` (a new tensor)."""
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
