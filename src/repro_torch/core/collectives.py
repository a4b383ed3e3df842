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

:func:`record_traffic` counts the bytes of every collective called
through this module and :mod:`repro_torch.parallel.collectives` (the dry
run's collective record).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple

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


_RECORDS: List[Dict[str, Dict[str, float]]] = []


@contextlib.contextmanager
def record_traffic():
    """Yield ``{kind: {"count", "operand_bytes", "wire_bytes"}}``, filled
    while the block runs with each collective this rank calls through the
    port's wrappers (kind ``"all-reduce"``, ``"all-gather"`` or
    ``"reduce-scatter"``, the last the backward of the FSDP gather).
    ``operand_bytes`` is this rank's input; ``wire_bytes`` the ring
    algorithm's traffic a rank, 2(g−1)/g of the buffer for an all-reduce
    and (g−1)/g of the gathered result for an all-gather, g the group's
    size (the JAX dry run's convention).  The port runs a reduce-scatter
    as an all-reduce of the whole gradient and a narrow, so its wire
    bytes are an all-reduce's (twice a ring reduce-scatter's)."""
    record: Dict[str, Dict[str, float]] = {}
    _RECORDS.append(record)
    try:
        yield record
    finally:
        _RECORDS.remove(record)


def note_collective(kind: str, t: torch.Tensor, group) -> None:
    """Add one collective of ``t`` (this rank's input) over ``group`` to
    every open :func:`record_traffic`."""
    if not _RECORDS:
        return
    g = dist.get_world_size(group)
    nbytes = float(t.numel() * t.element_size())
    full = nbytes * g if kind == "all-gather" else nbytes
    wire = (1.0 if kind == "all-gather" else 2.0) * (g - 1) / g * full
    for record in _RECORDS:
        row = record.setdefault(kind, {"count": 0.0, "operand_bytes": 0.0,
                                       "wire_bytes": 0.0})
        row["count"] += 1
        row["operand_bytes"] += nbytes
        row["wire_bytes"] += wire


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
    note_collective("all-gather", t, group)
    dist.all_gather(outs, t, group=group)
    return torch.stack(outs)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of every rank's ``t`` (a new tensor)."""
    out = t.clone()
    note_collective("all-reduce", out, group)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
