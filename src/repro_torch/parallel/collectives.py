"""The collectives of model-side parallelism, as autograd functions.

A tensor that every rank of a group holds whole (replicated) carries the
same full gradient on every rank.  Two operators keep that true where a
layer cuts its work over the group (Megatron's f and g):

* :func:`copy_to` — identity forward, all-reduce backward: at the input of
  a column-parallel product (a replicated tensor used for a rank's own
  block of the work; each rank's gradient is a partial sum).
* :func:`reduce_from` — all-reduce forward, identity backward: at the
  output of a row-parallel product (partial sums that become replicated).
  ``torch.distributed.nn.functional.all_reduce`` all-reduces the gradient
  as well, which on a replicated output multiplies it by the group size.
* :func:`gather_from` — all-gather forward, this rank's slice backward:
  a sharded tensor made whole for replicated work downstream.
* :func:`fsdp_gather` — all-gather forward over the batch mesh axes of a
  parameter stored FSDP-cut, reduce-scatter backward: each rank of those
  axes computed its own rows with the whole weight, so the parameter's
  gradient is the sum of their partials, of which a rank keeps its slice.

``groups`` is a tuple of process groups (one per mesh axis of the split;
a sum over several axes runs over each in turn); an empty tuple makes
every operator the identity.  Every rank of a group must make the same
calls in the same order, backward passes and recomputation included.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.collectives import note_collective


def _all_reduce(x: torch.Tensor, groups, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.contiguous().clone()
    for group in groups:
        note_collective("all-reduce", out, group)
        dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    list ``all_gather``: the backends of torch 2.11 and 2.13 both take
    it, on CPU and CUDA tensors)."""
    p = dist.get_world_size(group)
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(p)]
    note_collective("all-gather", x, group)
    dist.all_gather(outs, x, group=group)
    return torch.cat(outs, dim=dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.groups), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, groups):
        ctx.dim, ctx.groups = dim, groups
        ctx.block = x.shape[dim]
        for group in reversed(groups):
            x = all_gather_dim(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        index = 0
        for group in ctx.groups:
            index = index * dist.get_world_size(group) \
                + dist.get_rank(group)
        return grad.narrow(ctx.dim, index * ctx.block,
                           ctx.block).contiguous(), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cuts):
        ctx.cuts = cuts
        ctx.blocks = tuple(x.shape[dim] for dim, _, _ in cuts)
        for dim, groups, _ in cuts:
            for group in reversed(groups):
                x = all_gather_dim(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        # the reduce-scatter, as an all-reduce and a narrow (one code path
        # for gloo and NCCL): the sum over every summed group first, then
        # this rank's slice of each gathered dimension
        out = grad.contiguous().clone()
        for _, groups, summed in ctx.cuts:
            for group, add in zip(groups, summed):
                if add:
                    note_collective("reduce-scatter", out, group)
                    dist.all_reduce(out, group=group)
        for (dim, groups, _), block in zip(ctx.cuts, ctx.blocks):
            index = 0
            for group in groups:
                index = index * dist.get_world_size(group) \
                    + dist.get_rank(group)
            out = out.narrow(dim, index * block, block)
        return out.contiguous(), None


def fsdp_gather(x: torch.Tensor, cuts: Sequence) -> torch.Tensor:
    """``x``, a parameter block stored cut over batch mesh axes, made
    whole over them.  ``cuts``: (dimension, groups, summed) per gathered
    dimension, ``groups`` in the split's row-major order (the block order
    of :meth:`Sharder.split`) and ``summed`` a flag per group: whether the
    backward sums the gradient over it (the batch is split over that axis,
    so each rank holds a partial) or, where every rank of the group
    computed the same rows, only takes this rank's slice."""
    return _FsdpGather.apply(x, tuple(cuts)) if cuts else x


def copy_to(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Identity forward, all-reduce (sum) backward over ``groups``."""
    return _CopyTo.apply(x, tuple(groups)) if groups else x


def reduce_from(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """All-reduce (sum) forward over ``groups``, identity backward; in
    ``x``'s dtype."""
    return _ReduceFrom.apply(x, tuple(groups)) if groups else x


def gather_from(x: torch.Tensor, dim: int, groups: Sequence) -> torch.Tensor:
    """``x``'s blocks of every rank concatenated along ``dim`` (the block
    order of :meth:`Sharder.split`); backward takes this rank's slice."""
    return _GatherFrom.apply(x, dim, tuple(groups)) if groups else x


def all_reduce_max(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Elementwise max over ``groups`` (no gradient: a stabilizer)."""
    if not groups:
        return x.detach()
    return _all_reduce(x.detach(), groups, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Elementwise sum over ``groups`` (no gradient)."""
    if not groups:
        return x
    return _all_reduce(x.detach(), groups)
