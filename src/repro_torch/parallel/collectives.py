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

``groups`` is a tuple of process groups (one per mesh axis of the split;
a sum over several axes runs over each in turn); an empty tuple makes
every operator the identity.  Every rank of a group must make the same
calls in the same order, backward passes and recomputation included.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, groups, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    out = x.contiguous().clone()
    for group in groups:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (a
    list ``all_gather``: the backends of torch 2.11 and 2.13 both take
    it, on CPU and CUDA tensors)."""
    p = dist.get_world_size(group)
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(p)]
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
