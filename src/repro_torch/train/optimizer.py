"""AdamW and its learning-rate schedules, in plain torch.

The port of the JAX package's ``repro/train/optimizer.py``, with its
semantics: clipping by the global gradient norm, first and second moments
stored in ``moment_dtype`` (bfloat16 by default) with the arithmetic in
float32, bias correction, weight decay added to the update of every leaf,
and the metrics ``grad_norm`` and ``lr``.  ``torch.optim.AdamW`` is not
used: its moments live in the parameters' dtype and it does not clip.

Trees are nested dicts of tensors, as the parameters are.  One
difference from the JAX package, whose arrays are immutable:
:meth:`AdamW.update` overwrites the moments in place (the returned
:class:`AdamState` holds the same tensors) and :func:`apply_updates` adds
the updates to the parameters in place, without autograd.  The step
counter and the schedules' scalars are float32 / int32 tensors on the
host, so no update waits for the card.

Under tensor parallelism each rank's trees hold its blocks:
:func:`global_norm` given the sharder and the ParamDef tree all-reduces
the squares of split leaves over their groups and counts replicated
leaves once, and :meth:`AdamW.update` takes its value as ``gnorm``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor     # () int32, on the host
    m: Any                 # tree like params, moment_dtype
    v: Any


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, val, *(r[key] for r in rest))
                for key, val in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for val in tree.values() for leaf in tree_leaves(val)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1.0e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: torch.dtype = torch.bfloat16

    def init(self, params) -> AdamState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        return AdamState(torch.zeros((), dtype=torch.int32),
                         tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               gnorm: Optional[torch.Tensor] = None
               ) -> Tuple[Any, AdamState, Dict[str, torch.Tensor]]:
        """(updates, state, {"grad_norm", "lr"}): the updates to add to
        ``params`` (float32 trees computed in the JAX package's order);
        the moments of ``state`` are overwritten in place.  ``gnorm``: the
        global gradient norm (default ``global_norm(grads)``)."""
        step = state.step + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1.0e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        b1, b2 = self.b1, self.b2

        def moments(mm, vv, g):
            g = g.float()
            mm.copy_(b1 * mm.float() + (1 - b1) * g)
            vv.copy_(b2 * vv.float() + (1 - b2) * g.square())

        tree_map(moments, state.m, state.v, grads)
        stepf = step.to(torch.float32)
        # the scalars in float32 on the host, as the JAX package computes
        # them; float() of a float32 tensor is that value exactly
        c1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
        c2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)
        lr = torch.as_tensor(self.learning_rate(step), dtype=torch.float32)
        neg_lr = float(-lr)

        def upd(p, mm, vv):
            mhat = mm.float() / c1
            vhat = vv.float() / c2
            du = mhat / (torch.sqrt(vhat) + self.eps)
            du = du + self.weight_decay * p.float()
            return (neg_lr * du).to(p.dtype)

        updates = tree_map(upd, params, state.m, state.v)
        return updates, AdamState(step, state.m, state.v), \
            {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates(params, updates):
    """``params + updates``, written into ``params``; returns ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def global_norm(tree, sharder=None, defs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-d tensor).

    With a ``sharder`` over a mesh, ``tree`` holds this rank's blocks of
    the leaves of the ParamDef tree ``defs``: the squares of the leaves
    split over a set of mesh axes are summed, all-reduced once over those
    axes' groups, and the replicated leaves are counted once."""
    if sharder is None or sharder.mesh is None:
        return torch.sqrt(sum(leaf.float().square().sum()
                              for leaf in tree_leaves(tree)))
    from repro_torch.parallel.collectives import all_reduce_sum
    by_axes: Dict[tuple, torch.Tensor] = {}
    for leaf, d in zip(tree_leaves(tree), _def_leaves(defs)):
        axes = tuple(a for s in sharder.layout(d.axes, d.shape)
                     for a in s.axes)
        sq = leaf.float().square().sum()
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    return torch.sqrt(sum(all_reduce_sum(sq, sharder.groups(axes))
                          for axes, sq in sorted(by_axes.items())))


def _def_leaves(defs):
    if isinstance(defs, dict):
        return [leaf for val in defs.values() for leaf in _def_leaves(val)]
    return [defs]


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1) -> Callable:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``floor · peak_lr`` at ``total_steps`` (float32, as the JAX one)."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn


def constant_schedule(lr: float) -> Callable:
    return lambda step: torch.tensor(lr, dtype=torch.float32)
