"""Step builders and sharded specs shared by the training and serving
launchers and the dry run.

The port of the JAX package's ``repro/launch/steps.py``.
``make_train_step`` is the training loop's own
(:func:`repro_torch.train.loop.make_train_step`, with a ``microbatches``
argument): it writes the new parameters and moments into the given
tensors (the JAX step returns new arrays).

The ``sds_*`` helpers are the counterpart of the JAX ``ShapeDtypeStruct``
trees with ``NamedSharding``s: allocation-free, their leaves are
:class:`ShardedSpec`s, each rank's block as a ``meta`` tensor with the
global shape and the :class:`~repro_torch.parallel.sharding.Layout`
beside it.  The block shape is the run-time layout's
(:meth:`Sharder.block_shape`), so a :class:`MeshShape` of 16 × 16 or
2 × 16 × 16 gives it without ranks; the layout's spec is the JAX one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.configs import ShapeDef, batch_shapes
from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.models.transformer import Model, make_cache
from repro_torch.parallel.sharding import Layout, Sharder
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamState, AdamW

__all__ = ["ShardedSpec", "make_decode_step", "make_prefill_step",
           "make_train_step", "sds_batch", "sds_cache", "sds_enc_out",
           "sds_opt_state", "sds_params", "sds_scalar", "sds_token",
           "spec_bytes", "spec_leaves"]


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def make_prefill_step(model: Model):
    def prefill_step(params, batch, cache):
        return model.prefill(params, batch, cache)
    return prefill_step


def make_decode_step(model: Model, enc_dec: bool):
    if enc_dec:
        def decode_step(params, token, cache, pos, enc_out):
            return model.decode_step(params, token, cache, pos, enc_out)
    else:
        def decode_step(params, token, cache, pos):
            return model.decode_step(params, token, cache, pos)
    return decode_step


# ---------------------------------------------------------------------------
# Sharded specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedSpec:
    """One leaf of an ``sds_*`` tree: ``block``, this rank's block as a
    ``meta`` tensor (its shape and dtype); ``shape``, the global shape;
    ``layout``, the spec on the mesh (None without one)."""

    block: torch.Tensor
    shape: Tuple[int, ...]
    layout: Optional[Layout]

    @property
    def dtype(self) -> torch.dtype:
        return self.block.dtype

    @property
    def nbytes(self) -> int:
        return self.block.numel() * self.block.element_size()


def _spec(sharder: Sharder, axes: Sequence[Optional[str]],
          shape: Sequence[int], dtype: torch.dtype) -> ShardedSpec:
    shape = tuple(int(d) for d in shape)
    return ShardedSpec(
        torch.empty(sharder.block_shape(axes, shape), dtype=dtype,
                    device="meta"),
        shape, sharder.named(axes, shape))


def _map_defs(fn, node):
    if isinstance(node, ParamDef):
        return fn(node)
    return {key: _map_defs(fn, val) for key, val in node.items()}


def spec_leaves(tree):
    """The :class:`ShardedSpec` leaves of an ``sds_*`` tree, in order."""
    if isinstance(tree, ShardedSpec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in spec_leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in spec_leaves(v)]
    return []


def spec_bytes(tree) -> int:
    """The bytes of each rank's blocks of an ``sds_*`` tree."""
    return sum(leaf.nbytes for leaf in spec_leaves(tree))


def sds_params(model: Model, sharder: Sharder, dtype=None):
    dtype = dtype or model.cfg.param_dtype
    return _map_defs(lambda d: _spec(sharder, d.axes, d.shape, dtype),
                     model.defs())


def sds_opt_state(model: Model, sharder: Sharder, opt: AdamW) -> AdamState:
    def moments():
        return _map_defs(
            lambda d: _spec(sharder, d.axes, d.shape, opt.moment_dtype),
            model.defs())
    step = _spec(sharder, (), (), torch.int32)
    return AdamState(step, moments(), moments())


def sds_batch(cfg: ModelConfig, shape: ShapeDef, sharder: Sharder):
    out = {}
    for name, (shp, dt) in batch_shapes(cfg, shape).items():
        axes = ("batch",) + (None,) * (len(shp) - 1)
        out[name] = _spec(sharder, axes, shp, dt)
    return out


def sds_cache(model: Model, sharder: Sharder, batch: int, max_len: int):
    """The cache of :meth:`Model.init_cache` for a global batch of
    ``batch`` rows: its global leaves built on the ``meta`` device, cut
    per :meth:`Model.cache_spec_axes` (as the JAX ``sds_cache`` takes
    ``jax.eval_shape`` of the model's own ``init_cache``; no second
    ``Model`` is built, so a manual MoE mode passes)."""
    whole = make_cache(model.cfg, batch, max_len, sharder=Sharder(),
                       device="meta")
    axes_tree = model.cache_spec_axes()
    return {name: type(state)(*(
        _spec(sharder, axes, leaf.shape, leaf.dtype)
        for axes, leaf in zip(axes_tree[name], state)))
        for name, state in whole.items()}


def sds_enc_out(cfg: ModelConfig, batch: int, seq: int, sharder: Sharder):
    return _spec(sharder, ("batch", None, None), (batch, seq, cfg.d_model),
                 cfg.dtype)


def sds_token(cfg: ModelConfig, batch: int, sharder: Sharder):
    return _spec(sharder, ("batch", None), (batch, 1), torch.int32)


def sds_scalar(sharder: Sharder, dtype=torch.int32):
    return _spec(sharder, (), (), dtype)
