"""Compressed gradient reduction for the slow (pod) axis.

Int8 block-quantized all-reduce with error feedback: gradients are scaled
per block of 256 values to int8, summed across the group, and
dequantized; the quantization residual is carried to the next step (error
feedback, Seide et al. 2014), so the *average* gradient is unbiased.

The counterpart of the JAX package's ``repro/parallel/compression.py``:
its ``psum`` inside ``shard_map`` is an ``all_reduce`` over the mesh
dimension's process group here.  Quantization is bit for bit the JAX one
(``torch.round`` and ``jnp.round`` both round half to even).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import all_reduce_sum

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization of a flat (n,) float32
    tensor: (q (blocks, 256) int8, scale (blocks,) float32)."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(-1, BLOCK)
    scale = xp.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xp / safe), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    n: int) -> torch.Tensor:
    x = q.to(torch.float32) * scale[:, None]
    return x.reshape(-1)[:n]


def compressed_psum(x: torch.Tensor, group, error: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 all-reduce with error feedback over ``group`` (every rank of
    it calls this).  x: flat (n,) float32 local gradient; error: (n,)
    carried residual.  Returns (the mean over the group, new residual)."""
    n = x.shape[0]
    target = x + error
    q, scale = quantize_int8(target)
    local_deq = dequantize_int8(q, scale, n)
    new_error = target - local_deq
    # the int8 payloads times their per-block float32 scales, summed
    summed = all_reduce_sum(q.to(torch.int32) * scale[:, None], (group,))
    out = summed.reshape(-1)[:n] / float(dist.get_world_size(group))
    return out, new_error


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def compressed_psum_tree(grads, group, errors):
    """Every leaf flattened, compress-reduced, its residual carried:
    (tree of means in each leaf's dtype, tree of residuals)."""
    def one(g, e):
        flat = g.reshape(-1).to(torch.float32)
        out, err = compressed_psum(flat, group, e.reshape(-1))
        return out.reshape(g.shape).to(g.dtype), err.reshape(g.shape)
    pairs = _map(one, grads, errors)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def init_errors(grads):
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)
