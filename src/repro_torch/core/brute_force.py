"""Brute-force (region-based) matching — paper §3.1, Algorithm 2.

The O(n·m) compare-everything baseline.  The blocked form bounds peak
memory to ``block × m`` booleans: the subscriptions are padded with inert
``[+inf, -inf]`` rows to a multiple of ``block`` and compared one block of
rows at a time.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives
from repro_torch.core.intervals import Extents, intersect_1d


def bf_count(subs: Extents, upds: Extents, *, block: int = 1024
             ) -> torch.Tensor:
    """Exact match count via blocked all-pairs comparison, as a 0-d int64
    tensor on the extents' device.  The JAX package's count is an int32
    that wraps past 2³¹; the port's is exact."""
    n = subs.lo.shape[0]
    pad = (-n) % block
    dev = subs.lo.device
    s_lo = torch.cat([subs.lo, torch.full((pad,), float("inf"),
                                          dtype=subs.lo.dtype, device=dev)])
    s_hi = torch.cat([subs.hi, torch.full((pad,), float("-inf"),
                                          dtype=subs.hi.dtype, device=dev)])
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for b_lo, b_hi in zip(s_lo.reshape(-1, block), s_hi.reshape(-1, block)):
        mask = intersect_1d(b_lo[:, None], b_hi[:, None],
                            upds.lo[None, :], upds.hi[None, :])
        total += mask.sum(dtype=torch.int64)
    return total


def bf_count_sharded(subs: Extents, upds: Extents, mesh, axis_name: str,
                     *, block: int = 1024) -> torch.Tensor:
    """Paper §3.1 parallel BF over one dimension of a ``DeviceMesh``:
    subscriptions sharded, updates replicated.  Every rank calls it with the
    same extents, counts its contiguous shard of the subscriptions (padded
    to a multiple of P with inert ``[+inf, -inf]`` extents) with
    :func:`bf_count`, and an all-reduce sums the int64 counts."""
    group, p, index = collectives.mesh_axis(mesh, axis_name)
    local = Extents(
        collectives.shard_padded(subs.lo, p, index, float("inf")),
        collectives.shard_padded(subs.hi, p, index, float("-inf")))
    return collectives.all_reduce_sum(bf_count(local, upds, block=block),
                                      group)
