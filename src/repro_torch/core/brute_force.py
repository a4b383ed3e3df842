"""Brute-force (region-based) matching — paper §3.1, Algorithm 2.

The O(n·m) compare-everything baseline.  The blocked form bounds peak
memory to ``block × m`` booleans: the subscriptions are padded with inert
``[+inf, -inf]`` rows to a multiple of ``block`` and compared one block of
rows at a time.
"""
from __future__ import annotations

import torch

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
