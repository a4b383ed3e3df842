"""Rank (searchsorted) matching — the GPU analogue of Interval-Tree
Matching (paper §3.3), and a fast counting path beside the sweep.

ITM answers each update query by descending a balanced interval tree in
O(log n).  Over *static* extent sets the same query is two binary searches
on sorted endpoint arrays:

    count(S_i) = |{j : U.lo_j ≤ S.hi_i}| − |{j : U.hi_j < S.lo_i}|

The first term counts the updates that start before S_i ends; the
subtracted term the updates that ended strictly before S_i starts — all of
which started before S_i ends — so the difference is the number of
overlapping updates (closed intervals).  O((n+m) log m) after an
O(m log m) sort, every query in parallel.
"""
from __future__ import annotations

import torch

from repro_torch.core import collectives
from repro_torch.core.intervals import Extents


def _match_counts(q: Extents, c: Extents) -> torch.Tensor:
    """Per-query counts of overlapping ``c`` extents, int32."""
    c_lo_sorted = torch.sort(c.lo).values
    c_hi_sorted = torch.sort(c.hi).values
    started = torch.searchsorted(c_lo_sorted, q.hi, right=True)
    ended_before = torch.searchsorted(c_hi_sorted, q.lo, right=False)
    return (started - ended_before).to(torch.int32)


def per_sub_match_counts(subs: Extents, upds: Extents) -> torch.Tensor:
    """Number of matching updates for every subscription (exact, int32)."""
    return _match_counts(subs, upds)


def per_upd_match_counts(subs: Extents, upds: Extents) -> torch.Tensor:
    """Number of matching subscriptions for every update (exact, int32)."""
    return _match_counts(upds, subs)


def rank_count(subs: Extents, upds: Extents) -> torch.Tensor:
    """Total number of matches K as an exact 0-d int64 tensor (the dual of
    :func:`repro_torch.core.sweep.sbm_count`).  The JAX package sums the
    int32 rows in int32, which wraps once K passes 2³¹; the port's total
    does not."""
    return per_sub_match_counts(subs, upds).sum(dtype=torch.int64)


def rank_count_sharded(subs: Extents, upds: Extents, mesh, axis_name: str):
    """Queries sharded across one dimension of a ``DeviceMesh`` (the
    parallel-ITM analogue): K as a 0-d int64 tensor, the same on every
    rank.

    Every rank calls it with the same extents and sorts the update bounds
    itself (they play the shared interval tree); it answers its contiguous
    shard of the subscription queries, padded to a multiple of P with
    inert ``[-inf, -inf]`` queries (no update starts at or before -inf, none
    ends before it), and an all-reduce sums the shards' int64 counts.
    """
    group, p, index = collectives.mesh_axis(mesh, axis_name)
    u_lo_sorted = torch.sort(upds.lo).values
    u_hi_sorted = torch.sort(upds.hi).values
    s_lo = collectives.shard_padded(subs.lo, p, index, float("-inf"))
    s_hi = collectives.shard_padded(subs.hi, p, index, float("-inf"))
    started = torch.searchsorted(u_lo_sorted, s_hi, right=True)
    ended = torch.searchsorted(u_hi_sorted, s_lo, right=False)
    return collectives.all_reduce_sum((started - ended).sum(dtype=torch.int64),
                                      group)
