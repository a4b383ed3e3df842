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
