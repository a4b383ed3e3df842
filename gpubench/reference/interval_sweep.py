"""A plain NumPy sort-based sweep over closed 1-d intervals: K and every
(subscription, update) pair whose intervals intersect.

Sub i and update j match iff ``u_lo[j] <= s_hi[i]`` and ``s_lo[i] <=
u_hi[j]``.  Counting: with the update bounds sorted, K = sum over i of
#{j: u_lo[j] <= s_hi[i]} - #{j: u_hi[j] < s_lo[i]} (an update ending
before s_lo[i] starts before s_hi[i]).  Pairs: with the updates sorted by
lower bound, every match of i has u_lo in [s_lo[i] - w, s_hi[i]], w the
widest update; those candidates are tested exactly.  Bounds are compared
as the float32 values they are (in float64, exactly).
"""
from __future__ import annotations

import numpy as np


def count(s_lo, s_hi, u_lo, u_hi) -> int:
    s_lo, s_hi, u_lo, u_hi = (np.asarray(a, np.float64)
                              for a in (s_lo, s_hi, u_lo, u_hi))
    starts = np.searchsorted(np.sort(u_lo), s_hi, side="right")
    ends = np.searchsorted(np.sort(u_hi), s_lo, side="left")
    return int(starts.sum(dtype=np.int64) - ends.sum(dtype=np.int64))


def pair_key_chunks(s_lo, s_hi, u_lo, u_hi, candidates: int = 1 << 26):
    """Every matching pair as the int64 key ``i * m + j``, unsorted, in
    chunks of consecutive subscriptions with at most about
    ``candidates`` candidate pairs each (a subscription's candidates are
    never split)."""
    s_lo, s_hi, u_lo, u_hi = (np.asarray(a, np.float64)
                              for a in (s_lo, s_hi, u_lo, u_hi))
    m = u_lo.size
    if s_lo.size == 0 or m == 0:
        return
    order = np.argsort(u_lo, kind="stable")
    lo_sorted = u_lo[order]
    widest = float((u_hi - u_lo).max())
    first = np.searchsorted(lo_sorted, s_lo - widest, side="left")
    last = np.searchsorted(lo_sorted, s_hi, side="right")
    counts = (last - first).astype(np.int64)
    ends = np.cumsum(counts)
    cuts = np.searchsorted(ends, np.arange(1, ends[-1] // candidates + 1)
                           * candidates, side="left")
    bounds = np.unique(np.concatenate([[0], cuts + 1, [s_lo.size]]))
    for a, b in zip(bounds[:-1], bounds[1:]):
        a, b = int(a), min(int(b), s_lo.size)
        if a >= b:
            continue
        c = counts[a:b]
        sub = np.repeat(np.arange(a, b, dtype=np.int64), c)
        starts = np.repeat(first[a:b].astype(np.int64) - np.cumsum(c) + c, c)
        upd = order[np.arange(sub.size, dtype=np.int64) + starts] \
            .astype(np.int64)
        keep = u_hi[upd] >= s_lo[sub]
        yield sub[keep] * m + upd[keep]


def pair_keys(s_lo, s_hi, u_lo, u_hi) -> np.ndarray:
    """Every matching pair as the int64 key ``i * m + j``, unsorted."""
    chunks = list(pair_key_chunks(s_lo, s_hi, u_lo, u_hi))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
