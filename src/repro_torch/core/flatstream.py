"""Flat sorted endpoint stream — the legacy full-splice backend.

One contiguous sorted array quartet (values / is_upper / is_sub / owner)
per spatial dimension, maintained by whole-stream surgery: a delete pass
boolean-masks all four arrays and an insert pass merges the sorted delta
with one searchsorted + scatter.  Both are O(n + m) per batch no matter
how small the batch — the cost model the blocked index replaces
(:mod:`repro_torch.core.blockstream`, DESIGN.md §13).  The flat path
stays selectable as ``IncrementalIndex(index_impl="flat")``: it is the
conformance twin the blocked index is differential-tested against.

This module is the one blessed home of full-stream splice operations on
incremental-index state — rule INC001 (``repro.analysis.inc_rules``)
flags whole-array splice/sort calls on stream state anywhere else, the
same way JAX003 guards the one pow2 ladder.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Prep:
    """Position-space rank tables of one frozen index state.

    The same quantities as :func:`repro_torch.core.sweep.rank_tables_from_cumsums`
    (a/b per-extent rank ranges + rank→id maps), built from the persistent
    sorted stream — by two whole-stream cumsums here, or assembled from
    per-block cached tables by the blocked backend — and cached until the
    next mutation.
    """

    subs_by_lo: np.ndarray   # sub-lower rank → sub rid
    upds_by_lo: np.ndarray   # upd-lower rank → upd rid
    a_start: np.ndarray      # per sub rid: first upd-lower rank after its lo
    a_end: np.ndarray        # per sub rid: first upd-lower rank after its hi
    b_start: np.ndarray      # per upd rid: symmetric over sub-lower ranks
    b_end: np.ndarray
    live_s: np.ndarray       # live rid arrays (emission sources)
    live_u: np.ndarray


@dataclasses.dataclass
class RankTables:
    """Raw (live-id-free) rank tables a stream backend hands the index.

    ``patched_blocks`` reports how many blocks had their cached local
    tables recomputed to build this (the flat backend is one big block).
    """

    subs_by_lo: np.ndarray
    upds_by_lo: np.ndarray
    a_start: np.ndarray
    a_end: np.ndarray
    b_start: np.ndarray
    b_end: np.ndarray
    patched_blocks: int = 1


class FlatEndpointStream:
    """One dimension's sorted endpoint stream, flat-array backed.

    Invariants (shared with the blocked backend, asserted by the tests):
    values ascending; within an equal-value run all lowers precede all
    uppers (the closed-interval tie-break); one record per (owner, side,
    endpoint) of every live region.
    """

    impl = "flat"

    def __init__(self):
        self.values = np.zeros(0, np.float32)
        self.is_upper = np.zeros(0, bool)
        self.is_sub = np.zeros(0, bool)
        self.owner = np.zeros(0, np.int32)

    @property
    def size(self) -> int:
        return self.values.shape[0]

    def arrays(self):
        """(values, is_upper, is_sub, owner) — the sorted stream."""
        return self.values, self.is_upper, self.is_sub, self.owner

    # -- surgery -----------------------------------------------------------
    def delete_batch(self, drop_sub: np.ndarray, drop_upd: np.ndarray,
                     del_values: np.ndarray) -> int:
        """Drop every record whose owner is flagged on its side.

        ``del_values`` (the dropped records' endpoint values) is the
        blocked backend's routing input; the flat pass masks the whole
        stream and ignores it.  Returns blocks touched (the flat stream
        is one block).
        """
        if self.size == 0:
            return 0
        gone = np.where(self.is_sub, drop_sub[self.owner],
                        drop_upd[self.owner])
        if not gone.any():
            return 0
        keep = ~gone
        self.values = self.values[keep]
        self.is_upper = self.is_upper[keep]
        self.is_sub = self.is_sub[keep]
        self.owner = self.owner[keep]
        return 1

    def insert_batch(self, vals: np.ndarray, up: np.ndarray,
                     sub: np.ndarray, own: np.ndarray) -> int:
        """Splice a delta presorted by (value, upper-flag) into the stream.

        Splice position per delta record: a *lower* goes before every
        stream record of equal value (side='left'), an *upper* after all
        of them (side='right') — preserving the lowers-before-uppers
        closed-interval tie-break without composite keys.
        """
        k = vals.shape[0]
        if k == 0:
            return 0
        pos = np.where(up,
                       np.searchsorted(self.values, vals, side="right"),
                       np.searchsorted(self.values, vals, side="left"))
        dest = pos + np.arange(k)            # pos is nondecreasing in order
        total = self.size + k
        old = np.ones(total, bool)
        old[dest] = False
        for name, delta in (("values", vals), ("is_upper", up),
                            ("is_sub", sub), ("owner", own)):
            store = getattr(self, name)
            merged = np.empty(total, delta.dtype)
            merged[dest] = delta
            merged[old] = store
            setattr(self, name, merged)
        return 1

    # -- rank tables ---------------------------------------------------------
    def rank_tables(self, cap_s: int, cap_u: int) -> RankTables:
        """Whole-stream cumsum rank tables (DESIGN.md §6).

        An inclusive cumsum read at a foreign-type position counts the
        strictly-before lowers — exactly ``rank_tables_from_cumsums``'
        scatter, done once per batch on the host stream.
        """
        is_upper, is_sub, owner = self.is_upper, self.is_sub, self.owner
        sel_lo = ~is_upper
        sel_s_lo = is_sub & sel_lo
        sel_u_lo = ~is_sub & sel_lo
        c_sub_lo = np.cumsum(sel_s_lo)       # host int64 — no wrap to fix
        c_upd_lo = np.cumsum(sel_u_lo)
        a_start = np.zeros(cap_s, np.int64)
        a_end = np.zeros(cap_s, np.int64)
        b_start = np.zeros(cap_u, np.int64)
        b_end = np.zeros(cap_u, np.int64)
        sel_s_up = is_sub & is_upper
        sel_u_up = ~is_sub & is_upper
        a_start[owner[sel_s_lo]] = c_upd_lo[sel_s_lo]
        a_end[owner[sel_s_up]] = c_upd_lo[sel_s_up]
        b_start[owner[sel_u_lo]] = c_sub_lo[sel_u_lo]
        b_end[owner[sel_u_up]] = c_sub_lo[sel_u_up]
        return RankTables(
            subs_by_lo=owner[sel_s_lo], upds_by_lo=owner[sel_u_lo],
            a_start=a_start, a_end=a_end, b_start=b_start, b_end=b_end,
            patched_blocks=1)
