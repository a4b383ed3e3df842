"""Blocked endpoint stream — sublinear churn surgery (DESIGN.md §13).

The flat backend (:mod:`repro_torch.core.flatstream`) pays O(n + m) per batch
to re-splice one contiguous sorted array, no matter how small the batch.
This backend keeps the same logical stream as a **two-level structure**:

* **blocks** — consecutive sorted chunks of ~O(√n) endpoints, each its
  own small array quartet with natural slack (blocks shrink and grow
  independently);
* **directory** — three parallel arrays (``_mins``/``_maxs``/``_counts``)
  summarizing the blocks in stream order.

A delta routes each endpoint value through one ``searchsorted`` on the
directory, then touches only the owning blocks: inserts merge into a
block's local arrays, deletes compact a block in place, and a normalize
pass splits overflowing blocks / merges underflowing neighbours so block
sizes stay within [B/4, 2B] of the √n target.  Flush cost becomes
O(b·log n + touched_blocks·B) instead of O(n + m).

Rank tables are cached **per block** (each block's local lower-rank
cumsums and owner lists survive until that block mutates); the global
tables are assembled from block locals with one exclusive prefix cumsum
over per-block counts, ``np.repeat`` of the offsets, and one scatter —
only dirty blocks recompute their locals.

Ordering invariants are identical to the flat stream (values ascending,
lowers before uppers at equal values) and are preserved by the routing
rule proven in DESIGN.md §13: a lower routes to the *first* block whose
max ≥ v, an upper to the *last* block whose min ≤ v, and when no block's
range contains v (a gap) both sides route to the first block after the
gap, where the delta's own (value, upper) presort keeps the tie-break.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from repro_torch.core import runtime as runtime_lib
from repro_torch.core.errors import ValidationError
from repro_torch.core.flatstream import RankTables

_round_up_pow2 = runtime_lib.round_up_pow2

BLOCK_MIN = 32        # clamp of the adaptive √n block target
BLOCK_MAX = 4096


class _LocalTables:
    """One block's cached rank-table contribution (block-local ranks)."""

    __slots__ = ("own_s_lo", "own_u_lo", "own_s_up", "own_u_up",
                 "s_lo_u", "s_up_u", "u_lo_s", "u_up_s",
                 "n_s_lo", "n_u_lo")

    def __init__(self, is_upper, is_sub, owner):
        sel_lo = ~is_upper
        sel_s_lo = is_sub & sel_lo
        sel_u_lo = ~is_sub & sel_lo
        sel_s_up = is_sub & is_upper
        sel_u_up = ~is_sub & is_upper
        c_s = np.cumsum(sel_s_lo)            # block-local inclusive cumsums
        c_u = np.cumsum(sel_u_lo)
        self.own_s_lo = owner[sel_s_lo]      # stream-order owner lists
        self.own_u_lo = owner[sel_u_lo]
        self.own_s_up = owner[sel_s_up]
        self.own_u_up = owner[sel_u_up]
        self.s_lo_u = c_u[sel_s_lo]          # upd-lowers at/before each …
        self.s_up_u = c_u[sel_s_up]
        self.u_lo_s = c_s[sel_u_lo]          # sub-lowers at/before each …
        self.u_up_s = c_s[sel_u_up]
        self.n_s_lo = self.own_s_lo.shape[0]
        self.n_u_lo = self.own_u_lo.shape[0]


class _Block:
    """One sorted chunk of the stream plus its lazily-cached rank locals."""

    __slots__ = ("values", "is_upper", "is_sub", "owner", "tables")

    def __init__(self, values, is_upper, is_sub, owner):
        self.values = values
        self.is_upper = is_upper
        self.is_sub = is_sub
        self.owner = owner
        self.tables: Optional[_LocalTables] = None

    @property
    def size(self) -> int:
        return self.values.shape[0]

    def local_tables(self) -> _LocalTables:
        if self.tables is None:
            self.tables = _LocalTables(self.is_upper, self.is_sub, self.owner)
        return self.tables


class BlockedEndpointStream:
    """One dimension's sorted endpoint stream, block-list backed.

    Drop-in for :class:`repro_torch.core.flatstream.FlatEndpointStream` — same
    ``arrays``/``delete_batch``/``insert_batch``/``rank_tables`` surface,
    same ordering invariants — but surgery touches only owning blocks.
    ``block_target`` pins the block size B (the conformance engines pin a
    tiny B to force split/merge churn); ``None`` adapts B to ~√total.
    """

    impl = "blocked"

    def __init__(self, block_target: Optional[int] = None):
        if block_target is not None and block_target < 2:
            raise ValidationError(
                f"block_target must be >= 2, got {block_target}")
        self._fixed_target = block_target
        self._target = block_target or BLOCK_MIN
        self._blocks: List[_Block] = []
        self._mins = np.zeros(0, np.float32)
        self._maxs = np.zeros(0, np.float32)
        self._counts = np.zeros(0, np.int64)
        self._total = 0
        self._version = 0
        self._arr_cache = None               # (version, arrays tuple)
        self._rt_cache = None                # (version, cap_s, cap_u, tables)

    # -- introspection -----------------------------------------------------
    @property
    def size(self) -> int:
        return self._total

    @property
    def n_blocks(self) -> int:
        return len(self._blocks)

    def block_sizes(self) -> List[int]:
        return [b.size for b in self._blocks]

    def arrays(self):
        """(values, is_upper, is_sub, owner) — materialized, cached until
        the next mutation (consumers get the same flat view as the flat
        backend; churn surgery itself never calls this)."""
        if self._arr_cache is None or self._arr_cache[0] != self._version:
            if not self._blocks:
                tup = (np.zeros(0, np.float32), np.zeros(0, bool),
                       np.zeros(0, bool), np.zeros(0, np.int32))
            else:
                tup = (np.concatenate([b.values for b in self._blocks]),
                       np.concatenate([b.is_upper for b in self._blocks]),
                       np.concatenate([b.is_sub for b in self._blocks]),
                       np.concatenate([b.owner for b in self._blocks]))
            self._arr_cache = (self._version, tup)
        return self._arr_cache[1]

    def check_invariants(self) -> None:
        """Assert block/directory coherence (test hook, O(n))."""
        vals, up, _, _ = self.arrays()
        assert self._total == vals.shape[0]
        assert np.all(vals[:-1] <= vals[1:]), "stream not sorted"
        # lowers before uppers within equal-value runs: an upper directly
        # followed by a lower must strictly increase the value
        if vals.shape[0] > 1:
            bad = up[:-1] & ~up[1:] & (vals[:-1] == vals[1:])
            assert not bad.any(), "tie-break violated"
        assert len(self._blocks) == self._mins.shape[0] == \
            self._maxs.shape[0] == self._counts.shape[0]
        for i, b in enumerate(self._blocks):
            assert b.size > 0, f"empty block {i} survived normalize"
            assert self._counts[i] == b.size
            assert self._mins[i] == b.values[0]
            assert self._maxs[i] == b.values[-1]

    # -- structure ---------------------------------------------------------
    def _compute_target(self, total: int) -> int:
        if self._fixed_target is not None:
            return self._fixed_target
        b = _round_up_pow2(max(math.isqrt(max(total, 1)), 1))
        return min(max(b, BLOCK_MIN), BLOCK_MAX)

    def _rebuild(self, values, is_upper, is_sub, owner) -> None:
        """Re-chunk a flat sorted stream into ~B-sized blocks."""
        total = values.shape[0]
        self._total = total
        self._target = self._compute_target(total)
        if total == 0:
            self._blocks = []
        else:
            edges = list(range(0, total, self._target)) + [total]
            self._blocks = [
                _Block(values[a:b].copy(), is_upper[a:b].copy(),
                       is_sub[a:b].copy(), owner[a:b].copy())
                for a, b in zip(edges[:-1], edges[1:])]
        self._refresh_directory()

    def _refresh_directory(self) -> None:
        blocks = self._blocks
        self._mins = np.array([b.values[0] for b in blocks], np.float32)
        self._maxs = np.array([b.values[-1] for b in blocks], np.float32)
        self._counts = np.array([b.size for b in blocks], np.int64)

    def _normalize(self) -> None:
        """Restore block-size bounds: drop empties, split > 2B, merge small
        neighbours.  O(changed region) except the O(n_blocks) directory
        refresh when structure changed."""
        B = self._target = self._compute_target(self._total)
        counts = self._counts
        nb = counts.shape[0]
        low = B // 4
        bad = (counts == 0) | (counts > 2 * B)
        if nb > 1:
            bad |= counts < low
        if not bad.any():
            return
        out: List[_Block] = []
        for blk in self._blocks:
            if blk.size == 0:
                continue
            if out and (out[-1].size < low or blk.size < low) \
                    and out[-1].size + blk.size <= 2 * B:
                prev = out[-1]
                out[-1] = _Block(
                    np.concatenate([prev.values, blk.values]),
                    np.concatenate([prev.is_upper, blk.is_upper]),
                    np.concatenate([prev.is_sub, blk.is_sub]),
                    np.concatenate([prev.owner, blk.owner]))
                continue
            out.append(blk)
        final: List[_Block] = []
        for blk in out:
            if blk.size > 2 * B:
                v, u, s, o = blk.values, blk.is_upper, blk.is_sub, blk.owner
                edges = list(range(0, blk.size, B)) + [blk.size]
                if edges[-1] - edges[-2] < low and len(edges) > 2:
                    edges.pop(-2)            # fold the runt into its left chunk
                final.extend(
                    _Block(v[a:b].copy(), u[a:b].copy(),
                           s[a:b].copy(), o[a:b].copy())
                    for a, b in zip(edges[:-1], edges[1:]))
            else:
                final.append(blk)
        self._blocks = final
        self._refresh_directory()

    # -- surgery -----------------------------------------------------------
    def delete_batch(self, drop_sub: np.ndarray, drop_upd: np.ndarray,
                     del_values: np.ndarray) -> int:
        """Drop flagged-owner records, probing only blocks whose value range
        can contain a deleted endpoint.  Returns blocks touched."""
        nb = len(self._blocks)
        if nb == 0 or del_values.shape[0] == 0:
            return 0
        self._version += 1
        self._arr_cache = None
        self._rt_cache = None
        if del_values.shape[0] >= nb:
            # delta as large as the directory: one flat pass beats per-block
            # routing (and re-chunking restores √n-sized blocks afterwards)
            v, u, s, o = self.arrays()
            self._version += 1
            self._arr_cache = None
            gone = np.where(s, drop_sub[o], drop_upd[o])
            keep = ~gone
            self._rebuild(v[keep], u[keep], s[keep], o[keep])
            return nb
        dv = np.unique(del_values)
        # candidate block range per value: [first block with max >= v,
        # last block with min <= v] — ties spanning blocks are all covered
        first = np.searchsorted(self._maxs, dv, side="left")
        last = np.searchsorted(self._mins, dv, side="right") - 1
        valid = first <= last
        cover = np.zeros(nb + 1, np.int64)
        np.add.at(cover, first[valid], 1)
        np.add.at(cover, last[valid] + 1, -1)
        cand = np.nonzero(np.cumsum(cover[:nb]) > 0)[0]
        touched = 0
        removed = 0
        for bi in cand.tolist():
            blk = self._blocks[bi]
            gone = np.where(blk.is_sub, drop_sub[blk.owner],
                            drop_upd[blk.owner])
            hits = int(gone.sum())
            if hits == 0:
                continue
            keep = ~gone
            blk.values = blk.values[keep]
            blk.is_upper = blk.is_upper[keep]
            blk.is_sub = blk.is_sub[keep]
            blk.owner = blk.owner[keep]
            blk.tables = None
            touched += 1
            removed += hits
            self._counts[bi] = blk.size
            if blk.size:
                self._mins[bi] = blk.values[0]
                self._maxs[bi] = blk.values[-1]
        self._total -= removed
        if touched:
            self._normalize()
        return touched

    def insert_batch(self, vals: np.ndarray, up: np.ndarray,
                     sub: np.ndarray, own: np.ndarray) -> int:
        """Splice a delta presorted by (value, upper-flag); returns blocks
        touched.  Each record routes through the directory to one owning
        block; the destination block index is nondecreasing over the
        presorted delta, so one pass segments the delta into per-block
        contiguous merges."""
        k = vals.shape[0]
        if k == 0:
            return 0
        self._version += 1
        self._arr_cache = None
        self._rt_cache = None
        nb = len(self._blocks)
        if k >= nb:                          # includes the empty-stream case
            v0, u0, s0, o0 = self.arrays()
            self._version += 1
            self._arr_cache = None
            pos = np.where(up,
                           np.searchsorted(v0, vals, side="right"),
                           np.searchsorted(v0, vals, side="left"))
            dest = pos + np.arange(k)
            total = v0.shape[0] + k
            old = np.ones(total, bool)
            old[dest] = False
            merged = []
            for store, delta in ((v0, vals), (u0, up), (s0, sub), (o0, own)):
                m = np.empty(total, delta.dtype)
                m[dest] = delta
                m[old] = store
                merged.append(m)
            self._rebuild(*merged)
            return max(nb, 1)
        # routing: lower -> first block with max >= v; upper -> last block
        # with min <= v; gap / out-of-range (last < first) -> both to the
        # first block after the gap (clipped), where the delta presort
        # keeps lowers before uppers at equal values
        first = np.searchsorted(self._maxs, vals, side="left")
        last = np.searchsorted(self._mins, vals, side="right") - 1
        blk_idx = np.where(up & (last >= first), last, first)
        blk_idx = np.minimum(blk_idx, nb - 1)
        uniq, starts = np.unique(blk_idx, return_index=True)
        bounds = np.append(starts, k)
        for i, bi in enumerate(uniq.tolist()):
            sl = slice(int(bounds[i]), int(bounds[i + 1]))
            self._merge_into_block(int(bi), vals[sl], up[sl],
                                   sub[sl], own[sl])
        self._total += k
        self._normalize()
        return int(uniq.shape[0])

    def _merge_into_block(self, bi: int, vals, up, sub, own) -> None:
        blk = self._blocks[bi]
        j = vals.shape[0]
        pos = np.where(up,
                       np.searchsorted(blk.values, vals, side="right"),
                       np.searchsorted(blk.values, vals, side="left"))
        dest = pos + np.arange(j)
        total = blk.size + j
        old = np.ones(total, bool)
        old[dest] = False
        for name, delta in (("values", vals), ("is_upper", up),
                            ("is_sub", sub), ("owner", own)):
            store = getattr(blk, name)
            m = np.empty(total, delta.dtype)
            m[dest] = delta
            m[old] = store
            setattr(blk, name, m)
        blk.tables = None
        self._counts[bi] = blk.size
        self._mins[bi] = blk.values[0]
        self._maxs[bi] = blk.values[-1]

    # -- rank tables -------------------------------------------------------
    def rank_tables(self, cap_s: int, cap_u: int) -> RankTables:
        """Assemble global rank tables from per-block cached locals.

        Only blocks dirtied since their last materialization recompute
        their local cumsums; global ranks are locals plus an exclusive
        prefix cumsum over per-block lower counts, scattered in one pass.
        The assembled result is cached until the next mutation.
        """
        if self._rt_cache is not None:
            ver, cs, cu, cached = self._rt_cache
            if ver == self._version and cs == cap_s and cu == cap_u:
                return RankTables(
                    subs_by_lo=cached.subs_by_lo,
                    upds_by_lo=cached.upds_by_lo,
                    a_start=cached.a_start, a_end=cached.a_end,
                    b_start=cached.b_start, b_end=cached.b_end,
                    patched_blocks=0)
            self._rt_cache = None
        patched = sum(1 for b in self._blocks if b.tables is None)
        tabs = [b.local_tables() for b in self._blocks]
        a_start = np.zeros(cap_s, np.int64)
        a_end = np.zeros(cap_s, np.int64)
        b_start = np.zeros(cap_u, np.int64)
        b_end = np.zeros(cap_u, np.int64)
        if tabs:
            n_s = np.array([t.n_s_lo for t in tabs], np.int64)
            n_u = np.array([t.n_u_lo for t in tabs], np.int64)
            off_s = np.concatenate([[0], np.cumsum(n_s)[:-1]])
            off_u = np.concatenate([[0], np.cumsum(n_u)[:-1]])

            def _scatter(target, owners, locals_, offs):
                lens = np.array([o.shape[0] for o in owners], np.int64)
                target[np.concatenate(owners)] = \
                    np.concatenate(locals_) + np.repeat(offs, lens)

            _scatter(a_start, [t.own_s_lo for t in tabs],
                     [t.s_lo_u for t in tabs], off_u)
            _scatter(a_end, [t.own_s_up for t in tabs],
                     [t.s_up_u for t in tabs], off_u)
            _scatter(b_start, [t.own_u_lo for t in tabs],
                     [t.u_lo_s for t in tabs], off_s)
            _scatter(b_end, [t.own_u_up for t in tabs],
                     [t.u_up_s for t in tabs], off_s)
            subs_by_lo = np.concatenate([t.own_s_lo for t in tabs])
            upds_by_lo = np.concatenate([t.own_u_lo for t in tabs])
        else:
            subs_by_lo = np.zeros(0, np.int32)
            upds_by_lo = np.zeros(0, np.int32)
        rt = RankTables(subs_by_lo=subs_by_lo, upds_by_lo=upds_by_lo,
                        a_start=a_start, a_end=a_end,
                        b_start=b_start, b_end=b_end,
                        patched_blocks=patched)
        self._rt_cache = (self._version, cap_s, cap_u, rt)
        return rt
