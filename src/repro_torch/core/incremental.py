"""Incremental DDM engine — persistent endpoint index + delta rematching.

The paper's sweep is a batch algorithm, but the DDM service it accelerates
is a *churn* workload: federates continuously move, register and unregister
regions.  Rebuilding the world for one moved region costs the full
O((n+m)·log(n+m)) sort; this module keeps one sorted endpoint stream *per
dimension* live across queries and pays per batch of ``b`` changed regions
only

* O(d·b·log b) to sort the 2·b delta endpoints per dimension,
* O(d·(b·log n + touched_blocks·B)) blocked splice passes to merge them
  into the two-level endpoint index (:mod:`repro_torch.core.blockstream`;
  the O(d·(n+m)) flat splice survives as ``index_impl="flat"``, the
  conformance twin), and
* ONE stacked vectorized rematch over all changed extents (output
  O(K_changed)) to re-derive exactly the pairs the batch gained and lost.

The delta rematch gathers the changed extents into one ``(d, b)`` block and
picks its regime from b·m (:func:`_bulk_overlap_pairs`): a dense numpy
closed-interval mask for small blocks, a fused torch mask on the index's
device at mid sizes, and output-sensitive sort-based candidate generation
(searchsorted + ragged gather) at bulk scale.  The per-region loop survives
as ``delta_impl="loop"``, the property-test reference.

Rematching reuses the rank-table construction of
:func:`repro_torch.core.sweep.rank_tables_from_cumsums` restricted to
changed extents: each region's match set splits into **class A**
(counterpart opens later — a contiguous rank range over the counterpart's
lower endpoints) and **class B** (counterpart opens earlier — the
counterparts whose class-A range stabs this region's lower rank).

The index is host-resident numpy (the service control plane): churn batches
are latency-bound pointer surgery.  Only the mid-size rematch regime runs on
the device.  The stateless sweep (:mod:`repro_torch.kernels.ops`) remains
the rebuild path and the oracle every batch is property-tested against.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import runtime as runtime_lib
from repro_torch.core.blockstream import BlockedEndpointStream
from repro_torch.core.errors import ValidationError
from repro_torch.core.flatstream import FlatEndpointStream, _Prep

SUB = "sub"
UPD = "upd"
_SIDES = (SUB, UPD)


class BatchDelta(NamedTuple):
    """Exact pair-set change of one :meth:`IncrementalIndex.apply_batch`.

    ``added``/``removed`` are disjoint sets of ``(sub_rid, upd_rid)`` pairs:
    applying ``pairs -= removed; pairs |= added`` to the pre-batch match set
    yields exactly the post-batch match set (asserted end-to-end in
    ``tests/test_core_incremental.py`` against a from-scratch sweep).
    """

    added: Set[Tuple[int, int]]
    removed: Set[Tuple[int, int]]


def _as_bounds(dims: int, lo, hi, *, rid=None) -> Tuple[np.ndarray, np.ndarray]:
    who = "" if rid is None else f" (rid {rid})"
    lo = np.atleast_1d(np.asarray(lo, np.float32))
    hi = np.atleast_1d(np.asarray(hi, np.float32))
    if lo.shape != (dims,) or hi.shape != (dims,):
        raise ValidationError(
            f"bounds{who} must have length {dims}: got lo {lo.shape}, "
            f"hi {hi.shape}")
    if not np.all(lo <= hi):
        raise ValidationError(f"malformed region{who}: lo {lo} > hi {hi} "
                         "(the sweep precondition is lo <= hi)")
    return lo, hi


def _as_bounds_block(dims: int, lo, hi, *, rids=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Validate a ``(b, d)`` (or ``(b,)`` for d=1) bounds block; return the
    ``(d, b)`` layout the dense stores use.  The vectorized form of
    :func:`_as_bounds` — one comparison pass for the whole block, shared
    (like ``_as_bounds``) with the service's region tables so both layers
    enforce one contract.  When the caller knows which region each row
    belongs to, ``rids`` threads that through so the error names the
    offending rid, not just the row index."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    if lo.ndim == 1 and dims == 1:
        lo, hi = lo[:, None], hi[:, None]
    if lo.ndim != 2 or lo.shape != hi.shape or lo.shape[1] != dims:
        raise ValidationError(
            f"bulk bounds must be (b, {dims}): got lo {lo.shape}, "
            f"hi {hi.shape}")
    lo, hi = lo.T, hi.T                         # (d, b) views, no copy
    bad = ~(lo <= hi)                           # NaN fails the comparison too
    if bad.any():
        j = int(np.nonzero(bad.any(axis=0))[0][0])
        rids = np.atleast_1d(np.asarray(rids)) if rids is not None else None
        who = f" (rid {int(rids[j])})" if rids is not None and j < rids.size \
            else ""
        raise ValidationError(
            f"malformed region at row {j}{who}: lo {lo[:, j]} > hi {hi[:, j]} "
            "(the sweep precondition is lo <= hi)")
    return lo, hi


def _ragged_gather(starts: np.ndarray, counts: np.ndarray,
                   table: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate ``table[starts[i] : starts[i]+counts[i]]`` for all i.

    Returns (gathered values, repeat-index of the source row per value) —
    the vectorized form of the per-extent contiguous-range emission.
    """
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, table.dtype), np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)
    src = np.repeat(np.arange(starts.shape[0], dtype=np.int64), counts)
    return table[np.repeat(starts.astype(np.int64), counts) + within], src


# -- the stacked bulk rematch ---------------------------------------------
# The dense/device/sort thresholds live in the planner
# (repro_torch.core.runtime.BulkRegimePolicy) so the regimes can be forced
# and audited via MatchStats.

_DELTA_CHUNK = 512       # columns folded into one device-side any() flag
_round_up_pow2 = runtime_lib.round_up_pow2
_pad_cols = runtime_lib.pad_columns


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _fused_mask(q_lo, q_hi, c_lo, c_hi, device) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """(row, col) of every overlap of a pow2-padded ``(d, b)`` × ``(d, m)``
    block, computed as one fused mask on ``device``; only the hit indices
    come back to the host."""
    q_lo, q_hi, c_lo, c_hi = (_to_device(a, device)
                              for a in (q_lo, q_hi, c_lo, c_hi))
    hit = ((c_lo[:, None, :] <= q_hi[:, :, None]) &
           (q_lo[:, :, None] <= c_hi[:, None, :])).all(dim=0)
    idx = hit.nonzero().cpu().numpy()
    return idx[:, 0], idx[:, 1]


def _fused_delta_flags(old_lo, old_hi, new_lo, new_hi, c_lo, c_hi,
                       device) -> np.ndarray:
    """(b, m/CH) chunk flags on ``device``: does any cell of the chunk flip?

    A churn delta lattice is ~b·α nonzeros out of b·m cells, so returning
    only per-chunk any() flags keeps the host scan off the lattice and
    shrinks the transfer by CH×; the caller recomputes the few hit chunks
    in numpy.
    """
    old_lo, old_hi, new_lo, new_hi, c_lo, c_hi = (
        _to_device(a, device)
        for a in (old_lo, old_hi, new_lo, new_hi, c_lo, c_hi))
    was = ((c_lo[:, None, :] <= old_hi[:, :, None]) &
           (old_lo[:, :, None] <= c_hi[:, None, :])).all(dim=0)
    now = ((c_lo[:, None, :] <= new_hi[:, :, None]) &
           (new_lo[:, :, None] <= c_hi[:, None, :])).all(dim=0)
    x = was ^ now
    ch = min(_DELTA_CHUNK, x.shape[1])    # both pow2: ch divides m
    return x.reshape(x.shape[0], -1, ch).any(dim=-1).cpu().numpy()


def _sorted_overlap_pairs(q_lo, q_hi, c_lo, c_hi):
    """Output-sensitive overlap join: O((b+m)·log(b+m) + K) — no b·m mask.

    The rank-range decomposition of the sweep, applied to the (changed,
    counterpart) cross product: on the generator dimension a pair overlaps
    iff the counterpart's lower endpoint lands inside the query interval
    (**class A** — a contiguous range over counterpart lowers, found by
    two searchsorteds per query) or the query's lower endpoint lands
    strictly inside the counterpart (**class B** — the symmetric ranges
    over query lowers).  The generator dimension is chosen by probing
    every projection's candidate count with the same searchsorteds before
    gathering anything (the bulk analogue of the reference's d-dim
    dimension selection); remaining dimensions are filtered per candidate.
    """
    dims = q_lo.shape[0]
    best = None
    for d in range(dims):
        order_c = np.argsort(c_lo[d], kind="stable")
        c_lo_sorted = c_lo[d][order_c]
        a_start = np.searchsorted(c_lo_sorted, q_lo[d], side="left")
        a_end = np.searchsorted(c_lo_sorted, q_hi[d], side="right")
        order_q = np.argsort(q_lo[d], kind="stable")
        q_lo_sorted = q_lo[d][order_q]
        b_start = np.searchsorted(q_lo_sorted, c_lo[d], side="right")
        b_end = np.searchsorted(q_lo_sorted, c_hi[d], side="right")
        count = int((a_end - a_start).sum() + (b_end - b_start).sum())
        if best is None or count < best[0]:
            best = (count, d, order_c, a_start, a_end, order_q, b_start, b_end)
    _, gen, order_c, a_start, a_end, order_q, b_start, b_end = best
    cj_a, qi_a = _ragged_gather(a_start, a_end - a_start, order_c)
    qi_b, cj_b = _ragged_gather(b_start, b_end - b_start, order_q)
    qi = np.concatenate([qi_a, qi_b])
    cj = np.concatenate([cj_a, cj_b])
    if dims > 1 and qi.size:
        keep = np.ones(qi.size, bool)
        for d in range(dims):
            if d == gen:
                continue
            keep &= ((c_lo[d][cj] <= q_hi[d][qi]) &
                     (q_lo[d][qi] <= c_hi[d][cj]))
        qi, cj = qi[keep], cj[keep]
    return qi, cj


def _bulk_overlap_pairs(q_lo, q_hi, c_lo, c_hi,
                        policy: runtime_lib.BulkRegimePolicy =
                        runtime_lib.DEFAULT_BULK_POLICY, device="cpu"):
    """(row, col, regime) of every closed-interval overlap between b query
    rectangles and m counterparts (both ``(d, ·)`` blocks).

    The regime — dense numpy mask / fused torch mask on ``device`` /
    sort-based candidates — is chosen by the planner
    (:func:`repro_torch.core.runtime.select_bulk_regime` on b·m under the
    policy's thresholds; ``policy.force`` pins it), and its name is
    returned so callers can report it in :class:`MatchStats`.
    """
    b, m = q_lo.shape[1], c_lo.shape[1]
    if b == 0 or m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), "empty"
    regime = runtime_lib.select_bulk_regime(b, m, policy)
    if regime == "dense":
        mask = ((c_lo[0][None, :] <= q_hi[0][:, None]) &
                (q_lo[0][:, None] <= c_hi[0][None, :]))
        for d in range(1, q_lo.shape[0]):
            mask &= ((c_lo[d][None, :] <= q_hi[d][:, None]) &
                     (q_lo[d][:, None] <= c_hi[d][None, :]))
        # flatnonzero on the raveled view + divmod is ~30x cheaper than
        # np.nonzero on the 2-D mask (nonzero's per-axis unravel dominates
        # at small b — the b=1 single-move hot path).
        flat = np.flatnonzero(mask)
        qi, cj = np.divmod(flat, m)
        return qi, cj, regime
    if regime == "device":
        bp, mp = _round_up_pow2(b), _round_up_pow2(m)
        qi, cj = _fused_mask(
            _pad_cols(q_lo, bp, np.inf), _pad_cols(q_hi, bp, -np.inf),
            _pad_cols(c_lo, mp, np.inf), _pad_cols(c_hi, mp, -np.inf),
            device)
        # The [+inf, -inf] sentinels are inert against finite extents but a
        # legitimate (-inf, +inf) match-everything region hits them (its
        # closed-interval test is vacuously true against ANY bounds), so
        # padded indices are filtered explicitly rather than trusted away.
        keep = (qi < b) & (cj < m)
        return qi[keep], cj[keep], regime
    qi, cj = _sorted_overlap_pairs(q_lo, q_hi, c_lo, c_hi)
    return qi, cj, regime


class IncrementalIndex:
    """Persistent sorted endpoint index over live DDM regions.

    Maintains **one endpoint stream per dimension** (the per-dimension
    passes of the journal algorithm are independent — arXiv:1309.3458),
    each sorted across arbitrary interleavings of region adds, moves and
    removes by sorting only the batch's 2·b delta endpoints and splicing
    them in with single vectorized passes.  :meth:`apply_batch`
    additionally returns the exact :class:`BatchDelta` of match pairs the
    batch created/destroyed; :meth:`all_pairs` enumerates the full current
    match set from the index without re-sorting, generating candidates on
    the most *selective* dimension (fewest 1-d matches, read off the
    per-dim rank tables in O(n+m)) and filtering the remaining projections
    per pair (DESIGN.md §8).
    """

    def __init__(self, dims: int = 1, capacity: int = 64,
                 delta_impl: str = "vector",
                 regime_policy: Optional[
                     runtime_lib.BulkRegimePolicy] = None,
                 recorder: Optional[runtime_lib.StatsRecorder] = None,
                 index_impl: str = "blocked",
                 block_target: Optional[int] = None,
                 device="cuda"):
        if dims < 1:
            raise ValidationError(f"dims must be >= 1, got {dims}")
        if delta_impl not in ("vector", "loop"):
            raise ValidationError(f"delta_impl must be 'vector' or 'loop', "
                             f"got {delta_impl!r}")
        if index_impl not in ("blocked", "flat"):
            raise ValidationError(f"index_impl must be 'blocked' or 'flat', "
                             f"got {index_impl!r}")
        self.dims = dims
        # "vector": one stacked rematch per batch (_matches_of_many);
        # "loop": the pre-vectorization per-region path, kept as the
        # property-test cross-check
        self.delta_impl = delta_impl
        # "blocked": two-level √n-block endpoint index, O(b·log n +
        # touched·B) surgery (DESIGN.md §13); "flat": the legacy
        # whole-stream O(n+m) splice, kept as the conformance twin.
        # block_target pins the block size B (tests force split/merge
        # churn with tiny B); None adapts B to ~√n.
        self.index_impl = index_impl
        self.block_target = block_target
        # planner-owned bulk-rematch thresholds (force/audit via stats)
        self.regime_policy = regime_policy or runtime_lib.DEFAULT_BULK_POLICY
        # where the mid-size ("device") rematch regime runs
        self.device = torch.device(device)
        self.recorder = recorder if recorder is not None \
            else runtime_lib.StatsRecorder()
        cap = max(int(capacity), 1)
        self._lo = {s: np.full((dims, cap), np.inf, np.float32) for s in _SIDES}
        self._hi = {s: np.full((dims, cap), -np.inf, np.float32) for s in _SIDES}
        self._live = {s: np.zeros(cap, bool) for s in _SIDES}
        # the persistent sorted streams, one per dimension (values
        # ascending, lowers before uppers at equal values — the
        # closed-interval tie-break), behind the backend chosen above
        self._streams = [self._make_stream() for _ in range(dims)]
        self._prep: List[Optional[_Prep]] = [None] * dims
        self._cand_counts: List[Optional[int]] = [None] * dims
        # packed live-extent cache per side: (lv_ids, rid→column map,
        # lo (d,m), hi (d,m)) gathered once and then patched in place on
        # moves — the delta rematch reads counterpart extents without an
        # O(m) fancy-index gather per flush.  Invalidated only when a
        # side's *liveness* changes (adds/removes); moves scatter b
        # columns (matching the blocked stream's O(b) surgery scaling).
        self._pack: Dict[str, Optional[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]]] = \
            {s: None for s in _SIDES}
        # last batch's surgery stats (splice time + blocks touched) —
        # the broker frontend folds these into its flush record
        self.last_batch_stats: Optional[runtime_lib.MatchStats] = None

    def _make_stream(self):
        if self.index_impl == "flat":
            return FlatEndpointStream()
        return BlockedEndpointStream(block_target=self.block_target)

    # -- introspection -----------------------------------------------------
    def n_live(self, side: str) -> int:
        return int(self._live[side].sum())

    def live_ids(self, side: str) -> np.ndarray:
        pk = self._pack[side]
        if pk is not None:
            return pk[0]
        return np.nonzero(self._live[side])[0]

    def _live_pack(self, side: str) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
        """``(lv_ids, pos, lo (d,m), hi (d,m))`` — the packed live view.

        ``pos`` maps rid → column in the packed blocks (-1 for dead
        rids).  Built lazily with one gather per store, then kept fresh
        in place by :meth:`_apply_grouped` for moves-only batches.
        """
        pk = self._pack[side]
        if pk is None:
            lv = np.nonzero(self._live[side])[0]
            pos = np.full(self._live[side].shape[0], -1, np.int64)
            pos[lv] = np.arange(lv.size)
            pk = (lv, pos, self._lo[side][:, lv], self._hi[side][:, lv])
            self._pack[side] = pk
        return pk

    def extent_of(self, side: str, rid: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self._live[side][rid]:
            raise KeyError(f"{side} region {rid} not in index")
        return self._lo[side][:, rid].copy(), self._hi[side][:, rid].copy()

    def stream(self, dim: int = 0):
        """(values, is_upper, is_sub, owner) views of one sorted stream.

        The blocked backend materializes (and caches) the flat view on
        demand — consumers see the same contract under either impl.
        """
        return self._streams[dim].arrays()

    # -- capacity ----------------------------------------------------------
    def _ensure_capacity(self, side: str, rid: int) -> None:
        cap = self._live[side].shape[0]
        if rid < cap:
            return
        new = max(cap * 2, rid + 1)
        for store, fill in ((self._lo, np.inf), (self._hi, -np.inf)):
            grown = np.full((self.dims, new), fill, np.float32)
            grown[:, :cap] = store[side]
            store[side] = grown
        live = np.zeros(new, bool)
        live[:cap] = self._live[side]
        self._live[side] = live

    # -- the batch entry point --------------------------------------------
    def apply_batch(self, *, adds: Iterable = (), moves: Iterable = (),
                    removes: Iterable = (), want_delta: bool = True
                    ) -> BatchDelta:
        """Apply one churn batch; return the exact match-set delta.

        ``adds``/``moves``: iterables of ``(side, rid, lo, hi)``;
        ``removes``: iterables of ``(side, rid)``; ``side`` is ``"sub"`` or
        ``"upd"``, bounds are scalars (d = 1) or length-d sequences with
        ``lo <= hi`` (ValueError otherwise).  A rid may appear in at most
        one of the three lists per side (compose upstream — the service's
        pending queue does).  With ``want_delta=False`` only the index is
        maintained (O(b·log b + n + m)) and the returned delta is empty —
        for callers without a live match cache.
        """
        adds = [(s, int(r), *_as_bounds(self.dims, lo, hi, rid=int(r)))
                for s, r, lo, hi in adds]
        moves = [(s, int(r), *_as_bounds(self.dims, lo, hi, rid=int(r)))
                 for s, r, lo, hi in moves]
        removes = [(s, int(r)) for s, r in removes]

        seen: Set[Tuple[str, int]] = set()
        for side, rid in ([(s, r) for s, r, _, _ in adds + moves] + removes):
            if side not in _SIDES:
                raise ValidationError(f"unknown side {side!r}")
            if rid < 0:
                raise ValidationError(
                    f"region ids must be >= 0, got {side} rid {rid} "
                    "(negative ids would alias table slots)")
            if (side, rid) in seen:
                raise ValidationError(
                    f"{side} region {rid} appears twice in one batch "
                    "(compose adds/moves/removes upstream)")
            seen.add((side, rid))
        for side, rid, _, _ in adds:
            if rid < self._live[side].shape[0] and self._live[side][rid]:
                raise ValidationError(f"{side} region {rid} already in index")
        for side, rid in [(s, r) for s, r, _, _ in moves] + removes:
            if not (rid < self._live[side].shape[0] and self._live[side][rid]):
                raise KeyError(f"{side} region {rid} not in index")
        if not seen:
            return BatchDelta(set(), set())
        return self._apply_grouped(self._group_entries(adds),
                                   self._group_entries(moves),
                                   self._group_removes(removes), want_delta)

    def apply_batch_arrays(self, *, adds=None, moves=None, removes=None,
                           want_delta: bool = True) -> BatchDelta:
        """Array-native :meth:`apply_batch` — no per-region tuples.

        ``adds``/``moves``: mappings ``side -> (rids, lo, hi)`` with
        ``rids`` a length-b int array and ``lo``/``hi`` of shape ``(b, d)``
        (or ``(b,)`` for d = 1); ``removes``: ``side -> rids``.  Same
        per-rid contract, validation errors and :class:`BatchDelta` as the
        tuple API, but validation and application are single vectorized
        passes — the bulk churn path pays no Python cost per region.
        """
        def _conv(grp):
            out = {}
            for s, (r, lo, hi) in dict(grp or {}).items():
                r = np.asarray(r, np.int64)
                out[s] = (r, *self._bounds_block(lo, hi, rids=r))
            return out

        adds = _conv(adds)
        moves = _conv(moves)
        removes = {s: np.asarray(r, np.int64)
                   for s, r in dict(removes or {}).items()}
        empty = np.zeros(0, np.int64)
        for side in (*adds, *moves, *removes):
            if side not in _SIDES:
                raise ValidationError(f"unknown side {side!r}")
        for grp in (adds, moves):
            for side, (rids, lo, hi) in grp.items():
                if rids.ndim != 1 or lo.shape[1] != rids.shape[0]:
                    raise ValidationError(
                        f"{side}: rids {rids.shape} do not match bounds "
                        f"for {lo.shape[1]} regions")
        total = 0
        for side in _SIDES:
            add_r = adds.get(side, (empty,))[0]
            move_r = moves.get(side, (empty,))[0]
            rem_r = removes.get(side, empty)
            all_r = np.concatenate([add_r, move_r, rem_r])
            total += all_r.size
            if all_r.size == 0:
                continue
            if (all_r < 0).any():
                bad = int(all_r[all_r < 0][0])
                raise ValidationError(
                    f"region ids must be >= 0, got {side} rid {bad} "
                    "(negative ids would alias table slots)")
            if np.unique(all_r).size != all_r.size:
                vals, counts = np.unique(all_r, return_counts=True)
                raise ValidationError(
                    f"{side} region {int(vals[counts > 1][0])} appears twice "
                    "in one batch (compose adds/moves/removes upstream)")
            cap = self._live[side].shape[0]
            live_add = add_r[(add_r < cap)
                             & self._live[side][np.minimum(add_r, cap - 1)]]
            if live_add.size:
                raise ValidationError(
                    f"{side} region {int(live_add[0])} already in index")
            changed = np.concatenate([move_r, rem_r])
            dead = changed[(changed >= cap) |
                           ~self._live[side][np.minimum(changed, cap - 1)]]
            if dead.size:
                raise KeyError(f"{side} region {int(dead[0])} not in index")
        if total == 0:
            return BatchDelta(set(), set())
        return self._apply_grouped(adds, moves, removes, want_delta)

    def _bounds_block(self, lo, hi, rids=None) -> Tuple[np.ndarray, np.ndarray]:
        return _as_bounds_block(self.dims, lo, hi, rids=rids)

    def _group_entries(self, entries):
        """[(side, rid, lo (d,), hi (d,))] → side → (rids, lo (d,b), hi)."""
        out = {}
        for side in _SIDES:
            sel = [(r, lo, hi) for s, r, lo, hi in entries if s == side]
            if sel:
                out[side] = (
                    np.asarray([r for r, _, _ in sel], np.int64),
                    np.stack([lo for _, lo, _ in sel], axis=1),
                    np.stack([hi for _, _, hi in sel], axis=1))
        return out

    @staticmethod
    def _group_removes(removes):
        out = {}
        for side in _SIDES:
            sel = [r for s, r in removes if s == side]
            if sel:
                out[side] = np.asarray(sel, np.int64)
        return out

    def _apply_grouped(self, adds, moves, removes,
                       want_delta: bool) -> BatchDelta:
        """The batch core over side-grouped arrays (inputs pre-validated)."""
        empty = np.zeros(0, np.int64)
        changed_old = {
            side: np.concatenate([moves.get(side, (empty,))[0],
                                  removes.get(side, empty)])
            for side in _SIDES}

        # a one-sided moves-only batch keeps the counterpart view frozen
        # across the splice, so the delta can come from ONE fused
        # before/after pass (_delta_matches_moved) instead of two full
        # match-set scans; the per-region loop impl stays two-phase as
        # the cross-checked reference
        moved_sides = [s for s in _SIDES
                       if moves.get(s) is not None and moves[s][0].size]
        fused_side = None
        if (want_delta and self.delta_impl != "loop"
                and len(moved_sides) == 1
                and not any(r.size for r in removes.values())
                and not any(g is not None and g[0].size
                            for g in adds.values())):
            fused_side = moved_sides[0]
            fused_old_lo = self._lo[fused_side][:, moves[fused_side][0]].copy()
            fused_old_hi = self._hi[fused_side][:, moves[fused_side][0]].copy()

        # pairs the changed regions participate in *before* the batch —
        # the packed live-extent cache serves the counterpart reads, so a
        # one-sided batch never gathers (or even scans) its own side
        old_pairs: Set[Tuple[int, int]] = set()
        if want_delta and fused_side is None:
            for side in _SIDES:
                if changed_old[side].size:
                    old_pairs |= self._changed_matches(
                        side, changed_old[side])

        # splice the delta into the persistent stream + dense stores
        t0 = time.perf_counter()
        touched = self._delete_records_grouped(changed_old)
        for side, rids in removes.items():
            self._live[side][rids] = False
            self._lo[side][:, rids] = np.inf
            self._hi[side][:, rids] = -np.inf
            if rids.size:
                self._pack[side] = None       # liveness changed
        inserts = {}
        n_changed = 0
        for side in _SIDES:
            parts = [g for g in (moves.get(side), adds.get(side))
                     if g is not None and g[0].size]
            if not parts:
                continue
            rids = np.concatenate([p[0] for p in parts])
            lo = np.concatenate([p[1] for p in parts], axis=1)
            hi = np.concatenate([p[2] for p in parts], axis=1)
            self._ensure_capacity(side, int(rids.max()))
            self._lo[side][:, rids] = lo
            self._hi[side][:, rids] = hi
            self._live[side][rids] = True
            inserts[side] = (rids, lo, hi)
            if adds.get(side) is not None and adds[side][0].size:
                self._pack[side] = None       # liveness changed
            elif self._pack[side] is not None:
                # moves only: patch the b changed columns in place —
                # the packed view stays warm across move-heavy churn
                cols = self._pack[side][1][rids]
                self._pack[side][2][:, cols] = lo
                self._pack[side][3][:, cols] = hi
            n_changed += int(rids.size)
        touched += self._insert_records_grouped(inserts)
        self._prep = [None] * self.dims
        self._cand_counts = [None] * self.dims
        splice_stats = runtime_lib.MatchStats(
            engine="incremental_splice", regime=self.index_impl,
            count=n_changed + sum(int(r.size) for r in removes.values()),
            blocks_touched=touched)
        splice_stats.add_phase("splice", time.perf_counter() - t0)
        self.last_batch_stats = splice_stats
        self.recorder.record(splice_stats)

        if fused_side is not None:
            rids, lo, hi = moves[fused_side]
            added, removed = self._delta_matches_moved(
                fused_side, np.asarray(rids, np.int64),
                fused_old_lo, fused_old_hi, lo, hi)
            return BatchDelta(added=added, removed=removed)

        # pairs the changed regions participate in *after* the batch; a
        # moves-only counterpart side kept its packed view (patched in
        # place above), so no side is re-scanned between the two phases
        new_pairs: Set[Tuple[int, int]] = set()
        if want_delta:
            for side, (rids, _, _) in inserts.items():
                new_pairs |= self._changed_matches(side, rids)
        return BatchDelta(added=new_pairs - old_pairs,
                          removed=old_pairs - new_pairs)

    def _changed_matches(self, side: str,
                         rids: np.ndarray) -> Set[Tuple[int, int]]:
        """Match sets of changed rids vs live counterparts, impl-dispatched."""
        if self.delta_impl == "loop":
            t0 = time.perf_counter()
            out: Set[Tuple[int, int]] = set()
            for rid in rids.tolist():
                out |= self._matches_of(side, rid)
            # same observability contract as the stacked paths: every
            # rematch phase is a MatchStats, whichever impl ran it
            stats = runtime_lib.MatchStats(
                engine="incremental_bulk", regime="loop",
                count=len(out), capacity=len(out), attempts=[len(out)])
            stats.add_phase("rematch", time.perf_counter() - t0)
            self.recorder.record(stats)
            return out
        return self._matches_of_many(side, rids)

    # -- stream surgery ----------------------------------------------------
    def _delete_records_grouped(self, by_side) -> int:
        """Drop the changed rids' endpoint records; returns blocks touched.

        Must run *before* the dense stores are wiped — the stores still
        hold the old bounds, which the blocked backend routes through its
        directory to probe only owning blocks.
        """
        if not any(r.size for r in by_side.values()):
            return 0
        # one common size — the owner column is gathered through both masks
        size = max(self._live[s].shape[0] for s in _SIDES)
        drop = {s: np.zeros(size, bool) for s in _SIDES}
        del_lo, del_hi = [], []
        for side, rids in by_side.items():
            if rids.size:
                drop[side][rids] = True
                del_lo.append(self._lo[side][:, rids])
                del_hi.append(self._hi[side][:, rids])
        vals = np.concatenate(del_lo + del_hi, axis=1)   # (d, 2b) old bounds
        touched = 0
        for d in range(self.dims):
            touched += self._streams[d].delete_batch(
                drop[SUB], drop[UPD], vals[d])
        return touched

    def _insert_records_grouped(self, inserts) -> int:
        """Splice side-grouped ``(rids, lo, hi)`` blocks — no per-entry
        loop.  Returns blocks touched across dimensions."""
        if not inserts:
            return 0
        rids = np.concatenate([g[0] for g in inserts.values()])
        lo = np.concatenate([g[1] for g in inserts.values()], axis=1)
        hi = np.concatenate([g[2] for g in inserts.values()], axis=1)
        is_sub = np.concatenate([
            np.full(g[0].shape[0], side == SUB)
            for side, g in inserts.items()])
        b = rids.shape[0]
        if b == 0:
            return 0
        up0 = np.zeros(2 * b, bool)
        up0[b:] = True
        sub0 = np.concatenate([is_sub, is_sub])
        own0 = np.concatenate([rids, rids]).astype(np.int32)
        touched = 0
        for d in range(self.dims):
            vals = np.concatenate([lo[d], hi[d]]).astype(np.float32)
            order = np.lexsort((up0, vals))            # O(b·log b) — delta only
            # (value, upper) presorted delta: the backend's splice keeps
            # the lowers-before-uppers tie-break (lower merges side='left',
            # upper side='right' against equal stream values)
            touched += self._streams[d].insert_batch(
                vals[order], up0[order], sub0[order], own0[order])
        return touched

    # -- rank tables + per-region match sets -------------------------------
    def _prep_tables(self, dim: int = 0) -> _Prep:
        if self._prep[dim] is not None:
            return self._prep[dim]
        t0 = time.perf_counter()
        cap_s = self._live[SUB].shape[0]
        cap_u = self._live[UPD].shape[0]
        # the stream backend owns table construction: one whole-stream
        # cumsum pass (flat) or per-block cached locals + prefix-offset
        # assembly, recomputing only dirty blocks (blocked, DESIGN.md §13)
        rt = self._streams[dim].rank_tables(cap_s, cap_u)
        self._prep[dim] = _Prep(
            subs_by_lo=rt.subs_by_lo, upds_by_lo=rt.upds_by_lo,
            a_start=rt.a_start, a_end=rt.a_end,
            b_start=rt.b_start, b_end=rt.b_end,
            live_s=self.live_ids(SUB), live_u=self.live_ids(UPD))
        stats = runtime_lib.MatchStats(
            engine="incremental_prep", regime=self.index_impl,
            count=int(rt.subs_by_lo.size + rt.upds_by_lo.size),
            blocks_touched=rt.patched_blocks)
        stats.add_phase("rank_patch", time.perf_counter() - t0)
        self.recorder.record(stats)
        return self._prep[dim]

    def _candidate_count(self, prep: _Prep) -> int:
        """1-d match count of one dimension, read off its rank tables.

        Class-A plus class-B range lengths over live ids sum to exactly
        that projection's K — an O(n + m) selectivity probe, the
        incremental analogue of the reference's per-dimension counts.
        """
        return int(
            (prep.a_end[prep.live_s] - prep.a_start[prep.live_s]).sum()
            + (prep.b_end[prep.live_u] - prep.b_start[prep.live_u]).sum())

    def select_dimension(self) -> int:
        """The most selective candidate-generator dimension (DESIGN.md §8).

        Per-dim candidate counts are cached alongside the prep tables and
        invalidated per batch — back-to-back queries between flushes pay
        the selectivity probe once.
        """
        for d in range(self.dims):
            if self._cand_counts[d] is None:
                self._cand_counts[d] = self._candidate_count(
                    self._prep_tables(d))
        return min(range(self.dims), key=lambda d: self._cand_counts[d])

    def _matches_of(self, side: str, rid: int) -> Set[Tuple[int, int]]:
        """One region's match set — the rank-table query degenerated.

        For a *single* extent the rank-table emission restricted to it is
        the union of its class-A range (counterparts opening inside its
        position interval) and the class-B stab (counterparts whose range
        contains its lower rank) — and that union is exactly the
        closed-interval overlap set, a pure value comparison.  So the
        per-region query needs no position tables at all: one vectorized
        ``lo <= q_hi ∧ hi >= q_lo`` over live counterparts *per dimension*
        (the delta-rematch filter on the other dims), O(d·m) with a tiny
        constant and — unlike the O(n+m) table rebuild — independent of
        this side's size.  The full table form lives on in
        :meth:`all_pairs`, where the position-space partition is what
        makes whole-world emission O(K).  Counterpart extents come from
        the packed live view (:meth:`_live_pack`) — no per-query
        gather."""
        other = UPD if side == SUB else SUB
        lv, _, p_lo, p_hi = self._live_pack(other)
        if lv.size == 0:
            return set()
        q_lo, q_hi = self._lo[side][:, rid], self._hi[side][:, rid]
        hit = np.ones(lv.size, bool)
        for d in range(self.dims):
            hit &= (p_lo[d] <= q_hi[d]) & (p_hi[d] >= q_lo[d])
        cand = lv[hit]
        if side == SUB:
            return {(rid, int(j)) for j in cand}
        return {(int(i), rid) for i in cand}

    def _matches_of_many(self, side: str,
                         rids: np.ndarray) -> Set[Tuple[int, int]]:
        """The stacked form of :meth:`_matches_of`: match sets of b changed
        regions in ONE vectorized pass instead of b O(m) passes.

        Gathers the changed extents into a ``(d, b)`` block and reads the
        live counterparts off the packed ``(d, m)`` view — under
        move-only churn that view is patched in place, so a flush pays
        NO O(m) gather at all — then delegates to
        :func:`_bulk_overlap_pairs`, which picks dense-mask / fused device mask /
        sort-based by b·m.  Output is the union of the b per-region
        match sets, as ``(sub_rid, upd_rid)`` pairs.
        """
        other = UPD if side == SUB else SUB
        lv, _, p_lo, p_hi = self._live_pack(other)
        rids = np.asarray(rids, np.int64)
        if lv.size == 0 or rids.size == 0:
            return set()
        t0 = time.perf_counter()
        qi, cj, regime = _bulk_overlap_pairs(
            self._lo[side][:, rids], self._hi[side][:, rids],
            p_lo, p_hi, self.regime_policy, self.device)
        stats = runtime_lib.MatchStats(
            engine="incremental_bulk", regime=regime, count=int(qi.size),
            capacity=int(qi.size), attempts=[int(qi.size)])
        stats.add_phase("rematch", time.perf_counter() - t0)
        self.recorder.record(stats)
        qs, cs = rids[qi], lv[cj]
        if side == SUB:
            return set(zip(qs.tolist(), cs.tolist()))
        return set(zip(cs.tolist(), qs.tolist()))

    def _delta_matches_moved(self, side: str, rids: np.ndarray,
                             old_lo: np.ndarray, old_hi: np.ndarray,
                             new_lo: np.ndarray, new_hi: np.ndarray
                             ) -> Tuple[Set[Tuple[int, int]],
                                        Set[Tuple[int, int]]]:
        """(added, removed) pair sets of a one-sided moves-only batch.

        The two-phase delta (full before-set, full after-set, set
        difference) scans the b×m lattice twice and materializes every
        unchanged pair just to cancel it.  When a batch only *moves*
        regions on one side, the counterpart view is identical before and
        after the splice, so the changed pairs can be read off one fused
        pass: overlap(old) xor overlap(new), with membership in the new
        mask telling added from removed.  Regimes mirror
        :func:`_bulk_overlap_pairs` — boolean masks (dense), one fused
        kernel emitting per-chunk flip flags so the host recomputes only
        chunks that changed (device), or two output-sensitive candidate
        joins (sort, where the lattice is never materialized anyway).
        """
        other = UPD if side == SUB else SUB
        lv, _, p_lo, p_hi = self._live_pack(other)
        b, m = int(rids.size), int(lv.size)
        if b == 0 or m == 0:
            return set(), set()
        t0 = time.perf_counter()
        regime = runtime_lib.select_bulk_regime(b, m, self.regime_policy)
        if regime == "sort":
            qi_o, cj_o = _sorted_overlap_pairs(old_lo, old_hi, p_lo, p_hi)
            qi_n, cj_n = _sorted_overlap_pairs(new_lo, new_hi, p_lo, p_hi)
            was = set(zip(qi_o.tolist(), cj_o.tolist()))
            now = set(zip(qi_n.tolist(), cj_n.tolist()))
            add_pairs = now - was
            rem_pairs = was - now
            qi_a = np.fromiter((p[0] for p in add_pairs), np.int64,
                               len(add_pairs))
            cj_a = np.fromiter((p[1] for p in add_pairs), np.int64,
                               len(add_pairs))
            qi_r = np.fromiter((p[0] for p in rem_pairs), np.int64,
                               len(rem_pairs))
            cj_r = np.fromiter((p[1] for p in rem_pairs), np.int64,
                               len(rem_pairs))
        elif regime == "dense":
            was = ((p_lo[0][None, :] <= old_hi[0][:, None]) &
                   (old_lo[0][:, None] <= p_hi[0][None, :]))
            now = ((p_lo[0][None, :] <= new_hi[0][:, None]) &
                   (new_lo[0][:, None] <= p_hi[0][None, :]))
            for d in range(1, self.dims):
                was &= ((p_lo[d][None, :] <= old_hi[d][:, None]) &
                        (old_lo[d][:, None] <= p_hi[d][None, :]))
                now &= ((p_lo[d][None, :] <= new_hi[d][:, None]) &
                        (new_lo[d][:, None] <= p_hi[d][None, :]))
            flat = np.flatnonzero(was ^ now)
            grew = now.ravel()[flat]          # True → added, False → removed
            qi, cj = np.divmod(flat, m)
            qi_a, cj_a = qi[grew], cj[grew]
            qi_r, cj_r = qi[~grew], cj[~grew]
        else:
            bp, mp = _round_up_pow2(b), _round_up_pow2(m)
            cl_pad = _pad_cols(p_lo, mp, np.inf)
            ch_pad = _pad_cols(p_hi, mp, -np.inf)
            flags = _fused_delta_flags(
                _pad_cols(old_lo, bp, np.inf), _pad_cols(old_hi, bp, -np.inf),
                _pad_cols(new_lo, bp, np.inf), _pad_cols(new_hi, bp, -np.inf),
                cl_pad, ch_pad, self.device)
            ck = mp // flags.shape[1]
            ri, ki = np.nonzero(flags)
            # recompute only the flipped chunks on the host: each flag
            # covers (moved region ri, counterpart columns [ki*ck, +ck)),
            # so the numpy re-evaluation touches ~hits·CH cells, not b·m
            col0 = ki * ck
            gidx = col0[:, None] + np.arange(ck)
            was = np.ones((ri.size, ck), bool)
            now = np.ones((ri.size, ck), bool)
            for d in range(self.dims):
                cl, chh = cl_pad[d][gidx], ch_pad[d][gidx]
                was &= ((cl <= old_hi[d][ri][:, None]) &
                        (old_lo[d][ri][:, None] <= chh))
                now &= ((cl <= new_hi[d][ri][:, None]) &
                        (new_lo[d][ri][:, None] <= chh))
            rr, cc = np.nonzero(was ^ now)
            qi, cj = ri[rr], col0[rr] + cc
            grew = now[rr, cc]
            # same sentinel caveat as the fused mask: filter padded
            # row/column indices explicitly rather than reasoning about
            # which inf-bound combinations can flip
            keep = (qi < b) & (cj < m)
            qi, cj, grew = qi[keep], cj[keep], grew[keep]
            qi_a, cj_a = qi[grew], cj[grew]
            qi_r, cj_r = qi[~grew], cj[~grew]
        stats = runtime_lib.MatchStats(
            engine="incremental_bulk", regime=regime,
            count=int(qi_a.size + qi_r.size),
            capacity=int(qi_a.size + qi_r.size),
            attempts=[int(qi_a.size + qi_r.size)])
        stats.add_phase("rematch", time.perf_counter() - t0)
        self.recorder.record(stats)

        def orient(qs, cs):
            if side == SUB:
                return set(zip(qs.tolist(), cs.tolist()))
            return set(zip(cs.tolist(), qs.tolist()))

        return (orient(rids[qi_a], lv[cj_a]), orient(rids[qi_r], lv[cj_r]))

    # -- full enumeration from the index (no re-sort) ----------------------
    def all_pairs(self) -> Set[Tuple[int, int]]:
        """Every matching ``(sub_rid, upd_rid)`` — O(d·(n + m) + K_gen).

        Candidates come from the most *selective* dimension's rank tables
        (class-A ranges of all live subs plus class-A ranges of all live
        upds — each 1-d pair lands in exactly one); the remaining
        projections are filtered per candidate.  Reading the persistent
        per-dim streams instead of re-sorting keeps the whole query
        emission-bound: K_gen is the generator projection's match count,
        min over dimensions.  Used as the index's own full-query path and
        cross-checked against the stateless device sweep in the tests.
        """
        out: Set[Tuple[int, int]] = set()
        gen = self.select_dimension() if self.dims > 1 else 0
        prep = self._prep_tables(gen)
        ls, lu = prep.live_s, prep.live_u
        if ls.size == 0 or lu.size == 0:
            return out
        jj, src = _ragged_gather(prep.a_start[ls],
                                 prep.a_end[ls] - prep.a_start[ls],
                                 prep.upds_by_lo)
        ii = ls[src]
        i2, src2 = _ragged_gather(prep.b_start[lu],
                                  prep.b_end[lu] - prep.b_start[lu],
                                  prep.subs_by_lo)
        j2 = lu[src2]
        ii = np.concatenate([ii, i2])
        jj = np.concatenate([jj, j2])
        if self.dims > 1 and ii.size:
            keep = np.ones(ii.size, bool)
            for d in range(self.dims):
                if d == gen:
                    continue
                keep &= ((self._lo[SUB][d, ii] <= self._hi[UPD][d, jj]) &
                         (self._lo[UPD][d, jj] <= self._hi[SUB][d, ii]))
            ii, jj = ii[keep], jj[keep]
        return set(zip(ii.tolist(), jj.tolist()))
