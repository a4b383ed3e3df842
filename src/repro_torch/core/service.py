"""DDM service — the HLA-style Data Distribution Management facade.

Stateful register/modify/unregister of subscription and update regions,
matching, and event routing — the service the paper's algorithm exists to
accelerate.  Region mutations are buffered and applied as one batch to a
persistent :class:`repro_torch.core.incremental.IncrementalIndex`: the
sorted endpoint stream survives across queries, each batch of ``b`` changes
sorts only its own 2·b delta endpoints, and :meth:`flush` reports exactly
the match pairs the batch created and destroyed.  ``all_pairs`` /
``match_count`` read a cached match state that the per-batch deltas keep
current.

The region tables grow by amortized doubling — ``capacity`` is an initial
allocation, never a ceiling — and every mutation has a block form.

The stateless sweep is the rebuild path: :meth:`match_count` runs the
counting sweep (passes A and B of :mod:`repro_torch.kernels.sbm_sweep`) and
the rebuild in :meth:`_planned_sweep` runs the kernel pair enumeration
(passes A and B, the delta-bitmask pass and pass C) under the runtime's
count-then-retry executor.  For ``dims > 1`` both run the
selective-dimension sweep of :mod:`repro_torch.core.ddim` on the same
kernels: the counting sweep probes every projection, the most selective
one generates candidates and the other projections filter them.  On a CUDA
``device`` those are the hand-written kernels; on ``device="cpu"`` the same
calls take the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import ddim as ddim_lib
from repro_torch.core import incremental as incr_lib
from repro_torch.core import runtime as runtime_lib
from repro_torch.core.errors import ValidationError
from repro_torch.core.incremental import SUB, UPD, BatchDelta, IncrementalIndex
from repro_torch.core.intervals import Extents
from repro_torch.kernels import ops as kernel_ops

# accepted spellings of the side argument of the unified mutation API
# (register/move/unregister) — canonicalized to the SUB/UPD constants
_SIDE_ALIASES = {SUB: SUB, UPD: UPD, "subscription": SUB, "update": UPD}


def _canon_side(side: str) -> str:
    try:
        return _SIDE_ALIASES[side]
    except (KeyError, TypeError):
        raise ValidationError(
            f"unknown side {side!r}: expected 'sub'/'subscription' or "
            "'upd'/'update'") from None


@dataclasses.dataclass
class _RegionTable:
    lo: np.ndarray   # (d, capacity)
    hi: np.ndarray
    live: np.ndarray  # (capacity,) bool
    free: List[int]

    @classmethod
    def create(cls, d: int, capacity: int) -> "_RegionTable":
        # Dead slots are [+inf, -inf]: inert for every matcher — any
        # closed-interval overlap test against them is False.  Capacity is
        # clamped to >= 1 (like IncrementalIndex) so the doubling in
        # _grow always advances.
        capacity = max(int(capacity), 1)
        return cls(
            lo=np.full((d, capacity), np.inf, np.float32),
            hi=np.full((d, capacity), -np.inf, np.float32),
            live=np.zeros((capacity,), bool),
            free=list(range(capacity - 1, -1, -1)),
        )

    def _validated(self, lo: Sequence[float], hi: Sequence[float]):
        """The service-boundary region check (the sweep precondition).

        Accepting ``lo > hi`` or wrong-length bounds here used to silently
        violate the ``compact`` contract ("lo <= hi") and return wrong
        counts; now both raise ``ValueError`` before any state changes.
        NaNs fail the ``lo <= hi`` comparison and are rejected too.
        Delegates to the incremental engine's :func:`_as_bounds` so the
        two layers enforce one contract.
        """
        return incr_lib._as_bounds(self.lo.shape[0], lo, hi)

    def _validated_block(self, lo, hi, rids=None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Validate a ``(b, d)`` (or ``(b,)`` for d=1) bounds block; return
        the ``(d, b)`` store layout.  One comparison pass for the block —
        the bulk form of :meth:`_validated`, delegating to the incremental
        engine's :func:`_as_bounds_block` (one contract, both layers).
        ``rids``, when known, lets the error name the offending region, not
        just its row index."""
        return incr_lib._as_bounds_block(self.lo.shape[0], lo, hi, rids=rids)

    def _grow(self, min_capacity: int) -> None:
        """Amortized doubling, like ``IncrementalIndex._ensure_capacity`` —
        registration volume must never hit a fixed ceiling."""
        cap = self.live.shape[0]
        if min_capacity <= cap:
            return
        new = cap
        while new < min_capacity:
            new *= 2
        for name, fill in (("lo", np.inf), ("hi", -np.inf)):
            grown = np.full((self.lo.shape[0], new), fill, np.float32)
            grown[:, :cap] = getattr(self, name)
            setattr(self, name, grown)
        live = np.zeros(new, bool)
        live[:cap] = self.live
        self.live = live
        # fresh slots pop *after* the existing free ids (list pops tail-first)
        self.free = list(range(new - 1, cap - 1, -1)) + self.free

    def insert(self, lo: Sequence[float], hi: Sequence[float]) -> int:
        lo, hi = self._validated(lo, hi)
        if not self.free:
            self._grow(2 * self.live.shape[0])
        rid = self.free.pop()
        self.lo[:, rid] = lo
        self.hi[:, rid] = hi
        self.live[rid] = True
        return rid

    def insert_many(self, lo, hi) -> np.ndarray:
        """Insert b regions from a ``(b, d)`` block; return their rids."""
        lo, hi = self._validated_block(lo, hi)
        b = lo.shape[1]
        if b == 0:
            return np.zeros(0, np.int64)
        if len(self.free) < b:
            self._grow(int(self.live.sum()) + b)
        rids = np.asarray(self.free[-b:][::-1], np.int64)  # == b tail pops
        del self.free[-b:]
        self.lo[:, rids] = lo
        self.hi[:, rids] = hi
        self.live[rids] = True
        return rids

    def remove(self, rid: int) -> None:
        if not self.live[rid]:
            raise KeyError(f"region {rid} not registered")
        self.live[rid] = False
        self.lo[:, rid] = np.inf
        self.hi[:, rid] = -np.inf
        self.free.append(rid)

    def remove_many(self, rids) -> np.ndarray:
        rids = self._validated_live(rids, unique=True)
        self.live[rids] = False
        self.lo[:, rids] = np.inf
        self.hi[:, rids] = -np.inf
        self.free.extend(rids.tolist())
        return rids

    def move(self, rid: int, lo: Sequence[float], hi: Sequence[float]) -> None:
        lo, hi = incr_lib._as_bounds(self.lo.shape[0], lo, hi, rid=rid)
        if not self.live[rid]:
            raise KeyError(f"region {rid} not registered")
        self.lo[:, rid] = lo
        self.hi[:, rid] = hi

    def move_many(self, rids, lo, hi) -> np.ndarray:
        # rids first: a malformed-bounds error can then name the rid it
        # belongs to instead of only the row index
        rids = self._validated_live(rids, unique=True)
        lo, hi = self._validated_block(lo, hi, rids=rids)
        if rids.shape[0] != lo.shape[1]:
            raise ValidationError(f"{rids.shape[0]} rids but bounds for "
                             f"{lo.shape[1]} regions")
        self.lo[:, rids] = lo
        self.hi[:, rids] = hi
        return rids

    def _validated_live(self, rids, *, unique: bool) -> np.ndarray:
        rids = np.atleast_1d(np.asarray(rids, np.int64))
        if rids.size == 0:
            return rids
        bad = rids[(rids < 0) | (rids >= self.live.shape[0])
                   | ~self.live[np.clip(rids, 0, self.live.shape[0] - 1)]]
        if bad.size:
            raise KeyError(f"region {int(bad[0])} not registered")
        if unique and np.unique(rids).size != rids.size:
            vals, counts = np.unique(rids, return_counts=True)
            raise ValidationError(
                f"region {int(vals[counts > 1][0])} repeated in one bulk call")
        return rids

    def live_ids(self) -> np.ndarray:
        return np.nonzero(self.live)[0]

    def compact(self, ids: np.ndarray, device) -> Extents:
        """Live extents only (the sweep precondition: lo <= hi), as tensors
        on ``device``: ``(n,)`` for d = 1, ``(d, n)`` for d > 1."""
        rows = 0 if self.lo.shape[0] == 1 else slice(None)
        return Extents(torch.from_numpy(self.lo[rows, ids]).to(device),
                       torch.from_numpy(self.hi[rows, ids]).to(device))


class DDMService:
    """Data Distribution Management service backed by parallel SBM.

    >>> svc = DDMService(capacity=1024, device="cpu")
    >>> s = svc.register("sub", 0.0, 10.0)
    >>> u = svc.register("upd", 5.0, 20.0)
    >>> svc.matches_for_update(u)
    [0]

    Mutations are buffered per region and applied as one incremental-index
    batch at the next full-match query (or an explicit :meth:`flush`, which
    also returns the exact pair delta).  Single-region queries
    (``matches_for_update`` etc.) read the region tables directly and are
    always current.
    """

    def __init__(self, dims: int = 1, capacity: int = 4096,
                 delta_impl: str = "vector",
                 policy: Optional[runtime_lib.CapacityPolicy] = None,
                 regime_policy: Optional[
                     runtime_lib.BulkRegimePolicy] = None,
                 index_impl: str = "blocked",
                 block_target: Optional[int] = None,
                 device="cuda"):
        self.dims = dims
        # where the sweeps run: "cuda" launches the hand-written kernels,
        # "cpu" their plain PyTorch versions
        self.device = torch.device(device)
        self._subs = _RegionTable.create(dims, capacity)
        self._upds = _RegionTable.create(dims, capacity)
        # one recorder for the whole service: rebuild sweeps and the
        # index's bulk rematches land in the same stats() stream
        self._recorder = runtime_lib.StatsRecorder()
        self._policy = policy or runtime_lib.DEFAULT_POLICY
        # index_impl/block_target select the endpoint-stream backend
        # (blocked √n surgery vs legacy flat splice — DESIGN.md §13) and
        # flow through the broker's service_kwargs untouched
        self._index = IncrementalIndex(dims=dims, capacity=capacity,
                                       delta_impl=delta_impl,
                                       regime_policy=regime_policy,
                                       recorder=self._recorder,
                                       index_impl=index_impl,
                                       block_target=block_target,
                                       device=self.device)
        # pending[(side, rid)] ∈ {"add", "move", "remove"} — composed so a
        # rid reaches the index at most once per batch
        self._pending: Dict[Tuple[str, int], str] = {}
        self._match_cache: Optional[Set[Tuple[int, int]]] = None

    def stats(self) -> Dict[str, object]:
        """Execution-runtime observability snapshot (DESIGN.md §10).

        Aggregated :class:`repro_torch.core.runtime.MatchStats` over every
        planned matching call the service issued — rebuild sweeps,
        count queries and the incremental index's bulk rematches share
        one recorder.  Keys: ``calls``, ``retries``, ``recompiles``,
        ``by_engine``, ``by_regime`` and ``last`` (the most recent
        call's full per-phase record).
        """
        return self._recorder.snapshot()

    @property
    def recorder(self) -> runtime_lib.StatsRecorder:
        """The live :class:`StatsRecorder` behind :meth:`stats`."""
        return self._recorder

    def _table(self, side: str) -> _RegionTable:
        return self._subs if side == SUB else self._upds

    def _queue(self, side: str, rid: int, op: str) -> None:
        """Compose a new mutation onto the pending batch entry for rid."""
        key = (side, rid)
        prev = self._pending.get(key)
        if prev is None:
            self._pending[key] = op
        elif prev == "add":
            if op == "remove":
                del self._pending[key]       # add then remove: net no-op
            # add then move: still an add (with the latest bounds)
        elif prev == "move":
            if op == "add":
                # Reachable only if the table invariant broke (a live rid
                # re-inserted without an intervening remove).  This used to
                # be silently composed to "remove" — losing the region.
                raise ValidationError(
                    f"{side} region {rid}: 'add' composed onto a pending "
                    "'move' — the table must free a rid before re-insert")
            self._pending[key] = op          # move∘move=move, move∘remove=remove
        else:  # prev == "remove" — the slot was freed and re-inserted
            if op != "add":
                raise ValidationError(
                    f"{side} region {rid}: {op!r} composed onto a pending "
                    "'remove' — only a re-insert may follow a remove")
            self._pending[key] = "move"      # net effect: extent replaced

    # -- the unified mutation surface (repro_torch.api) ----------
    # One verb per operation, side-parameterized, scalar-or-block by input
    # shape.  A single region's bounds are a scalar (d = 1) or a length-d
    # sequence; a block is a (b,) array (d = 1) or a (b, d) array — for
    # d = 1 any 1-D bounds input is a block (a block of one returns a
    # length-1 rid array).  Moves/unregisters dispatch on ``rids``: a
    # scalar int is one region, an int array a block.  Blocks ride the
    # vectorized bulk path (one Python call per batch, elastic tables, one
    # stacked rematch at the next flush).
    def register(self, side: str, lo, hi) -> Union[int, np.ndarray]:
        """Register one region (returns its rid) or a ``(b, d)`` block
        (returns the length-b rid array) on ``side``."""
        side = _canon_side(side)
        table = self._table(side)
        if self._is_block_bounds(lo):
            rids = table.insert_many(lo, hi)
            self._queue_many(side, rids, "add")
            return rids
        rid = table.insert(lo, hi)
        self._queue(side, rid, "add")
        return rid

    def move(self, side: str, rids, lo, hi) -> None:
        """Move one region (``rids`` a scalar int) or a block (``rids`` an
        int array, bounds ``(b, d)``) to new bounds — dynamic DDM (Pan et
        al. [20]): the slot is overwritten and joins the pending batch;
        the next flush rematches only the delta."""
        side = _canon_side(side)
        table = self._table(side)
        if np.ndim(rids) == 0:
            table.move(int(rids), lo, hi)
            self._queue(side, int(rids), "move")
        else:
            r = table.move_many(rids, lo, hi)
            self._queue_many(side, r, "move")

    def unregister(self, side: str, rids) -> None:
        """Unregister one region (scalar ``rids``) or a block (int array).
        Dead slots become inert ``[+inf, -inf]`` sentinels."""
        side = _canon_side(side)
        table = self._table(side)
        if np.ndim(rids) == 0:
            table.remove(int(rids))
            self._queue(side, int(rids), "remove")
        else:
            r = table.remove_many(rids)
            self._queue_many(side, r, "remove")

    def _is_block_bounds(self, lo) -> bool:
        """Shape rule of the scalar-or-block dispatch (see above)."""
        nd = np.ndim(lo)
        return nd >= 2 or (nd == 1 and self.dims == 1)

    # -- deprecated per-side mutation spellings ---------------------------
    # The historical surface: 12 per-side/per-arity methods, kept as thin
    # wrappers over the same internals so behavior (rid assignment,
    # validation errors, pending composition) is bit-identical, each
    # emitting a DeprecationWarning naming its one-line replacement.
    # They will be removed once internal callers are gone; new code uses
    # the unified register/move/unregister via repro_torch.api.
    @staticmethod
    def _warn_deprecated(old: str, new: str) -> None:
        warnings.warn(
            f"DDMService.{old} is deprecated; use DDMService.{new} "
            "(the unified surface exported by repro_torch.api)",
            DeprecationWarning, stacklevel=3)

    def register_subscription(self, lo, hi) -> int:
        self._warn_deprecated("register_subscription",
                              "register('sub', lo, hi)")
        rid = self._subs.insert(lo, hi)
        self._queue(SUB, rid, "add")
        return rid

    def register_update(self, lo, hi) -> int:
        self._warn_deprecated("register_update", "register('upd', lo, hi)")
        rid = self._upds.insert(lo, hi)
        self._queue(UPD, rid, "add")
        return rid

    def unregister_subscription(self, rid: int) -> None:
        self._warn_deprecated("unregister_subscription",
                              "unregister('sub', rid)")
        self._subs.remove(rid)   # dead slots are inert sentinels
        self._queue(SUB, rid, "remove")

    def unregister_update(self, rid: int) -> None:
        self._warn_deprecated("unregister_update", "unregister('upd', rid)")
        self._upds.remove(rid)
        self._queue(UPD, rid, "remove")

    def move_subscription(self, rid: int, lo, hi) -> None:
        self._warn_deprecated("move_subscription",
                              "move('sub', rid, lo, hi)")
        self._subs.move(rid, lo, hi)
        self._queue(SUB, rid, "move")

    def move_update(self, rid: int, lo, hi) -> None:
        self._warn_deprecated("move_update", "move('upd', rid, lo, hi)")
        self._upds.move(rid, lo, hi)
        self._queue(UPD, rid, "move")

    # -- bulk mutations -----------------------------------------------------
    # One call per *batch*, not per region: bounds arrive as (b, d) blocks
    # ((b,) for d=1), rids as int arrays, and the tables grow elastically —
    # registration volume never hits a capacity ceiling.  The next flush
    # rematches the whole block in one stacked vectorized pass.
    def _queue_many(self, side: str, rids: np.ndarray, op: str) -> None:
        pend = self._pending
        if not pend:                          # bulk fast path: nothing to
            pend.update(((side, int(r)), op) for r in rids)   # compose against
            return
        # Compose only rids that already have a pending entry (rare: freed-
        # rid reuse within one batch); everything else is a plain dict store
        # — back-to-back bulk calls stay O(b) dict ops, not O(b) _queue calls.
        queue = self._queue
        for r in rids.tolist():
            if (side, r) in pend:
                queue(side, r, op)
            else:
                pend[(side, r)] = op

    def register_subscriptions(self, lo, hi) -> np.ndarray:
        """Deprecated: :meth:`register` with block-shaped bounds."""
        self._warn_deprecated("register_subscriptions",
                              "register('sub', lo, hi)")
        rids = self._subs.insert_many(lo, hi)
        self._queue_many(SUB, rids, "add")
        return rids

    def register_updates(self, lo, hi) -> np.ndarray:
        self._warn_deprecated("register_updates", "register('upd', lo, hi)")
        rids = self._upds.insert_many(lo, hi)
        self._queue_many(UPD, rids, "add")
        return rids

    def move_subscriptions(self, rids, lo, hi) -> None:
        self._warn_deprecated("move_subscriptions",
                              "move('sub', rids, lo, hi)")
        rids = self._subs.move_many(rids, lo, hi)
        self._queue_many(SUB, rids, "move")

    def move_updates(self, rids, lo, hi) -> None:
        self._warn_deprecated("move_updates", "move('upd', rids, lo, hi)")
        rids = self._upds.move_many(rids, lo, hi)
        self._queue_many(UPD, rids, "move")

    def unregister_subscriptions(self, rids) -> None:
        self._warn_deprecated("unregister_subscriptions",
                              "unregister('sub', rids)")
        rids = self._subs.remove_many(rids)
        self._queue_many(SUB, rids, "remove")

    def unregister_updates(self, rids) -> None:
        self._warn_deprecated("unregister_updates", "unregister('upd', rids)")
        rids = self._upds.remove_many(rids)
        self._queue_many(UPD, rids, "remove")

    # -- the incremental engine -------------------------------------------
    def flush(self) -> BatchDelta:
        """Apply pending mutations as ONE index batch; return the delta.

        The returned :class:`BatchDelta` holds exactly the (sub rid, upd
        rid) pairs the batch created (``added``) and destroyed
        (``removed``) — the DDM notification set a federation needs after a
        round of moves — at O(b·log b + n + m) index maintenance plus ONE
        stacked vectorized rematch over all changed regions (output
        O(K_changed); dense mask / fused device mask / sort-based by b·m).
        When most of
        the world changed, :meth:`invalidate_cache` first is still
        cheaper: with no cached match state a plain query skips delta
        computation and rebuilds once via the stateless sweep.
        """
        return self._flush(want_delta=True)

    def invalidate_cache(self) -> None:
        """Drop the cached match state — the bulk-batch fallback.

        After this, pending/future mutations are applied as index-only
        maintenance (no per-region delta rematch) and the next
        ``all_pairs`` rebuilds the cache once with the stateless sweep —
        cheaper than delta rematching when a large fraction of the world
        changed.
        """
        self._match_cache = None

    def _flush(self, want_delta: bool) -> BatchDelta:
        if not self._pending:
            return BatchDelta(set(), set())
        # Build the index batch as side-grouped rid arrays + ONE fancy-index
        # gather per group out of the live tables — no per-region tuple
        # copies, no Python call per region on the way into the index.
        rid_lists: Dict[Tuple[str, str], List[int]] = {}
        for (side, rid), op in self._pending.items():
            rid_lists.setdefault((side, op), []).append(rid)
        self._pending.clear()
        adds: Dict[str, tuple] = {}
        moves: Dict[str, tuple] = {}
        removes: Dict[str, np.ndarray] = {}
        for side in (SUB, UPD):
            t = self._table(side)
            for op, dest in (("add", adds), ("move", moves)):
                rids = rid_lists.get((side, op))
                if rids:
                    r = np.asarray(rids, np.int64)
                    # .T: the index's (b, d) contract over the (d, b) store
                    dest[side] = (r, t.lo[:, r].T, t.hi[:, r].T)
            rids = rid_lists.get((side, "remove"))
            if rids:
                removes[side] = np.asarray(rids, np.int64)
        delta = self._index.apply_batch_arrays(
            adds=adds, moves=moves, removes=removes,
            want_delta=want_delta or self._match_cache is not None)
        if self._match_cache is not None:
            self._match_cache -= delta.removed
            self._match_cache |= delta.added
        return delta

    # -- matching ----------------------------------------------------------
    def _rebuild_pairs(self) -> Set[Tuple[int, int]]:
        """The stateless full sweep — rebuild path and incremental oracle."""
        sl = self._subs.live_ids()
        ul = self._upds.live_ids()
        if sl.size == 0 or ul.size == 0:
            return set()
        ii, jj, _ = self._sweep_pairs(self._subs.compact(sl, self.device),
                                      self._upds.compact(ul, self.device))
        return set(zip(sl[ii].tolist(), ul[jj].tolist()))

    def match_count(self) -> int:
        """K — cached match state when warm, else the SBM counting sweep
        (:func:`repro_torch.kernels.ops.sbm_count_kernel`).

        d > 1 probes every projection with the counting sweep and
        enumerates candidates on the most selective dimension, filtering
        the rest pairwise; only the count leaves the device.
        """
        self._flush(want_delta=False)
        if self._match_cache is not None:
            return len(self._match_cache)
        sl = self._subs.live_ids()
        ul = self._upds.live_ids()
        if sl.size == 0 or ul.size == 0:
            return 0
        subs = self._subs.compact(sl, self.device)
        upds = self._upds.compact(ul, self.device)
        if self.dims == 1:
            return int(kernel_ops.sbm_count_kernel(subs, upds))
        _, count, _ = self._planned_sweep(subs, upds, engine="service_count")
        return int(count)

    def _planned_sweep(self, subs: Extents, upds: Extents, *, engine: str):
        """Probe → plan → emit over compacted live extents, instrumented.

        The probe (the 1-d count, or for d > 1 the generator selection over
        every projection's count) seeds the planner's initial capacity, so
        the executor's retry loop is structurally retry-free.  Stats land in
        the service recorder under ``engine``; d > 1 records the generator
        dimension as the regime.
        """
        t0 = time.perf_counter()
        if self.dims == 1:
            gen, k = 0, int(kernel_ops.sbm_count_kernel(subs, upds))
            regime = "sweep_1d"
        else:
            gen, counts = ddim_lib.select_dimension(
                subs, upds, count_fn=kernel_ops.sbm_count_kernel)
            k = counts[gen]
            regime = f"sweep_dim{gen}"
        probe_s = time.perf_counter() - t0
        if k == 0:
            stats = runtime_lib.MatchStats(engine=engine, regime=regime)
            stats.add_phase("probe", probe_s)
            self._recorder.record(stats)
            return None, 0, stats

        def fn(s, u, *, max_pairs):
            return ddim_lib.enumerate_matches_ddim(
                s, u, max_pairs=max_pairs, method="sweep", generator_dim=gen,
                engine=kernel_ops.sbm_enumerate_kernel)

        return runtime_lib.execute_enumeration(
            fn, subs, upds, estimate=k, policy=self._policy, engine=engine,
            regime=regime, probe_seconds=probe_s, recorder=self._recorder)

    def _sweep_pairs(self, subs: Extents, upds: Extents):
        """(i, j) index pairs over compacted live extents via the sweep."""
        pairs, count, _ = self._planned_sweep(subs, upds,
                                              engine="service_rebuild")
        if pairs is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
        arr = pairs.cpu().numpy()
        arr = arr[arr[:, 0] >= 0]
        return arr[:, 0], arr[:, 1], int(count)

    def all_pairs(self) -> Set[Tuple[int, int]]:
        """Every matching (subscription rid, update rid).

        Served from the delta-maintained cache once warm; the first query
        (or any query after the cache is dropped) rebuilds it with the
        stateless sweep enumeration.  Returns a fresh copy (O(K) — the
        live cache must not alias out); latency-sensitive churn loops
        should consume :meth:`flush`'s delta and :meth:`match_count`
        instead of re-reading the full set each step.
        """
        self._flush(want_delta=False)
        if self._match_cache is None:
            self._match_cache = self._rebuild_pairs()
        return set(self._match_cache)

    def pairs(self) -> Set[Tuple[int, int]]:
        """The facade name for :meth:`all_pairs` (repro_torch.api) — every
        matching ``(subscription rid, update rid)``."""
        return self.all_pairs()

    def _row_matches(self, table: _RegionTable, lo: np.ndarray,
                     hi: np.ndarray) -> List[int]:
        """Live ids of ``table`` whose extents overlap [lo, hi] (one row)."""
        ids = table.live_ids()
        if ids.size == 0:
            return []
        mask = np.ones(ids.size, bool)
        for d in range(self.dims):
            mask &= (table.lo[d, ids] <= hi[d]) & (lo[d] <= table.hi[d, ids])
        return ids[mask].tolist()

    def matches_for_update(self, rid: int) -> List[int]:
        return self._row_matches(self._subs, self._upds.lo[:, rid],
                                 self._upds.hi[:, rid])

    def matches_for_subscription(self, rid: int) -> List[int]:
        return self._row_matches(self._upds, self._subs.lo[:, rid],
                                 self._subs.hi[:, rid])

    # -- routing -----------------------------------------------------------
    def route(self, update_rid: int, payload) -> Dict[int, object]:
        """Deliver ``payload`` from an update region to every matching
        subscription (the DDM send path)."""
        return {sid: payload for sid in self.matches_for_update(update_rid)}
