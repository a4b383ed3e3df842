"""Multi-tenant DDM frontend of the port — the traffic-facing layer.

:class:`repro_torch.core.service.DDMService` is a single-tenant,
single-threaded control-plane object; the production setting is many
client threads mutating many independent DDM worlds.  This module puts a
concurrent broker in front of it without touching the matching engines:

* **Sessions.**  A :class:`Broker` owns N named ``DDMService`` instances,
  each behind its own lock.  Nothing below the broker becomes thread-aware
  — the boundary is here.
* **Coalescing.**  Mutations from any number of producer threads land in a
  per-session FIFO queue as :class:`_Op` records and are applied together
  at the next flush, so concurrency *feeds* the service's vectorized
  batch path (``apply_batch_arrays`` under ``DDMService.flush``).
  Producers get a :class:`Ticket` — a tiny future resolved at the flush
  boundary.  Producer threads touch no tensor: only the flusher and the
  readers call into torch, under the session lock.
* **Admission control.**  Queues are bounded (:class:`AdmissionPolicy`);
  a full queue either blocks the producer until a flush drains (with a
  timeout), rejects with :class:`repro_torch.core.errors.OverloadError`,
  or sheds the oldest queued ops (their tickets fail, the new op is
  admitted).  Per-op deadlines are enforced at flush boundaries: an
  expired op is dropped whole — never partially applied — and its ticket
  resolves to :class:`repro_torch.core.errors.DeadlineExceeded`.
* **Graceful degradation.**  When queue depth or p99 flush latency
  crosses the :class:`DegradePolicy` thresholds, ``match_count`` reads
  stop draining the queue and serve the cheap counting estimate instead
  (1-d: the :func:`repro_torch.core.sweep.probe_count` counting sweep or
  :func:`repro_torch.core.grid.grid_count`; d>1: the selective-dimension
  probe, an upper bound) over the last-applied state, on the session's
  device — tagged ``exact=False`` in the returned :class:`CountResult`.
* **Observability.**  Every flush and every degraded read is recorded as
  a :class:`repro_torch.core.runtime.MatchStats` into the session's and
  the broker's shared :class:`repro_torch.core.runtime.StatsRecorder`;
  :meth:`Broker.stats` exposes queue depths, admission counters, flush
  latency percentiles and the degradation ladder per session and
  broker-wide.

The applied-op **journal** (``journal=True``) records every op in apply
order; :func:`replay_journal` re-runs it single-threaded into a fresh
service, so "no accepted mutation is ever lost" is a checkable property.

Sessions run their service on the device it was built for: the default
factory is the port's ``DDMService`` (``device="cuda"``); pass
``device="cpu"`` through :meth:`Broker.create_session`'s
``**service_kwargs``.  A CUDA device without an index is pinned to the
creating thread's current device, so the flusher thread never relies on
its own per-thread current device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import runtime as runtime_lib
from repro_torch.core.errors import (DeadlineExceeded, OverloadError,
                                     ValidationError)
from repro_torch.core.incremental import BatchDelta
from repro_torch.core.service import DDMService

BACKPRESSURE_POLICIES = ("block", "reject", "shed_oldest")
ESTIMATORS = ("probe", "grid")


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Bounded-queue admission control of one broker session.

    ``max_queue`` bounds the number of queued (not yet flushed) ops.
    ``backpressure`` picks what happens to a producer hitting the bound:
    ``"block"`` waits up to ``block_timeout`` seconds for a flush to
    drain (then raises :class:`OverloadError`), ``"reject"`` raises
    immediately, ``"shed_oldest"`` drops the oldest queued ops (failing
    their tickets with :class:`OverloadError`) to admit the new one —
    freshest-wins, the moving-region regime where a newer move of the
    same world supersedes a stale one.
    """

    max_queue: int = 4096
    backpressure: str = "block"
    block_timeout: float = 5.0

    def __post_init__(self):
        if self.backpressure not in BACKPRESSURE_POLICIES:
            raise ValidationError(
                f"backpressure must be one of {BACKPRESSURE_POLICIES}, "
                f"got {self.backpressure!r}")
        if self.max_queue < 1:
            raise ValidationError(
                f"max_queue must be >= 1, got {self.max_queue}")


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """When and how ``match_count`` reads degrade.

    A read degrades when the session's queue depth reaches
    ``max_queue_depth`` or its p99 flush latency (over the rolling
    window) reaches ``max_p99_seconds`` — both ``None`` disables
    degradation (every read drains the queue and answers exactly).
    ``estimator`` picks the cheap path: ``"probe"`` is the counting
    sweep (exact over the *applied* state, an estimate only because
    queued ops are not yet reflected; d>1 uses the selective-dimension
    probe, an upper bound), ``"grid"`` is the §3.2 grid binning count
    (1-d only; a lower bound if a cell overflows — d>1 falls back to
    probe).
    """

    max_queue_depth: Optional[int] = None
    max_p99_seconds: Optional[float] = None
    estimator: str = "probe"

    def __post_init__(self):
        if self.estimator not in ESTIMATORS:
            raise ValidationError(
                f"estimator must be one of {ESTIMATORS}, "
                f"got {self.estimator!r}")

    @property
    def enabled(self) -> bool:
        return (self.max_queue_depth is not None
                or self.max_p99_seconds is not None)


@dataclasses.dataclass(frozen=True)
class CountResult:
    """A ``match_count`` read through the broker.

    ``exact=True``: the queue was drained and ``count`` is the true K of
    the session's current world.  ``exact=False``: the session was
    degraded — ``count`` came from the cheap estimator (``source``) over
    the last-*applied* state, with ``pending`` queued ops not yet
    reflected.
    """

    count: int
    exact: bool
    source: str
    pending: int = 0

    def __int__(self) -> int:
        return self.count


class Ticket:
    """Resolution handle of one queued mutation (a minimal future).

    Resolves at the flush boundary that applies (or drops) the op:
    ``result()`` returns the op's rid(s) — the assigned rids for a
    register, the targeted rids otherwise — or raises the op's failure
    (:class:`OverloadError` when shed, :class:`DeadlineExceeded` when
    expired, the service's validation error when the op was bad).
    """

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value) -> None:
        self._value = value
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("ticket not resolved yet (no flush ran?)")
        if self._error is not None:
            raise self._error
        return self._value


@dataclasses.dataclass
class _Op:
    """One queued mutation: ``kind`` ∈ register/move/unregister, bounds
    and rids in the unified-API shapes, ``deadline`` absolute monotonic
    (or None)."""

    kind: str
    side: str
    rids: Optional[Union[int, np.ndarray]]
    lo: Optional[np.ndarray]
    hi: Optional[np.ndarray]
    deadline: Optional[float]
    ticket: Ticket = dataclasses.field(default_factory=Ticket)

    @property
    def n_regions(self) -> int:
        for v in (self.rids, self.lo):
            if v is not None:
                return int(np.atleast_1d(np.asarray(v)).shape[0]) \
                    if np.ndim(v) >= 1 else 1
        return 1


def _pinned_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` without an index becomes
    the calling thread's current CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _percentile(window: Sequence[float], q: float) -> float:
    if not window:
        return 0.0
    xs = sorted(window)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.999999))]


# Lock-ownership map, machine-checked by `python -m repro.analysis.check`
# (rule LOCK001): every write to a field listed here must happen under the
# named lock — lexically inside `with self._lock:` / `with self._space:`
# (a Condition alias of `_lock`), or in a method the checker proves is
# only entered with the lock held (e.g. the `*_locked` helpers).
# `Broker(debug_locks=True)` enforces the same map at run time via
# repro_torch.analysis.lockcheck.
GUARDED_BY = {
    "BrokerSession": {
        "_queue": "_lock",
        "_flush_seconds": "_lock",
        "journal": "_lock",
        "accepted": "_lock",
        "rejected": "_lock",
        "shed": "_lock",
        "expired": "_lock",
        "failed": "_lock",
        "applied": "_lock",
        "flushes": "_lock",
        "degraded_reads": "_lock",
        "exact_reads": "_lock",
    },
    "Broker": {
        "_sessions": "_lock",
    },
}


class BrokerSession:
    """One tenant: a ``DDMService`` plus its queue, lock and metrics.

    All service access happens under the session lock; producers only
    touch the queue.  Obtained via :meth:`Broker.create_session` /
    :meth:`Broker.session` — not constructed directly.
    """

    def __init__(self, name: str, service: DDMService, *,
                 admission: AdmissionPolicy, degrade: DegradePolicy,
                 broker_recorder: Optional[runtime_lib.StatsRecorder] = None,
                 journal: bool = False, latency_window: int = 128,
                 clock: Callable[[], float] = time.monotonic,
                 lock_registry=None):
        self.name = name
        self._svc = service
        self.admission = admission
        self.degrade = degrade
        self._clock = clock
        if lock_registry is not None:       # Broker(debug_locks=True)
            from repro_torch.analysis.lockcheck import (CheckedCondition,
                                                        CheckedLock)
            self._lock = CheckedLock(f"session:{name}", lock_registry)
            self._space = CheckedCondition(self._lock)
        else:
            self._lock = threading.RLock()
            self._space = threading.Condition(self._lock)
        self._queue: Deque[_Op] = deque()
        self._flush_seconds: Deque[float] = deque(maxlen=latency_window)
        self._recorder = runtime_lib.StatsRecorder()
        self._broker_recorder = broker_recorder
        self.journal: Optional[List[dict]] = [] if journal else None
        # admission/read counters (monotonic; read under the lock in stats)
        self.accepted = 0      # ops admitted to the queue
        self.rejected = 0      # reject policy or block timeout
        self.shed = 0          # ops dropped by shed_oldest
        self.expired = 0       # ops dropped at flush (deadline passed)
        self.failed = 0        # ops the service refused (bad rid/bounds)
        self.applied = 0       # ops applied to the service
        self.flushes = 0
        self.degraded_reads = 0
        self.exact_reads = 0

    # -- producer side -----------------------------------------------------
    @property
    def dims(self) -> int:
        return self._svc.dims

    @property
    def service(self) -> DDMService:
        """The underlying service — for oracles and tests; production
        callers go through the session methods (the thread boundary)."""
        return self._svc

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def register(self, side: str, lo, hi, *,
                 timeout: Optional[float] = None) -> Ticket:
        """Queue a region registration (scalar-or-block, unified-API
        shapes); the ticket resolves to the assigned rid(s) at flush."""
        lo, hi = self._coerce_bounds(lo, hi)
        return self._submit(_Op("register", side, None, lo, hi,
                                self._deadline(timeout)))

    def move(self, side: str, rids, lo, hi, *,
             timeout: Optional[float] = None) -> Ticket:
        lo, hi = self._coerce_bounds(lo, hi)
        return self._submit(_Op("move", side, self._coerce_rids(rids),
                                lo, hi, self._deadline(timeout)))

    def unregister(self, side: str, rids, *,
                   timeout: Optional[float] = None) -> Ticket:
        return self._submit(_Op("unregister", side,
                                self._coerce_rids(rids), None, None,
                                self._deadline(timeout)))

    def _deadline(self, timeout: Optional[float]) -> Optional[float]:
        return None if timeout is None else self._clock() + float(timeout)

    @staticmethod
    def _coerce_rids(rids):
        # decouple from caller-held buffers; keep the scalar-vs-block shape
        return int(rids) if np.ndim(rids) == 0 \
            else np.array(rids, np.int64, copy=True)

    @staticmethod
    def _coerce_bounds(lo, hi):
        return (np.array(lo, np.float32, copy=True),
                np.array(hi, np.float32, copy=True))

    def _submit(self, op: _Op) -> Ticket:
        pol = self.admission
        with self._space:
            if len(self._queue) >= pol.max_queue:
                if pol.backpressure == "reject":
                    self.rejected += 1
                    raise OverloadError(
                        f"session {self.name!r}: queue full "
                        f"({pol.max_queue} ops) under 'reject' policy")
                if pol.backpressure == "shed_oldest":
                    while len(self._queue) >= pol.max_queue:
                        old = self._queue.popleft()
                        self.shed += 1
                        old.ticket._fail(OverloadError(
                            f"session {self.name!r}: op shed under "
                            "overload (shed_oldest policy)"))
                else:  # block
                    limit = self._clock() + pol.block_timeout
                    while len(self._queue) >= pol.max_queue:
                        remaining = limit - self._clock()
                        if remaining <= 0:
                            self.rejected += 1
                            raise OverloadError(
                                f"session {self.name!r}: queue still full "
                                f"after blocking {pol.block_timeout}s "
                                "(no flush drained it)")
                        self._space.wait(remaining)
            self._queue.append(op)
            self.accepted += 1
        return op.ticket

    # -- flush boundary ----------------------------------------------------
    def flush(self) -> BatchDelta:
        """Drain the queue into ONE service batch; return its delta.

        FIFO apply order; expired ops are dropped whole (ticket →
        :class:`DeadlineExceeded`), service-refused ops fail their ticket
        and do not poison the rest of the batch.  Tickets resolve only
        after the service flush lands — a resolved register is durable in
        the index.
        """
        with self._lock:
            return self._flush_locked()

    def _assert_lock_held(self) -> None:
        # runtime GUARDED_BY check — a no-op outside debug_locks mode
        assert_held = getattr(self._lock, "assert_held", None)
        if assert_held is not None:
            assert_held()

    def _flush_locked(self) -> BatchDelta:
        self._assert_lock_held()
        t0 = time.perf_counter()
        now = self._clock()
        ops = list(self._queue)
        self._queue.clear()
        applied: List[Tuple[_Op, object]] = []
        for op in ops:
            if op.deadline is not None and now > op.deadline:
                self.expired += 1
                op.ticket._fail(DeadlineExceeded(
                    f"session {self.name!r}: {op.kind} deadline passed "
                    "before the flush that would have applied it"))
                continue
            try:
                result = self._apply_op(op)
            except Exception as exc:           # bad rid/bounds: op-local
                self.failed += 1
                op.ticket._fail(exc)
                continue
            applied.append((op, result))
        # cleared so an empty flush can't fold a previous batch's surgery
        # stats into this record
        self._svc._index.last_batch_stats = None
        delta = self._svc.flush()
        dt = time.perf_counter() - t0
        self._flush_seconds.append(dt)
        self.flushes += 1
        self.applied += len(applied)
        for op, result in applied:
            if self.journal is not None:
                self.journal.append({
                    "kind": op.kind, "side": op.side,
                    "rids": np.asarray(result).tolist(),
                    "lo": None if op.lo is None else op.lo.tolist(),
                    "hi": None if op.hi is None else op.hi.tolist(),
                })
            op.ticket._resolve(result)
        stats = runtime_lib.MatchStats(
            engine="frontend_flush", regime=self.admission.backpressure,
            count=len(applied), capacity=len(ops),
            attempts=[len(ops)])
        stats.add_phase("flush", dt)
        # fold the index's surgery stats into the flush record so the
        # broker surface shows blocked-index behaviour
        surgery = self._svc._index.last_batch_stats
        if surgery is not None:
            stats.blocks_touched = surgery.blocks_touched
            splice = surgery.phase_seconds.get("splice")
            if splice is not None:
                stats.add_phase("splice", splice)
        self._record(stats)
        self._space.notify_all()
        return delta

    def _apply_op(self, op: _Op):
        if op.kind == "register":
            return self._svc.register(op.side, op.lo, op.hi)
        if op.kind == "move":
            self._svc.move(op.side, op.rids, op.lo, op.hi)
            return op.rids
        if op.kind == "unregister":
            self._svc.unregister(op.side, op.rids)
            return op.rids
        raise ValidationError(f"unknown op kind {op.kind!r}")

    def _record(self, stats: runtime_lib.MatchStats) -> None:
        self._recorder.record(stats)
        if self._broker_recorder is not None:
            self._broker_recorder.record(stats)

    # -- read side ---------------------------------------------------------
    def pairs(self):
        """Exact ``{(sub rid, upd rid)}`` — drains the queue first."""
        with self._lock:
            self._flush_locked()
            return self._svc.pairs()

    def flush_p99(self) -> float:
        """p99 flush latency (seconds) over the rolling window."""
        with self._lock:
            return _percentile(self._flush_seconds, 0.99)

    def is_degraded(self) -> bool:
        """Whether the next ``match_count`` read would degrade."""
        with self._lock:
            return self._degraded_locked()

    def _degraded_locked(self) -> bool:
        pol = self.degrade
        if pol.max_queue_depth is not None \
                and len(self._queue) >= pol.max_queue_depth:
            return True
        return (pol.max_p99_seconds is not None
                and _percentile(self._flush_seconds, 0.99)
                >= pol.max_p99_seconds)

    def match_count(self) -> CountResult:
        """K of this session's world — exact when healthy, the cheap
        counting estimate (``exact=False``) when degraded.

        The exact path drains the queue (one batch) and reads the
        delta-maintained cache / counting sweep; the degraded path
        touches neither the queue nor the index — it runs the
        :class:`DegradePolicy` estimator over the already-applied region
        tables, so a deep queue or a slow flush pipeline cannot make
        reads arbitrarily slow.
        """
        with self._lock:
            if not self._degraded_locked():
                self._flush_locked()
                self.exact_reads += 1
                return CountResult(self._svc.match_count(), True, "index", 0)
            t0 = time.perf_counter()
            count, source = self._estimate_locked()
            self.degraded_reads += 1
            stats = runtime_lib.MatchStats(
                engine="frontend_degraded_read", regime=source, count=count)
            stats.add_phase("probe", time.perf_counter() - t0)
            self._record(stats)
            return CountResult(count, False, source, len(self._queue))

    def _estimate_locked(self) -> Tuple[int, str]:
        """The degradation ladder's cheap count over applied state, on the
        service's device."""
        from repro_torch.core import ddim as ddim_lib
        from repro_torch.core import sweep as sweep_lib
        from repro_torch.core.grid import grid_count

        svc = self._svc
        sl = svc._subs.live_ids()
        ul = svc._upds.live_ids()
        if sl.size == 0 or ul.size == 0:
            return 0, "empty"
        subs = svc._subs.compact(sl, svc.device)
        upds = svc._upds.compact(ul, svc.device)
        if svc.dims == 1 and self.degrade.estimator == "grid":
            count, _ = grid_count(subs, upds)     # overflow → lower bound
            return int(count), "grid_count"
        if svc.dims == 1:
            k, _ = sweep_lib.probe_count(subs, upds)
            return int(k), "probe_count"
        gen, counts = ddim_lib.select_dimension(subs, upds)
        return int(counts[gen]), "probe_count"    # min_d K_d: upper bound

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Queue/admission/degradation snapshot + both stats streams
        (the frontend's own records and the service's engine records)."""
        with self._lock:
            return {
                "queue_depth": len(self._queue),
                "accepted": self.accepted,
                "rejected": self.rejected,
                "shed": self.shed,
                "expired": self.expired,
                "failed": self.failed,
                "applied": self.applied,
                "flushes": self.flushes,
                "flush_p50_us": _percentile(self._flush_seconds, 0.5) * 1e6,
                "flush_p95_us": _percentile(self._flush_seconds, 0.95) * 1e6,
                "flush_p99_us": _percentile(self._flush_seconds, 0.99) * 1e6,
                "degraded_reads": self.degraded_reads,
                "exact_reads": self.exact_reads,
                "frontend": self._recorder.snapshot(),
                "service": self._svc.stats(),
            }


class Broker:
    """The multi-tenant frontend: named sessions + one flusher.

    >>> with Broker(flush_interval=0.01) as broker:
    ...     sess = broker.create_session("world-0", dims=2, device="cpu")
    ...     t = sess.register("sub", [0, 0], [10, 10])
    ...     rid = t.result(timeout=1.0)       # resolved by the flusher
    ...     sess.match_count().count

    ``flush_interval`` (seconds) starts a daemon flusher draining every
    session periodically; without it, flushes happen on reads
    (``pairs`` / healthy ``match_count``) and explicit
    :meth:`BrokerSession.flush` / :meth:`flush_all` calls.  Session
    creation is thread-safe; per-session mutation/read concurrency is the
    session's own lock.
    """

    def __init__(self, *, admission: Optional[AdmissionPolicy] = None,
                 degrade: Optional[DegradePolicy] = None,
                 journal: bool = False,
                 flush_interval: Optional[float] = None,
                 service_factory: Callable[..., DDMService] = DDMService,
                 debug_locks: bool = False):
        self.admission = admission or AdmissionPolicy()
        self.degrade = degrade or DegradePolicy()
        self._journal = journal
        self._factory = service_factory
        self._sessions: Dict[str, BrokerSession] = {}
        self._lock_registry = None
        if debug_locks:                     # TSan-lite audited locks
            from repro_torch.analysis.lockcheck import (CheckedLock,
                                                        LockRegistry)
            self._lock_registry = LockRegistry()
            # registered first: broker lock ranks before session locks in
            # the global acquisition order
            self._lock = CheckedLock("broker", self._lock_registry)
        else:
            self._lock = threading.Lock()
        self._recorder = runtime_lib.StatsRecorder(history=256)
        self._flush_interval = flush_interval
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if flush_interval is not None:
            self.start()

    # -- session management ------------------------------------------------
    def create_session(self, name: str, *, dims: int = 1,
                       capacity: int = 1024,
                       admission: Optional[AdmissionPolicy] = None,
                       degrade: Optional[DegradePolicy] = None,
                       **service_kwargs) -> BrokerSession:
        """Create (and own) a named ``DDMService`` session.  Per-session
        policies default to the broker-wide ones; ``service_kwargs`` reach
        the factory (``device="cpu"`` among them).  With the default
        factory, or where ``device`` is given, a CUDA device without an
        index is pinned to this thread's current device."""
        if self._factory is DDMService or "device" in service_kwargs:
            service_kwargs["device"] = _pinned_device(
                service_kwargs.get("device", "cuda"))
        with self._lock:
            if name in self._sessions:
                raise ValidationError(f"session {name!r} already exists")
            svc = self._factory(dims=dims, capacity=capacity,
                                **service_kwargs)
            sess = BrokerSession(
                name, svc,
                admission=admission or self.admission,
                degrade=degrade or self.degrade,
                broker_recorder=self._recorder,
                journal=self._journal,
                lock_registry=self._lock_registry)
            self._sessions[name] = sess
            return sess

    def session(self, name: str) -> BrokerSession:
        with self._lock:
            try:
                return self._sessions[name]
            except KeyError:
                raise KeyError(f"no session {name!r}") from None

    def sessions(self) -> List[str]:
        with self._lock:
            return sorted(self._sessions)

    def drop_session(self, name: str) -> None:
        """Remove a session (pending queued ops fail with OverloadError)."""
        with self._lock:
            sess = self._sessions.pop(name, None)
        if sess is not None:
            with sess._lock:
                while sess._queue:
                    op = sess._queue.popleft()
                    op.ticket._fail(OverloadError(
                        f"session {name!r} dropped with ops queued"))

    # -- flushing ----------------------------------------------------------
    def flush_all(self) -> Dict[str, BatchDelta]:
        """One flush per session (in name order); name → delta."""
        with self._lock:
            sessions = sorted(self._sessions.items())
        return {name: sess.flush() for name, sess in sessions}

    def start(self) -> None:
        """Start the periodic flusher (idempotent)."""
        if self._flusher is not None and self._flusher.is_alive():
            return
        if self._flush_interval is None:
            raise ValidationError(
                "Broker.start() needs flush_interval set")
        self._stop.clear()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="ddm-broker-flusher", daemon=True)
        self._flusher.start()

    def _flush_loop(self) -> None:
        while not self._stop.wait(self._flush_interval):
            with self._lock:
                sessions = list(self._sessions.values())
            for sess in sessions:
                try:
                    if sess.queue_depth:
                        sess.flush()
                except Exception:
                    # a poisoned session must not kill the flusher for
                    # every other tenant; its own tickets carry the error
                    pass

    def close(self) -> None:
        """Stop the flusher and run one final drain of every session."""
        self._stop.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
            self._flusher = None
        self.flush_all()

    def __enter__(self) -> "Broker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Per-session snapshots + broker-wide totals + the shared
        recorder (every session's flush/degraded-read records)."""
        with self._lock:
            sessions = dict(self._sessions)
        per = {name: sess.stats() for name, sess in sorted(sessions.items())}
        keys = ("queue_depth", "accepted", "rejected", "shed", "expired",
                "failed", "applied", "flushes", "degraded_reads",
                "exact_reads")
        totals = {k: sum(int(s[k]) for s in per.values()) for k in keys}
        totals["sessions"] = len(per)
        totals["flush_p95_us"] = max(
            (float(s["flush_p95_us"]) for s in per.values()), default=0.0)
        totals["flush_p99_us"] = max(
            (float(s["flush_p99_us"]) for s in per.values()), default=0.0)
        out = {"sessions": per, "totals": totals,
               "recorder": self._recorder.snapshot()}
        if self._lock_registry is not None:
            # acquisition order, per-lock acquisition/contention counts,
            # and any recorded discipline violations (debug_locks mode)
            out["locks"] = self._lock_registry.snapshot()
        return out


def replay_journal(journal: Sequence[dict], *, dims: int = 1,
                   capacity: int = 1024,
                   service_factory: Callable[..., DDMService] = DDMService,
                   device="cuda") -> DDMService:
    """Re-run a session journal single-threaded into a fresh service,
    ``service_factory(dims=..., capacity=..., device=device)``.

    Rid assignment is deterministic given apply order and initial
    capacity (the tables' free lists pop tail-first), so a register
    entry must resolve to the same rids it got live — checked here.
    The returned service's ``pairs()`` is the replay's final match set;
    comparing it (and the oracles of :mod:`repro_torch.testing.oracles`)
    against the live session's is the zero-loss verification.  The
    replay may run on another device than the session did.
    """
    svc = service_factory(dims=dims, capacity=capacity, device=device)
    for entry in journal:
        kind, side = entry["kind"], entry["side"]
        rids = entry["rids"]
        if kind == "register":
            got = svc.register(side, entry["lo"], entry["hi"])
            got = np.atleast_1d(np.asarray(got)).tolist()
            want = np.atleast_1d(np.asarray(rids)).tolist()
            if got != want:
                raise AssertionError(
                    f"replay rid drift: register assigned {got}, "
                    f"journal recorded {want}")
        elif kind == "move":
            svc.move(side, np.asarray(rids), entry["lo"], entry["hi"]) \
                if np.ndim(rids) else svc.move(side, rids, entry["lo"],
                                               entry["hi"])
        elif kind == "unregister":
            svc.unregister(side, np.asarray(rids)
                           if np.ndim(rids) else rids)
        else:
            raise ValidationError(f"unknown journal op kind {kind!r}")
    svc.flush()
    return svc
