"""TSan-lite runtime lock discipline — the dynamic twin of LOCK001/002.

:class:`CheckedLock`/:class:`CheckedCondition` are drop-in wrappers over
``threading.RLock``/``Condition`` that a :class:`LockRegistry` audits:

* **per-thread held-lock sets** — every acquisition/release updates a
  thread-local stack, so "does this thread hold lock X?" is a queryable
  fact (:meth:`CheckedLock.assert_held` is the runtime form of the
  static checker's GUARDED_BY rule — sprinkle it before writes);
* **global acquisition order** — locks rank by registration order;
  acquiring a lower-ranked lock while holding a higher-ranked one is
  the ABBA deadlock shape and is recorded (and raised, when
  ``strict=True``) as a :class:`LockDisciplineError`;
* **contention counts** — an acquisition that would have blocked
  (the uncontended fast path fails) bumps the lock's contended counter,
  exposed through :meth:`LockRegistry.snapshot` and, for the broker,
  ``Broker.stats()["locks"]``.

``Broker(debug_locks=True)`` (:mod:`repro_torch.frontend.broker`) swaps
these in for every broker/session lock; the threaded stress test runs
under it and asserts zero violations.  Overhead is a dict update per
acquisition — debug builds only, but cheap enough for CI.  Pure Python:
the port's copy of the JAX package's module, of which it imports nothing.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from repro_torch.core.errors import DDMError


class LockDisciplineError(DDMError, RuntimeError):
    """A thread violated the lock discipline: out-of-global-order
    acquisition, releasing a lock it does not hold, or a guarded
    operation run without the owning lock (``assert_held``)."""


class LockRegistry:
    """Audit domain for a set of :class:`CheckedLock`\\ s.

    Lock rank == registration order: register locks in the globally
    agreed acquisition order (broker lock before session locks).  With
    ``strict=True`` (default) a violation raises at the offending call
    site — the failing stack trace *is* the diagnosis; with
    ``strict=False`` violations only accumulate in :attr:`violations`.
    """

    def __init__(self, strict: bool = True):
        self.strict = strict
        self._meta = threading.Lock()          # guards the fields below
        self._order: List[str] = []
        self.acquisitions: Dict[str, int] = {}
        self.contended: Dict[str, int] = {}
        self.violations: List[str] = []
        self._tls = threading.local()

    # -- bookkeeping -------------------------------------------------------
    def _register(self, name: str) -> Tuple[str, int]:
        """Unique-ified name + rank (a re-created session re-registers)."""
        with self._meta:
            if name in self._order:
                k = 2
                while f"{name}#{k}" in self._order:
                    k += 1
                name = f"{name}#{k}"
            self._order.append(name)
            self.acquisitions[name] = 0
            self.contended[name] = 0
            return name, len(self._order) - 1

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _violation(self, message: str) -> None:
        with self._meta:
            self.violations.append(message)
        if self.strict:
            raise LockDisciplineError(message)

    # -- hooks called by CheckedLock ---------------------------------------
    def _before_acquire(self, lock: "CheckedLock") -> None:
        held = self._held()
        if lock.name in held:
            return                               # reentrant: no order check
        for other in held:
            if self._rank(other) > lock.rank:
                self._violation(
                    f"thread {threading.current_thread().name!r} acquired "
                    f"{lock.name!r} while holding {other!r} — violates the "
                    f"global acquisition order {self._order}")

    def _rank(self, name: str) -> int:
        with self._meta:
            return self._order.index(name)

    def _after_acquire(self, lock: "CheckedLock", contended: bool) -> None:
        self._held().append(lock.name)
        with self._meta:
            self.acquisitions[lock.name] += 1
            if contended:
                self.contended[lock.name] += 1

    def _after_release(self, lock: "CheckedLock") -> None:
        held = self._held()
        if lock.name not in held:
            self._violation(
                f"thread {threading.current_thread().name!r} released "
                f"{lock.name!r} without holding it")
            return
        # remove the innermost hold (reentrant locks release LIFO)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == lock.name:
                del held[i]
                break

    # -- queries -----------------------------------------------------------
    def held_by_current_thread(self) -> List[str]:
        return list(self._held())

    def assert_held(self, name: str) -> None:
        if name not in self._held():
            self._violation(
                f"guarded operation in thread "
                f"{threading.current_thread().name!r} without holding "
                f"{name!r} (unguarded write)")

    def snapshot(self) -> Dict[str, object]:
        with self._meta:
            return {
                "order": list(self._order),
                "acquisitions": dict(self.acquisitions),
                "contended": dict(self.contended),
                "violations": list(self.violations),
            }


class CheckedLock:
    """An audited reentrant lock (see :class:`LockRegistry`)."""

    def __init__(self, name: str, registry: LockRegistry):
        self.registry = registry
        self.name, self.rank = registry._register(name)
        self._inner = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self.registry._before_acquire(self)
        got = self._inner.acquire(blocking=False)
        contended = not got
        if not got:
            if not blocking:
                return False
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        self.registry._after_acquire(self, contended)
        return True

    def release(self) -> None:
        self.registry._after_release(self)
        self._inner.release()

    def assert_held(self) -> None:
        """Runtime GUARDED_BY check: raise/record unless the calling
        thread holds this lock."""
        self.registry.assert_held(self.name)

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"CheckedLock({self.name!r})"


class CheckedCondition:
    """``threading.Condition`` over a :class:`CheckedLock`.

    The real condition runs on the lock's inner RLock (so wait/notify
    semantics are stock CPython); this wrapper keeps the registry's
    held-set truthful across ``wait``'s release/re-acquire window.
    """

    def __init__(self, lock: CheckedLock):
        self._lock = lock
        self._cond = threading.Condition(lock._inner)

    def __enter__(self) -> "CheckedCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        reg = self._lock.registry
        held = reg._held()
        depth = held.count(self._lock.name)
        if depth == 0:
            reg._violation(
                f"wait on condition of {self._lock.name!r} without "
                "holding the lock")
        # the inner RLock is fully released during wait: mirror that
        for _ in range(depth):
            reg._after_release(self._lock)
        try:
            return self._cond.wait(timeout)
        finally:
            for _ in range(depth):
                reg._before_acquire(self._lock)
                reg._after_acquire(self._lock, contended=False)

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()
