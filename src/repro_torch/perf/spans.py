"""Spans and counters inside the port, on the profiler's clock.

``span(name, **ids)`` marks a phase of the program; ``count(name, value)``
adds to a counter.  Both are **active** only while a ``torch.profiler``
session records or after :func:`enable`.  Then a span

* opens a ``record_function(name)`` range, so that it lies in the
  profiler's trace beside every kernel it launched and names what the
  host was doing in each gap of the device's timeline;
* appends a :class:`SpanRecord` (name, parent span, ids, ``perf_counter``
  seconds at open and close) to a bounded in-memory store: a span opened
  inside another takes it as parent and inherits its ids, so the spans of
  one wave or one match carry that wave's or match's id;
* with ``device=True`` records a pair of pooled CUDA events around the
  phase on the current stream; nothing synchronises, the device
  milliseconds between them are resolved by :func:`snapshot`.

A counter's value may be a device tensor, kept as it is and summed when
:func:`snapshot` reads it; nothing syncs at the site.

Inactive, a span costs one flag read: it opens no range, records no
event, keeps no record and allocates nothing.  A caller that needs the
phase's host seconds (``MatchStats``) passes ``timed=True`` and reads
``.seconds`` from what the span yields, active or not; that costs the two
clock reads it paid before.

The module imports torch only once a span is active (it finds the
profiler's flag through ``sys.modules``), so host-only modules such as
:mod:`repro_torch.core.runtime` may open spans.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

# records (spans and counts together) the store keeps before it counts
# what it drops instead
LIMIT = 1 << 17

_PROFILER = "torch.autograd.profiler"


def _profiler():
    prof = sys.modules.get(_PROFILER)
    if prof is None:                    # enabled before torch was imported
        import torch.autograd.profiler as prof
    return prof


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    ids: Dict[str, object]
    t0: float                       # time.perf_counter() seconds
    t1: float
    device_ms: Optional[float]      # between the span's CUDA events


class CountRecord(NamedTuple):
    name: str
    parent: Optional[str]
    ids: Dict[str, object]
    t: float
    value: int


class Snapshot(NamedTuple):
    spans: List[SpanRecord]
    counts: List[CountRecord]
    dropped: int                    # records the bound turned away


class _Null:
    """What an inactive span yields without ``timed``: shared, stateless."""
    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **ids) -> None:
        pass


_NULL = _Null()


class _Clock(_Null):
    """An inactive span with ``timed=True``: the host seconds only."""
    __slots__ = ("t0", "seconds")

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


class _Live:
    """An active span."""
    __slots__ = ("store", "name", "device", "ids", "parent", "t0", "seconds",
                 "range", "events")

    def __init__(self, store: "Store", name: str, device: bool, ids: Dict):
        self.store = store
        self.name = name
        self.device = device
        self.ids = ids
        self.seconds = 0.0

    def tag(self, **ids) -> None:
        """Add ids known only after the span opened (a wave's requests)."""
        self.ids = {**self.ids, **ids}

    def __enter__(self):
        stack = self.store._stack()
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        if up is not None and up.ids:
            self.ids = {**up.ids, **self.ids} if self.ids else up.ids
        stack.append(self)
        self.range = _profiler().record_function(self.name)
        self.range.__enter__()
        self.events = self.store._event_pair() if self.device else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        self.store._stack().pop()
        self.seconds = t1 - self.t0
        self.store._keep([self.name, self.parent, self.ids, self.t0, t1,
                          self.events])
        return False


class Store:
    """The bounded in-memory records of active spans and counters."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self.enabled = False
        self._items: List[list] = []      # span and count records, in order
        self._dropped = 0
        self._pool: List[Tuple] = []      # CUDA event pairs to reuse
        self._local = threading.local()
        self._lock = threading.Lock()

    # -- the hot path -----------------------------------------------------
    def active(self) -> bool:
        """True while spans record: a profiler session, or :func:`enable`."""
        if self.enabled:
            return True
        prof = sys.modules.get(_PROFILER)
        return prof is not None and prof._is_profiler_enabled

    def span(self, name: str, *, device: bool = False, timed: bool = False,
             **ids):
        """A context manager over one phase named ``name`` (see the
        module's docstring).  ``device``: time the phase on the device too
        (pass ``tensor.is_cuda``); ``timed``: the yielded object's
        ``.seconds`` holds the phase's host seconds even while inactive;
        ``ids``: this span's ids (``wave=``, ``match=``), inherited by the
        spans opened inside it."""
        if not self.active():
            return _Clock() if timed else _NULL
        return _Live(self, name, device, ids)

    def count(self, name: str, value) -> None:
        """Add ``value`` (an int or a one-element integer tensor, read at
        :func:`snapshot`) to counter ``name`` while spans are active."""
        if not self.active():
            return
        stack = self._stack()
        up = stack[-1] if stack else None
        self._keep([name, up.name if up else None, up.ids if up else {},
                    time.perf_counter(), value])

    # -- reading ----------------------------------------------------------
    def snapshot(self) -> Snapshot:
        """Every record kept (nothing is cleared), device times and
        counter values resolved: this waits for the device where a span's
        events are pending."""
        with self._lock:
            items = self._items
            spans, counts = [], []
            for it in items:
                if len(it) == 6:
                    ev = it[5]
                    if isinstance(ev, tuple):
                        ev[1].synchronize()
                        it[5] = float(ev[0].elapsed_time(ev[1]))
                        self._pool.append(ev)
                    spans.append(SpanRecord(*it))
                else:
                    if not isinstance(it[4], int):
                        it[4] = int(it[4])
                    counts.append(CountRecord(*it))
            return Snapshot(spans, counts, self._dropped)

    def reset(self) -> None:
        with self._lock:
            for it in self._items:
                if len(it) == 6 and isinstance(it[5], tuple):
                    self._pool.append(it[5])
            self._items = []
            self._dropped = 0

    # -- internals --------------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event_pair(self):
        with self._lock:
            pair = self._pool.pop() if self._pool else None
        if pair is None:
            import torch
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        pair[0].record()
        return pair

    def _keep(self, item: list) -> None:
        with self._lock:
            if len(self._items) < self.limit:
                self._items.append(item)
                return
            self._dropped += 1
            if len(item) == 6 and isinstance(item[5], tuple):
                self._pool.append(item[5])


STORE = Store()

active = STORE.active
span = STORE.span
count = STORE.count
snapshot = STORE.snapshot
reset = STORE.reset


def enable() -> None:
    """Record spans and counters without a profiler session."""
    STORE.enabled = True


def disable() -> None:
    STORE.enabled = False
