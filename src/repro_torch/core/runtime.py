"""Execution-plan runtime: capacity planner + instrumented executor.

Pairs are emitted into a fixed-size buffer whose required capacity is only
known after the counting sweep.  The contract that falls out of it — *pairs
beyond* ``max_pairs`` *are dropped but still counted; callers check*
``count <= max_pairs`` *and retry bigger* — lives here, once:

* **Planner** — :func:`round_up_pow2` is THE pow2 ladder;
  :class:`CapacityPolicy` decides the initial ``max_pairs`` (from a
  counting-sweep estimate, or a start capacity), pow2 growth on overflow,
  and an optional **hard cap** that raises :class:`CapacityError`.
* **Executor** — :func:`execute_enumeration` is the one count-then-retry
  loop.  Every call records a :class:`MatchStats`: per-phase wall times,
  retry count, kernel builds during the call (:func:`kernel_builds` — the
  port's counterpart of the JAX package's XLA-compile probe, so
  ``recompiles == 0`` still means "no new build after warm-up"), final
  capacity and padded-vs-actual waste.
* **Observability** — :class:`StatsRecorder` aggregates stats across calls.
* **Bulk-regime policy** — :class:`BulkRegimePolicy` owns the
  dense/device/sort thresholds of the incremental engine's stacked rematch.

This module is host-only (stdlib + numpy; :mod:`repro_torch.perf.spans`
imports torch only while spans record).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.errors import CapacityError, ValidationError
from repro_torch.perf import spans

Pair = Tuple[int, int]
PairSet = Set[Pair]


# ---------------------------------------------------------------------------
# The padding ladder — THE one pow2-bucketing rule of the port
# ---------------------------------------------------------------------------

def round_up_pow2(k: int) -> int:
    """Power-of-two ``max_pairs`` buckets with a ``max(8, ·)`` floor."""
    return max(8, 1 << (k - 1).bit_length())


def pad_columns(a: np.ndarray, n: int, fill: float) -> np.ndarray:
    """Host-side column padding of a ``(d, b)`` block to ``n`` columns with
    an inert sentinel (callers pass ``+inf``/``-inf`` for lo/hi)."""
    if a.shape[1] == n:
        return a
    out = np.full((a.shape[0], n), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


# ---------------------------------------------------------------------------
# Capacity planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapacityPolicy:
    """How the planner sizes and grows ``max_pairs`` buffers.

    ``start_cap`` is the first attempt's capacity when no estimate is
    available; with an estimate the first capacity is its
    :func:`round_up_pow2` bucket.  On overflow the executor grows to the
    bucket of the exact returned count; ``hard_cap`` turns growth past it
    into a :class:`CapacityError`; ``max_attempts`` bounds the loop.
    """

    start_cap: int = 64
    hard_cap: Optional[int] = None
    max_attempts: int = 10


DEFAULT_POLICY = CapacityPolicy()


def initial_capacity(estimate: Optional[int],
                     policy: CapacityPolicy = DEFAULT_POLICY) -> int:
    """First-attempt ``max_pairs``: the estimate's ladder bucket, or the
    policy's start capacity; clamped to ``hard_cap`` when set."""
    cap = (policy.start_cap if estimate is None
           else round_up_pow2(max(int(estimate), 1)))
    if policy.hard_cap is not None:
        cap = min(cap, policy.hard_cap)
    return cap


def next_capacity(count: int, cap: int,
                  policy: CapacityPolicy = DEFAULT_POLICY) -> int:
    """Grown capacity after an overflow: the ladder bucket of the exact
    count.  Raises :class:`CapacityError` past the policy's hard cap."""
    nxt = round_up_pow2(max(int(count), cap + 1))
    if policy.hard_cap is not None and nxt > policy.hard_cap:
        raise CapacityError(
            f"enumeration needs max_pairs={nxt} (count {count}) but the "
            f"policy hard cap is {policy.hard_cap}")
    return nxt


# ---------------------------------------------------------------------------
# Kernel-build counter
# ---------------------------------------------------------------------------

# Process-wide, like the built kernel library it counts: one build per
# library load (repro_torch.kernels._build), none after warm-up.
_builds = {"count": 0}


def record_kernel_build() -> None:
    """Called by :mod:`repro_torch.kernels._build` once per loaded library."""
    _builds["count"] += 1


def kernel_builds() -> int:
    """Monotonic count of kernel-library builds in this process.  Deltas
    across a region of code count the builds it caused — zero after
    warm-up."""
    return _builds["count"]


# ---------------------------------------------------------------------------
# Per-call stats + the aggregating recorder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatchStats:
    """Observability record of one planned matching call.

    ``engine`` names the entry point (``"sweep"``, ``"service_rebuild"``,
    ``"incremental_bulk"``, …); ``regime`` the internal strategy when one
    was selected.  ``attempts`` lists every capacity tried —
    ``len(attempts) - 1 == retries``.  ``recompiles`` counts kernel builds
    during the call.  ``blocks_touched`` counts the blocked endpoint
    index's per-batch block mutations.
    """

    engine: str = ""
    regime: str = ""
    count: int = 0
    capacity: int = 0
    retries: int = 0
    recompiles: int = 0
    blocks_touched: int = 0
    attempts: List[int] = dataclasses.field(default_factory=list)
    phase_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def waste(self) -> int:
        """Padded-vs-actual buffer waste of the final attempt."""
        return max(self.capacity - self.count, 0)

    @property
    def peak_buffer_elements(self) -> int:
        """Largest pair buffer materialized across attempts (elements)."""
        return 2 * max(self.attempts, default=self.capacity)

    @property
    def splice_us(self) -> float:
        return self.phase_seconds.get("splice", 0.0) * 1e6

    @property
    def rank_patch_us(self) -> float:
        return self.phase_seconds.get("rank_patch", 0.0) * 1e6

    def add_phase(self, name: str, seconds: float) -> None:
        self.phase_seconds[name] = self.phase_seconds.get(name, 0.0) + seconds

    def as_dict(self) -> Dict[str, object]:
        return {
            "engine": self.engine,
            "regime": self.regime,
            "count": self.count,
            "capacity": self.capacity,
            "retries": self.retries,
            "recompiles": self.recompiles,
            "blocks_touched": self.blocks_touched,
            "attempts": list(self.attempts),
            "waste": self.waste,
            "peak_buffer_elements": self.peak_buffer_elements,
            "splice_us": self.splice_us,
            "rank_patch_us": self.rank_patch_us,
            "phase_seconds": dict(self.phase_seconds),
        }


class StatsRecorder:
    """Rolling aggregate of :class:`MatchStats` across calls: the last
    ``history`` records plus monotonic totals."""

    def __init__(self, history: int = 64):
        self._history: Deque[MatchStats] = deque(maxlen=history)
        self.calls = 0
        self.retries = 0
        self.recompiles = 0
        self.by_engine: Dict[str, int] = {}
        self.by_regime: Dict[str, int] = {}

    def record(self, stats: MatchStats) -> MatchStats:
        self._history.append(stats)
        self.calls += 1
        self.retries += stats.retries
        self.recompiles += stats.recompiles
        if stats.engine:
            self.by_engine[stats.engine] = \
                self.by_engine.get(stats.engine, 0) + 1
        if stats.regime:
            self.by_regime[stats.regime] = \
                self.by_regime.get(stats.regime, 0) + 1
        return stats

    @property
    def last(self) -> Optional[MatchStats]:
        return self._history[-1] if self._history else None

    def history(self) -> List[MatchStats]:
        return list(self._history)

    def snapshot(self) -> Dict[str, object]:
        """JSON-able aggregate view (totals + the last record)."""
        return {
            "calls": self.calls,
            "retries": self.retries,
            "recompiles": self.recompiles,
            "by_engine": dict(self.by_engine),
            "by_regime": dict(self.by_regime),
            "last": self.last.as_dict() if self.last else None,
        }


# ---------------------------------------------------------------------------
# The executor — the one count-then-retry loop
# ---------------------------------------------------------------------------

# the id of each call of execute_enumeration (a match) in its spans
_matches = itertools.count()


def execute_enumeration(
    fn: Callable,
    subs,
    upds,
    *,
    estimate: Optional[int] = None,
    capacity: Optional[int] = None,
    policy: CapacityPolicy = DEFAULT_POLICY,
    engine: str = "",
    regime: str = "",
    probe_seconds: float = 0.0,
    recorder: Optional[StatsRecorder] = None,
):
    """Run ``fn(subs, upds, max_pairs=c) -> (buffer, count)`` under the
    overflow contract, instrumented.

    The first attempt's capacity is ``capacity`` verbatim when given, else
    :func:`initial_capacity` from ``estimate``/policy.  ``count > max_pairs``
    means the buffer was short; the count is exact, so one growth step to
    its ladder bucket converges.  Each attempt is a ``plan.attempt`` span
    (:mod:`repro_torch.perf.spans`) with the call's ``match`` id and its
    capacity; its host seconds are the ``emit`` phase.  Returns
    ``(buffer, count, stats)``.
    Raises :class:`CapacityError` on a hard-cap violation or when
    ``policy.max_attempts`` is exhausted.
    """
    stats = MatchStats(engine=engine, regime=regime)
    if probe_seconds:
        stats.add_phase("probe", probe_seconds)
    cap = (int(capacity) if capacity is not None
           else initial_capacity(estimate, policy))
    builds_before = kernel_builds()
    match = next(_matches)
    for attempt in range(max(policy.max_attempts, 1)):
        stats.attempts.append(cap)
        with spans.span("plan.attempt", timed=True, match=match,
                        capacity=cap) as phase:
            buf, count = fn(subs, upds, max_pairs=cap)
            c = int(count)                   # device sync: closes the phase
        stats.add_phase("emit", phase.seconds)
        if c <= cap:
            stats.count = c
            stats.capacity = cap
            stats.retries = attempt
            stats.recompiles = kernel_builds() - builds_before
            if recorder is not None:
                recorder.record(stats)
            return buf, count, stats
        cap = next_capacity(c, cap, policy)
    raise CapacityError(
        f"enumeration never satisfied count <= max_pairs within "
        f"{policy.max_attempts} attempts (engine {engine!r}, "
        f"attempts {stats.attempts})")


def pair_set(pairs) -> PairSet:
    """A padded ``(max_pairs, 2)`` buffer → ``{(i, j)}`` (drops ``(-1, -1)``)."""
    arr = pairs.detach().cpu().numpy() if hasattr(pairs, "detach") \
        else np.asarray(pairs)
    if arr.size == 0:
        return set()
    arr = arr[arr[:, 0] >= 0]
    return set(zip(arr[:, 0].tolist(), arr[:, 1].tolist()))


def pairs_via_retry(fn, subs, upds, *, start_cap: int = 64,
                    policy: Optional[CapacityPolicy] = None,
                    engine: str = "",
                    recorder: Optional[StatsRecorder] = None) -> PairSet:
    """Exact pair set of an enumeration under the overflow contract: the
    retry loop from ``start_cap``, the final buffer as a host set, and a
    cross-check that the buffer holds exactly ``count`` pairs."""
    policy = policy or DEFAULT_POLICY
    buf, count, stats = execute_enumeration(
        fn, subs, upds, capacity=start_cap, policy=policy, engine=engine)
    t0 = time.perf_counter()
    got = pair_set(buf)
    stats.add_phase("collect", time.perf_counter() - t0)
    if recorder is not None:
        recorder.record(stats)
    c = int(count)
    if len(got) != c:
        raise AssertionError(
            f"buffer holds {len(got)} pairs but count says {c}")
    return got


# ---------------------------------------------------------------------------
# Bulk-rematch regime policy (the incremental engine's dense/device/sort)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BulkRegimePolicy:
    """Thresholds of the stacked bulk rematch's three regimes.

    ``b·m <= dense_max_elems``: one dense numpy mask.  ``b·m <=
    device_max_elems``: the fused torch mask on the index's device (the JAX
    package's jitted XLA mask).  Above: the output-sensitive sort-based
    candidates path on the host.  The defaults are the JAX package's
    crossovers, measured for XLA on a CPU; they have not been re-measured
    for a card.  ``force`` pins a regime outright.
    """

    dense_max_elems: int = 1 << 21
    device_max_elems: int = 1 << 24
    force: Optional[str] = None

    def __post_init__(self):
        if self.force is not None and self.force not in BULK_REGIMES:
            raise ValidationError(
                f"force must be one of {BULK_REGIMES}, got {self.force!r}")


BULK_REGIMES = ("dense", "device", "sort")
DEFAULT_BULK_POLICY = BulkRegimePolicy()


def select_bulk_regime(b: int, m: int,
                       policy: BulkRegimePolicy = DEFAULT_BULK_POLICY) -> str:
    """Regime of a b-query × m-counterpart stacked rematch under a policy."""
    if policy.force is not None:
        return policy.force
    elems = b * m
    if elems <= policy.dense_max_elems:
        return "dense"
    if elems <= policy.device_max_elems:
        return "device"
    return "sort"
