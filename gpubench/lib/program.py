"""The program's own spans and counters (``repro_torch.perf.spans``), read
for the per-layer metrics: the store's records inside the measured
window, and the program's ranges among the profiler's host events
against the device's busy time.

A checkout whose port has no such store, or whose trace holds no such
range, gives nothing to read: the readers return None there."""
from __future__ import annotations

from typing import List, Optional, Tuple

Interval = Tuple[int, int]

# host calls that put work on the device: kernel launches, copies, fills
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def window_records(run):
    """(spans, counts) of the program's store that lie inside the window,
    as the harness's spans (``run.spans``) bound it; the store is read,
    never reset.  None where the port has no store or the window no
    harness span."""
    try:
        from repro_torch.perf import spans
    except ImportError:
        return None
    if not run.spans.items:
        return None
    lo = min(t0 for _, t0, _ in run.spans.items)
    hi = max(t1 for _, _, t1 in run.spans.items)
    snap = spans.snapshot()
    return ([r for r in snap.spans if lo <= r.t0 and r.t1 <= hi],
            [c for c in snap.counts if lo <= c.t <= hi])


def device_ms_a_wave(run, name: str) -> Optional[float]:
    """Device ms between the CUDA events of span ``name``, summed over
    the window and over the waves (``serve.wave`` spans) it holds."""
    got = window_records(run)
    if not run.trace.device or got is None:
        return None
    spans, _ = got
    waves = sum(1 for r in spans if r.name == "serve.wave")
    ms = [r.device_ms for r in spans
          if r.name == name and r.device_ms is not None]
    if waves == 0 or not ms:
        return None
    return sum(ms) / waves


def host_ranges(run, name: str) -> List[Interval]:
    """The profiler's host ranges of the program's span ``name``, in ns."""
    return [(s, t) for n, s, t in run.trace.host if n == name]


def union(intervals) -> List[Interval]:
    out: List[Interval] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """``a`` less ``b``, both unions (sorted, disjoint)."""
    out: List[Interval] = []
    j = 0
    for s, t in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < t:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < t:
            out.append((cur, t))
    return out


def length(intervals: List[Interval]) -> int:
    return sum(t - s for s, t in intervals)


def device_idle_ns(run, region: List[Interval]) -> int:
    """Nanoseconds of ``region`` (a union) in which no kernel, copy or fill
    ran on the device."""
    busy = union((s, t) for _, s, t in run.trace.device)
    return length(subtract(region, busy))


def launches_in(run, region: List[Interval]) -> int:
    """Host calls that put work on the device (``LAUNCH_CALLS``) begun
    inside ``region`` (a union)."""
    starts = sorted(s for n, s, _ in run.trace.host
                    if n.startswith(LAUNCH_CALLS))
    total, i = 0, 0
    for s, t in region:
        while i < len(starts) and starts[i] < s:
            i += 1
        while i < len(starts) and starts[i] < t:
            total += 1
            i += 1
    return total
