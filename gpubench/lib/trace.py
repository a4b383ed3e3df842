"""The traced run: ``torch.profiler`` over the measured window, reduced to
device intervals, device time by kernel, the busy union, and the longest
idle gaps labelled by what the host was doing."""
from __future__ import annotations

import bisect
from contextlib import contextmanager
from typing import Dict, List, Tuple

WINDOW_LABEL = "gpubench.window"


def _on_device(evt) -> bool:
    """A kernel, copy or fill that ran on the device (not the device-side
    range of a user annotation)."""
    return not str(evt.device_type()).endswith("CPU") \
        and not evt.is_user_annotation()


class Trace:
    """Device events of one traced window, read once the window closed.

    ``device``: (name, start_ns, end_ns) of every kernel, copy and fill
    that ran inside the window; ``busy_s``: the union of their intervals;
    ``window_s``: the window's length."""

    def __init__(self):
        self.device: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        self.window_ns = (0, 0)
        self.busy_s = 0.0
        self.window_s = 0.0
        self._union: List[Tuple[int, int]] = []

    @contextmanager
    def window(self, torch):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            with record_function(WINDOW_LABEL):
                yield self
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self._read(prof)

    def _read(self, prof) -> None:
        events = prof.profiler.kineto_results.events()
        win = None
        host, device = [], []
        for e in events:
            name = e.name()
            start = int(e.start_ns())
            end = start + int(e.duration_ns())
            if _on_device(e):
                device.append((name, start, end))
            elif str(e.device_type()).endswith("CPU"):
                if name == WINDOW_LABEL:
                    win = (start, end)
                else:
                    host.append((name, start, end))
        if win is None:
            raise RuntimeError("the profiler lost the window's range")
        lo, hi = win
        self.window_ns = win
        self.window_s = (hi - lo) / 1e9
        self.device = sorted(((n, max(s, lo), min(t, hi))
                              for n, s, t in device if t > lo and s < hi),
                             key=lambda x: x[1])
        self.host = [(n, s, t) for n, s, t in host if t > lo and s < hi]
        union: List[Tuple[int, int]] = []
        for _, s, t in self.device:
            if union and s <= union[-1][1]:
                if t > union[-1][1]:
                    union[-1] = (union[-1][0], t)
            else:
                union.append((s, t))
        self._union = union
        self.busy_s = sum(t - s for s, t in union) / 1e9

    # -- readings ---------------------------------------------------------
    def device_seconds(self, match) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(t - s for n, s, t in self.device if match(n)) / 1e9

    def device_count(self, match=lambda n: True) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def top_device_ops(self, k: int = 10) -> List[List]:
        total: Dict[str, float] = {}
        for n, s, t in self.device:
            total[n] = total.get(n, 0.0) + (t - s) / 1e9
        top = sorted(total.items(), key=lambda kv: -kv[1])[:k]
        return [[short_name(n), sec] for n, sec in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The k longest stretches of the window with no device event,
        each named by the innermost host op running at its start."""
        lo, hi = self.window_ns
        edges, prev = [], lo
        for s, t in self._union:
            if s > prev:
                edges.append((s - prev, prev))
            prev = max(prev, t)
        if hi > prev:
            edges.append((hi - prev, prev))
        gaps = sorted(edges, reverse=True)[:k]
        starts = sorted(g[1] for g in gaps)
        label = {s: ("", -1) for s in starts}
        for name, s, t in self.host:
            i = bisect.bisect_left(starts, s)
            while i < len(starts) and starts[i] < t:
                at = starts[i]
                if s > label[at][1]:
                    label[at] = (name, s)
                i += 1
        return [[short_name(label[start][0] or "host idle"), length / 1e9]
                for length, start in gaps]


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type and parameter list, at
    most ``limit`` characters."""
    out = name[5:] if name.startswith("void ") else name
    if out.endswith(")") and not out.startswith("("):
        depth = 0
        for i in range(len(out) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(out[i], 0)
            if depth == 0:
                out = out[:i] if i > 0 else out
                break
    return out[:limit]
