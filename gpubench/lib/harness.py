"""One run of one cell: set-up, the measured window (traced or not), the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
driver, ``drivers/<driver>.py``), ``limits/<cell>.json`` and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import sys
import time
import types
from typing import Dict, Optional

from gpubench.lib.common import BENCH, Spans, load_json, load_module
from gpubench.lib.peaks import peaks_for
from gpubench.lib.trace import Trace


def find_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                   + ", ".join(c["name"] for c in bench["workloads"]))


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(metric: str):
    """``metrics/<metric>.py``, or for a metric split by the end-to-end
    metric it moves (``<base>.<part>``) without a file of its own,
    ``metrics/<base>.py``."""
    own = BENCH / "metrics" / f"{metric}.py"
    return own if own.is_file() \
        else BENCH / "metrics" / f"{metric.split('.')[0]}.py"


def cell_files(cell: Dict) -> Dict:
    """The configuration, the traffic mix and the limits of a cell."""
    return {
        "config": load_json(BENCH / "configs" / f"{cell['config']}.json"),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(BENCH / "limits" / f"{cell['name']}.json"),
    }


class Context:
    """What a driver is handed: the cell's files, the run's arguments, the
    device, and the harness's spans."""

    def __init__(self, cell: Dict, files: Dict, *, seed: int, seconds: float,
                 trace: bool, device: str, torch):
        self.cell = cell
        self.config = files["config"]
        self.traffic = files["traffic"]
        self.limits = files["limits"]
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.torch = torch
        self.spans = Spans()

    @property
    def on_card(self) -> bool:
        return self.torch.device(self.device).type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)


def _allocator_counts(torch) -> Dict[str, int]:
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in
            ("num_device_alloc", "num_device_free", "num_alloc_retries")}


def _checks(readings: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    if set(readings) != set(limits):
        raise KeyError(f"readings {sorted(readings)} against limits "
                       f"{sorted(limits)}")
    return {name: {"value": float(readings[name]),
                   "limit": float(limits[name]["limit"])}
            for name in limits}


def run_cell(bench: Dict, name: str, *, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             files: Optional[Dict] = None, driver_hook=None) -> Dict:
    """Run cell ``name`` once and return its result line (a dict).

    ``files`` replaces the cell's configuration, traffic and limits (the
    CPU tests run tiny sizes through it); ``driver_hook(driver, state)``
    may break the program under the timed path before the window (the
    fault tests)."""
    import torch

    cell = find_cell(bench, name)
    files = files or cell_files(cell)
    ctx = Context(cell, files, seed=seed, seconds=seconds, trace=trace,
                  device=device, torch=torch)
    driver = load_module(BENCH / "drivers" / f"{ctx.traffic['driver']}.py")
    state = driver.setup(ctx)
    if driver_hook is not None:
        driver_hook(driver, state)
    ctx.sync()
    setup_s = time.perf_counter() - t_start

    tracer = Trace() if trace else None
    alloc = _allocator_counts(torch) if ctx.on_card else None
    t_window = time.perf_counter()
    if tracer is not None:
        with tracer.window(torch):
            record = driver.window(state, ctx)
    else:
        record = driver.window(state, ctx)
    t_closed = time.perf_counter()
    if alloc is not None:
        now = _allocator_counts(torch)
        print("gpubench: allocator calls in the window: "
              + ", ".join(f"{k} {now[k] - alloc[k]}" for k in alloc),
              file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(device)) if ctx.on_card else 0
    kind = torch.cuda.get_device_name(device) if ctx.on_card else "cpu"

    checks = _checks(driver.check(state, record, ctx), ctx.limits)
    t_checked = time.perf_counter()
    correct = record["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())

    metrics: Dict[str, Dict] = {}
    if tracer is None:
        values = dict(record["end_to_end"], setup_s=setup_s)
        for m in bench["end_to_end"]:
            if applies(m, name):
                if m["name"] not in values:
                    raise KeyError(f"{name}: the driver gave no {m['name']}")
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        view = types.SimpleNamespace(trace=tracer, spans=ctx.spans,
                                     record=record, config=ctx.config,
                                     traffic=ctx.traffic, cell=name,
                                     peaks=peaks_for(kind))
        for m in bench["per_layer"]:
            if applies(m, name):
                reader = load_module(reader_path(m["name"]))
                value = reader.read(view)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}

    print(f"gpubench: {name} seed {seed}: set-up {setup_s:.3f} s, window "
          f"{record['window_s']:.3f} s (with the trace's reading "
          f"{t_closed - t_window:.3f} s), check "
          f"{t_checked - t_closed:.3f} s, metrics "
          f"{time.perf_counter() - t_checked:.3f} s", file=sys.stderr)
    dev = {"platform": "gpu" if ctx.on_card else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics,
              "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.busy_s
        dev["window_s"] = tracer.window_s
        result["breakdown"] = {"device_ops": tracer.top_device_ops(),
                               "idle_gaps": tracer.idle_gaps()}
    result["checks"] = checks
    return result
