"""The reader of pass C's list-path share (``metrics/pass_c_list_share.py``)
on tiny CPU windows.

* A traced tiny DDM window runs the reader, and it returns None there and
  leaves the metric out of the line: the CPU trace holds no device event,
  and the port counts pass C's blocks only on the card.
* With a stand-in device event the reader computes from the two pass-C
  counters inside the window alone, the fallback counted as the port
  counts it (a (1,) device int read at the store's snapshot), and reads
  nothing in a window that holds no pass-C block, as on a port without
  the counters.
"""
import time
import types

import pytest

import tiny
from gpubench.lib import harness
from gpubench.lib.common import BENCH, ROOT, load_json, load_module

CELL = "ddm-paper.match-a100"


def _share():
    return load_module(BENCH / "metrics" / "pass_c_list_share.py")


def test_the_reader_runs_and_reads_nothing_on_the_cpu(monkeypatch):
    bench = load_json(ROOT / "BENCHMARK.json")
    (metric,) = [m for m in bench["per_layer"]
                 if m["name"] == "pass_c_list_share"]
    assert harness.applies(metric, CELL)
    seen = []
    real = harness.load_module

    def load(path):
        mod = real(path)
        if path.parent.name == "metrics" and path.stem == metric["name"]:
            read = mod.read

            def keep(run, read=read):
                value = read(run)
                seen.append(value)
                return value
            mod.read = keep
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    r = harness.run_cell(bench, CELL, seed=2**31 + 41, seconds=0.3,
                         trace=True, device="cpu",
                         t_start=time.perf_counter(), files=tiny.ddm_files())
    assert r["correct"] is True
    assert seen and all(value is None for value in seen)
    assert metric["name"] not in r["metrics"]


def _window(lo, hi):
    """A run view whose window is [lo, hi] and whose trace holds one
    stand-in device event, so that the reader takes it as a card's."""
    return types.SimpleNamespace(
        spans=types.SimpleNamespace(items=[("w", lo, hi)]),
        trace=types.SimpleNamespace(device=[("k", 0, 1)]))


def test_the_reader_counts_only_its_windows_counters():
    import torch
    from repro_torch.perf import spans

    share = _share()
    spans.enable()
    try:
        spans.count("sweep.pass_c_blocks", 1000)          # before the window
        spans.count("sweep.pass_c_fallback_blocks", 1000)
        t0 = time.perf_counter()
        for blocks, fallback in ((489, 0), (489, 3)):
            spans.count("sweep.pass_c_blocks", blocks)
            spans.count("sweep.pass_c_fallback_blocks",
                        torch.tensor([fallback], dtype=torch.int32))
        t1 = time.perf_counter()
    finally:
        spans.disable()
    assert share.read(_window(t0, t1)) == pytest.approx(
        100.0 * (1 - 3 / 978))
    later = time.perf_counter()
    assert share.read(_window(later, later + 1.0)) is None


@pytest.mark.parametrize("fallback, want", [(0, 100.0), (489, 0.0)])
def test_the_share_spans_every_block_listed_to_none(fallback, want):
    from repro_torch.perf import spans

    spans.enable()
    try:
        t0 = time.perf_counter()
        spans.count("sweep.pass_c_blocks", 489)
        spans.count("sweep.pass_c_fallback_blocks", fallback)
        t1 = time.perf_counter()
    finally:
        spans.disable()
    assert _share().read(_window(t0, t1)) == pytest.approx(want)
