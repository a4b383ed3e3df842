"""The readers of the program's own spans and counters
(``lib/program.py`` and the six metrics over it) on tiny CPU windows.

* A traced tiny window of each cell runs every new reader, and each
  returns None there: the CPU trace holds no device event.
* Two traced windows in one process: the second window's records are
  its own (the store is read, never reset), and with a stand-in device
  event the readers compute from them alone.
* The interval arithmetic the idle and launch readers share.
"""
import time
import types

import pytest

import tiny
from gpubench.lib import harness, program
from gpubench.lib.common import BENCH, ROOT, load_json, load_module

NEW = ("engine_idle_ms", "moe_drop_share", "moe_gather_ms", "moe_combine_ms",
       "scan_launches_per_match", "scan_idle_ms")
CELLS = {
    "granite-moe-3b.prefill-2k":
        lambda: tiny.decoder_files("granite-moe-3b.prefill-2k"),
    "granite-moe-3b.prefill-512":
        lambda: tiny.decoder_files("granite-moe-3b.prefill-512",
                                   prompt_len=32, clients=8),
    "ddm-paper.match-a100": tiny.ddm_files,
}


@pytest.fixture(scope="module")
def bench():
    return load_json(ROOT / "BENCHMARK.json")


@pytest.fixture
def readings(monkeypatch):
    """Every metric reader's (view, value), by metric, as run_cell calls
    them."""
    seen = {}
    real = harness.load_module

    def load(path):
        mod = real(path)
        if path.parent.name == "metrics":
            read = mod.read

            def keep(run, read=read, name=path.stem):
                value = read(run)
                seen.setdefault(name, []).append((run, value))
                return value
            mod.read = keep
        return mod

    monkeypatch.setattr(harness, "load_module", load)
    return seen


def _traced(bench, cell, seed):
    return harness.run_cell(bench, cell, seed=seed, seconds=0.3, trace=True,
                            device="cpu", t_start=time.perf_counter(),
                            files=CELLS[cell]())


def _mine(bench, cell):
    return [m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and harness.applies(m, cell)]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_new_reader_runs_and_reads_nothing_on_the_cpu(bench, cell,
                                                            readings):
    r = _traced(bench, cell, 2**31 + 21)
    assert r["correct"] is True
    mine = _mine(bench, cell)
    assert mine and all(readings[name][-1][1] is None for name in mine)
    assert not set(mine) & set(r["metrics"])


def _with_a_device_event(view):
    """The view with one 1-ns device event at the window's start, so that
    the readers take the CPU trace as a card's."""
    lo = view.trace.window_ns[0]
    trace = types.SimpleNamespace(**vars(view.trace))
    trace.device = [("stand-in", lo, lo + 1)]
    return types.SimpleNamespace(**dict(vars(view), trace=trace))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_reader_counts_only_its_own_windows_records(bench, cell, readings):
    from repro_torch.perf import spans

    _traced(bench, cell, 2**31 + 31)
    _traced(bench, cell, 2**31 + 32)
    name = _mine(bench, cell)[0]
    (first, _), (second, _) = readings[name][-2:]
    lo = min(t0 for _, t0, _ in second.spans.items)
    recs, counts = program.window_records(second)
    assert recs and all(r.t0 >= lo for r in recs)
    assert all(c.t >= lo for c in counts)
    old, _ = program.window_records(first)
    assert old and not {id(r) for r in old} & {id(r) for r in recs}
    assert len(spans.snapshot().spans) >= len(old) + len(recs)
    fake = _with_a_device_event(second)
    if cell.startswith("granite"):
        waves = [r for r in recs if r.name == "serve.wave"]
        assert len(waves) == len(second.spans.durations("engine.run"))
        assert len({r.ids["wave"] for r in waves}) == len(waves)
        tr = second.traffic
        k = second.config["num_experts_per_tok"]
        layers = second.config["num_hidden_layers"]
        want = len(waves) * int(tr["clients"]) * int(tr["prompt_len"]) \
            * k * layers
        assert sum(c.value for c in counts if c.name == "moe.records") \
            == want
        dropped = sum(c.value for c in counts if c.name == "moe.dropped")
        drop = load_module(BENCH / "metrics" / "moe_drop_share.py")
        assert drop.read(fake) == pytest.approx(100.0 * dropped / want)
        idle = load_module(BENCH / "metrics" / "engine_idle_ms.py")
        assert idle.read(fake) > 0.0
        # no CUDA event on the CPU: the device ms stay unread
        assert program.device_ms_a_wave(fake, "moe.gather") is None
    else:
        attempts = [r for r in recs if r.name == "plan.attempt"]
        assert len(attempts) == len(second.record["matches"])
        launches = load_module(BENCH / "metrics"
                               / "scan_launches_per_match.py")
        assert launches.read(fake) == 0.0        # no CUDA call on the CPU
        idle = load_module(BENCH / "metrics" / "scan_idle_ms.py")
        assert idle.read(fake) > 0.0


def test_interval_arithmetic():
    assert program.union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [(0, 3),
                                                                (5, 10)]
    a = [(0, 10), (20, 30)]
    assert program.subtract(a, [(2, 4), (8, 22), (25, 26)]) == [
        (0, 2), (4, 8), (22, 25), (26, 30)]
    assert program.subtract(a, []) == a
    assert program.subtract(a, [(-5, 40)]) == []
    assert program.length([(0, 2), (4, 8)]) == 6
    run = types.SimpleNamespace(trace=types.SimpleNamespace(
        device=[("k", 1, 3), ("k", 2, 5), ("k", 12, 13)],
        host=[("cudaLaunchKernel", 1, 2), ("aten::add", 3, 4),
              ("cudaMemsetAsync", 11, 12), ("cudaLaunchKernelExC", 14, 15),
              ("cudaMemcpyAsync", 30, 31)]))
    assert program.device_idle_ns(run, [(0, 10), (11, 14)]) == 1 + 5 + 1 + 1
    assert program.launches_in(run, [(0, 10), (11, 14)]) == 2
    assert program.launches_in(run, [(0, 40)]) == 4
