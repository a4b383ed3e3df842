"""Each driver runs one tiny window on the CPU through the harness's
test-only entry (``run_cell`` with ``device="cpu"`` and tiny files); the
command itself refuses to run without a card."""
import os
import shutil
import subprocess
import sys
import time

import pytest

import tiny
from gpubench.lib import harness
from gpubench.lib.common import ROOT, load_json

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


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_tiny_window_runs_on_the_cpu(bench, cell, trace):
    r = harness.run_cell(bench, cell, seed=2**31 + 11, seconds=0.3,
                         trace=bool(trace), device="cpu",
                         t_start=time.perf_counter(), files=CELLS[cell]())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert "breakdown" in r
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if harness.applies(m, cell)}
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_one_seed_gives_the_same_inputs(bench):
    cell = "ddm-paper.match-a100"
    a = harness.run_cell(bench, cell, seed=7, seconds=0.05, trace=False,
                         device="cpu", t_start=time.perf_counter(),
                         files=tiny.ddm_files())
    b = harness.run_cell(bench, cell, seed=7, seconds=0.05, trace=False,
                         device="cpu", t_start=time.perf_counter(),
                         files=tiny.ddm_files())
    assert a["checks"] == b["checks"]


def _cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "ddm-paper.match-a100", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    out = _cli(ROOT)
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_an_unknown_workload_is_refused():
    bad = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0 and bad.stdout == ""
