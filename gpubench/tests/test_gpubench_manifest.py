"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by its name."""
import json
import re

import pytest

from gpubench.lib import harness
from gpubench.lib.common import BENCH, ROOT, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.fixture(scope="module")
def bench():
    return load_json(ROOT / "BENCHMARK.json")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "gpubench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    # a full check of 24 cells fits the driver's 43,200 seconds
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
            for k in ("why", "layer", "source"):
                if k in entry:
                    assert _line(entry[k]), (entry["name"], k)
    assert len(names) == len(set(names))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}


def test_configs_are_files_under_paths(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        data = load_json(ROOT / c["file"])
        assert data["name"] == c["name"]
        assert data["source"].startswith(c["source"][:40]) \
            or c["source"] == data["source"]
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank", "_size")), key


def test_every_cell_finds_its_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        pair = (w["config"], w["traffic"])
        assert pair not in pairs
        pairs.add(pair)
        traffic = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        limits = load_json(BENCH / "limits" / f"{w['name']}.json")
        for name, entry in limits.items():
            assert NAME.match(name) and entry["limit"] >= 0
    assert sum(w["chips"] == 4 for w in bench["workloads"]) \
        <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = w["name"]
        mine = [m["name"] for m in bench["end_to_end"] if _applies(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(_applies(m, cell) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert harness.reader_path(m["name"]).is_file(), m["name"]
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert _applies(moved, cell), (m["name"], cell)
    layers = {m["layer"] for m in bench["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer
