"""The check decides ``correct``: a run with the timed path broken
underneath (after set-up, before the window) comes out not correct, once
for each fault the cells can have.  One card: no exchange between chips
to leave out."""
import time

import pytest
import torch

import tiny
from gpubench.lib import harness
from gpubench.lib.common import ROOT, load_json

SERVE = "granite-moe-3b.prefill-2k"
DDM = "ddm-paper.match-a100"


def _run(cell, files, hook, seed=2**31 + 3):
    bench = load_json(ROOT / "BENCHMARK.json")
    return harness.run_cell(bench, cell, seed=seed, seconds=0.3, trace=False,
                            device="cpu", t_start=time.perf_counter(),
                            files=files, driver_hook=hook)


def _serve_fault(kind, monkeypatch):
    from repro_torch.models import moe, transformer
    from repro_torch.serve import engine

    real_moe, real_unembed = moe.moe_layer, transformer.unembed

    def hook(driver, state):
        if kind == "state_unchanged":       # the expert layer adds nothing
            monkeypatch.setattr(moe, "moe_layer", lambda p, x, *a, **k: (
                torch.zeros_like(x), real_moe(p, x, *a, **k)[1]))
        elif kind == "half_batch":          # the second half of the rows
            def half(p, x, *a, **k):        # gets the first half's output
                out, aux = real_moe(p, x, *a, **k)
                h = x.shape[0] // 2
                return torch.cat([out[:h], out[:h]]), aux
            monkeypatch.setattr(moe, "moe_layer", half)
        elif kind == "token_altered":       # the served token, as produced
            real_argmax = engine.ServeEngine._argmax
            monkeypatch.setattr(engine.ServeEngine, "_argmax",
                                lambda self, lg: real_argmax(self, lg) + 1)
        elif kind == "answer_altered":      # the logits, as produced
            monkeypatch.setattr(transformer, "unembed",
                                lambda *a, **k: real_unembed(*a, **k) * 1.2)
    return hook


@pytest.mark.parametrize("kind", ["none", "state_unchanged", "half_batch",
                                  "token_altered", "answer_altered"])
def test_serving_faults_are_not_correct(kind, monkeypatch):
    r = _run(SERVE, tiny.decoder_files(SERVE), _serve_fault(kind,
                                                             monkeypatch))
    assert r["correct"] is (kind == "none"), r["checks"]


def _ddm_fault(kind, monkeypatch):
    from repro_torch import core
    from repro_torch.kernels import ops

    real_exec, real_enum = core.execute_enumeration, ops.sbm_enumerate_kernel
    last = {}

    def stale(*a, **k):                     # the previous call's answer
        out = real_exec(*a, **k)
        prev = last.get("out", out)
        last["out"] = out
        return prev

    def half(*a, **k):                      # half of the pairs left out
        pairs, count = real_enum(*a, **k)
        pairs = pairs.clone()
        valid = int((pairs[:, 0] >= 0).sum())
        pairs[valid // 2:valid] = -1
        return pairs, count

    def altered(*a, **k):                   # one pair altered
        pairs, count = real_enum(*a, **k)
        pairs = pairs.clone()
        pairs[0, 1] += 1
        return pairs, count

    def hook(driver, state):
        if kind == "state_unchanged":
            monkeypatch.setattr(core, "execute_enumeration", stale)
        elif kind == "half_batch":
            monkeypatch.setattr(ops, "sbm_enumerate_kernel", half)
        elif kind == "answer_altered":
            monkeypatch.setattr(ops, "sbm_enumerate_kernel", altered)
    return hook


@pytest.mark.parametrize("kind", ["none", "state_unchanged", "half_batch",
                                  "answer_altered"])
def test_matching_faults_are_not_correct(kind, monkeypatch):
    files = tiny.ddm_files()
    files["traffic"]["check_placements"] = files["traffic"]["placements"]
    r = _run(DDM, files, _ddm_fault(kind, monkeypatch))
    assert r["correct"] is (kind == "none"), r["checks"]
