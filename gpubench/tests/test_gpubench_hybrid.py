"""The hybrid cell (``granite-4.0-h-small.prefill-4k``) on the CPU at tiny
sizes: its driver through the harness, its check against the program and
each of the driver's controls, its reference's imports, its four new
per-layer readers on a synthetic span store, and its operation count by
hand."""
import time
import types

import pytest

import tiny_hybrid
from gpubench.lib import harness, hybrid, hybrid_arith
from gpubench.lib.common import (BENCH, FORBIDDEN_IN_REFERENCE, ROOT, Spans,
                                 load_json, load_module)

CELL = tiny_hybrid.CELL


@pytest.fixture(scope="module")
def bench():
    return load_json(ROOT / "BENCHMARK.json")


def _run(bench, files, *, trace=False, hook=None, seed=2**31 + 41,
         seconds=0.3):
    return harness.run_cell(bench, CELL, seed=seed, seconds=seconds,
                            trace=trace, device="cpu",
                            t_start=time.perf_counter(), files=files,
                            driver_hook=hook)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_window_runs_on_the_cpu(bench, trace):
    r = _run(bench, tiny_hybrid.hybrid_files(), trace=bool(trace))
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"logit_err", "kv_err", "attn_err",
                                "state_err", "state_worst_row",
                                "token_gap_excess"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        new = {"ssd_ms", "ssd_scan_launches_per_wave", "moe_shared_ms",
               "hybrid_prefill_mfu"}
        assert not new & set(r["metrics"])        # no card, no peaks
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if harness.applies(m, CELL)}
        assert set(r["metrics"]) == want == {"prefill_tokens_per_s",
                                             "ttft_p95_ms", "setup_s"}


def _driver():
    return load_module(BENCH / "drivers" / "serve_prefill_hybrid.py")


# a width and depth at which every control fails the cell's limits on the
# CPU, as on the card: d 256 (8 Mamba heads), the whole period of 10
# layers, 4 rows of 128 tokens a wave (at d 128 the fp8 control's errors
# stay under the full size's limits: its scales cover fewer channels)
SEPARATING = dict(hidden=256, prompt_len=128, clients=4, slots=4)


@pytest.mark.parametrize("control", ["program", "fp8", "head_norm",
                                     "no_shared", "rope", "scale"])
def test_the_check_fails_under_each_control(bench, control):
    hook = None if control == "program" else _driver().CONTROLS[control]
    r = _run(bench, tiny_hybrid.hybrid_files(**SEPARATING), hook=hook,
             seconds=0.2)
    assert r["correct"] is (control == "program"), r["checks"]
    assert r["failed"] == 0


def test_the_sample_copied_into_buffers_is_serve_prefills():
    """The driver's sample of the window's waves, copied into buffers of
    set-up, keeps the waves, logits and caches that ``serve_prefill``'s
    keeps by reference, for the same keys."""
    import numpy as np
    import torch
    from gpubench.drivers import serve_prefill

    tr = {"logit_waves": 4, "kv_waves": 2}

    def state(**kw):
        rng = np.random.Generator(np.random.PCG64(7))
        return serve_prefill.State(sample={}, waves_seen=0, rng=rng, **kw)

    ref = state()
    got = state(tapped_all=True,
                free_logit=[(torch.empty(1, 3, dtype=torch.int64),
                             torch.empty(1, 1, 5)) for _ in range(4)],
                free_kv=[({"layer0": (torch.empty(2),)}, [torch.empty(2)])
                         for _ in range(2)])
    for w in range(40):
        tokens = torch.full((1, 3), w)
        logits = torch.full((1, 1, 5), float(w))
        cache = {"layer0": (torch.full((2,), float(w)),)}
        serve_prefill._keep(ref, tr, tokens, cache, logits)
        _driver()._keep(got, tr, tokens, cache, [cache["layer0"][0]],
                        logits)
    assert sorted(ref.sample) == sorted(got.sample) and got.tapped_all
    assert sum(e[2] is not None for e in got.sample.values()) == 2
    for key, (wi, tokens, cache, logits) in ref.sample.items():
        wj, tok, kept, log = got.sample[key]
        assert wi == wj and torch.equal(tok, tokens)
        assert torch.equal(log, logits) and (kept is None) == (cache is None)
        if kept is not None:
            assert float(kept[0]["layer0"][0][0]) == float(kept[1][0][0]) \
                == wi


def test_the_reference_imports_nothing_of_the_port():
    import ast
    path = BENCH / "reference" / "hybrid_decoder.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "math", "typing", "torch"}
    assert not names & set(FORBIDDEN_IN_REFERENCE)


def _reader(name):
    return load_module(harness.reader_path(name))


def _synthetic_run(monkeypatch, waves=2):
    """A traced window of ``waves`` waves of 2 × 64 tokens on a stand-in
    card: the program's store holds, a wave, 9 ``mamba.ssd`` spans of 3
    ms and 10 ``moe.shared`` spans of 0.5 ms, and the profiler's host
    events two ``mamba.scan`` ranges a wave with 5 launches inside and
    one outside."""
    from repro_torch.perf import spans

    def rec(name, t, ms=None):
        return spans.SpanRecord(name, None, {}, t, t + 0.001, ms)

    records, host = [], []
    for w in range(waves):
        t = 1.0 + w
        records.append(rec("serve.wave", t))
        records += [rec("mamba.ssd", t, 3.0) for _ in range(9)]
        records += [rec("moe.shared", t, 0.5) for _ in range(10)]
        base = int(t * 1e9)
        for lo in (base, base + 1000):
            host.append(("mamba.scan", lo, lo + 500))
            host += [("cudaLaunchKernel", lo + 10 * i, lo + 10 * i + 5)
                     for i in range(1, 6)]
        host.append(("cudaMemcpyAsync", base + 700, base + 710))
    records.append(rec("mamba.ssd", 99.0, 1e6))           # after the window
    snap = spans.Snapshot(records, [], 0)
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    harness_spans = Spans()
    harness_spans.items = [("engine.run", 0.5, 0.5 + waves + 0.5)]
    trace = types.SimpleNamespace(device=[("k", 0, 5)], host=host,
                                  window_s=float(waves))
    return types.SimpleNamespace(
        trace=trace, spans=harness_spans, record={"waves": [(2, 64)] * waves},
        config=tiny_hybrid.hybrid_files()["config"],
        peaks={"bf16_flops_per_s": 1e12})


def test_the_new_readers_on_a_synthetic_store(monkeypatch):
    run = _synthetic_run(monkeypatch)
    assert _reader("ssd_ms").read(run) == pytest.approx(27.0)
    assert _reader("moe_shared_ms").read(run) == pytest.approx(5.0)
    assert _reader("ssd_scan_launches_per_wave").read(run) == 10.0
    flops = hybrid_arith.prefill_flops(run.config, 2, 64)
    assert _reader("hybrid_prefill_mfu").read(run) \
        == pytest.approx(100.0 * 2 * flops / (2.0 * 1e12))


def test_the_new_readers_read_nothing_without_a_card(monkeypatch):
    run = _synthetic_run(monkeypatch)
    run.trace.device = []
    for name in ("ssd_ms", "moe_shared_ms", "ssd_scan_launches_per_wave"):
        assert _reader(name).read(run) is None, name
    run.peaks = None
    assert _reader("hybrid_prefill_mfu").read(run) is None


def test_the_operation_count_by_hand():
    """d 64, Mamba-2 4 heads of 32 (d_inner 128), state 16, attention 4 q
    / 2 KV heads of 16, 8 experts top-2 of width 32, shared width 32,
    vocabulary 515; 9 Mamba-2 layers and 1 attention layer."""
    cfg = tiny_hybrid.hybrid_files()["config"]
    mamba = 64 * (2 * 128 + 2 * 16 + 4) + 128 * 64             # 26,880
    attn = 64 * 64 + 2 * 64 * 32 + 64 * 64                     # 12,288
    moe = 64 * 8 + 3 * 2 * 64 * 32 + 3 * 64 * 32               # 18,944
    assert hybrid_arith.matmul_params_per_token(cfg) \
        == 9 * mamba + attn + 10 * moe == 443_648
    want = 2 * 443_648 * 128 + 4 * 16 * (64 * 65 // 2) * 2 * 4 \
        + 4 * 16 * 32 * 4 * 128 * 9 + 2 * 64 * 515 * 2
    assert hybrid_arith.prefill_flops(cfg, 2, 64) == want == 124_207_872


def test_the_operation_count_follows_the_ports_parameters():
    """At the published widths: the port's active parameters a token
    less what no product multiplies (embedding, norms, conv, biases, A,
    D) and with the whole router (the port counts k of its E columns)."""
    import numpy as np
    from repro_torch.models.api import iter_leaves
    from repro_torch.models.transformer import model_defs

    cfg = load_json(BENCH / "configs" / "granite-4.0-h-small.json")
    mc = hybrid.model_config(cfg)
    products = 0
    for path, d in iter_leaves(model_defs(mc)):
        leaf = path.split("/")[-1]
        if d.init not in ("normal",) or leaf.startswith("conv"):
            continue
        size = int(np.prod(d.shape))
        if "experts" in d.axes and leaf != "router":
            size = size // mc.num_experts * mc.num_experts_per_token
        products += size
    assert products == hybrid_arith.matmul_params_per_token(cfg)
