"""The port's spans and counters (``repro_torch.perf.spans``) on the CPU.

* Inactive (no profiler, not enabled): a tiny ``ServeEngine`` wave and a
  tiny planned match record nothing and open no ``record_function``
  range; an inactive span is one shared object (no allocation, no CUDA
  event), and ``timed=True`` still gives its host seconds.
* Under a CPU ``torch.profiler`` session: every span of the wave (engine
  and MoE) and of the match (planner and sweep) is in the profiler's
  host events, nests under the span listed, and the spans of one wave or
  one match carry one id.
* ``moe.dropped / moe.records`` equals the layer's ``moe_drop_fraction``.
* ``MatchStats.phase_seconds`` holds ``emit`` and ``probe`` from the
  spans, active or not.
* The bounded store counts what it drops.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import ddim, runtime
from repro_torch.core.intervals import make_uniform_workload
from repro_torch.kernels import ops
from repro_torch.models import Model, moe
from repro_torch.perf import spans
from repro_torch.serve.engine import Request, ServeEngine

GRANITE = "granite-moe-3b-a800m"

# each span of a path and the spans it opens inside (None: outermost)
_IN_STEP = ("serve.prefill", "serve.decode")
WAVE_SPANS = {
    "serve.wave": (None,), "serve.admit": ("serve.wave",),
    "serve.upload": ("serve.wave",), "serve.init_cache": ("serve.wave",),
    "serve.prefill": ("serve.wave",), "serve.sample": ("serve.wave",),
    "serve.decode": ("serve.wave",),
    "moe.route": _IN_STEP, "moe.dispatch": _IN_STEP,
    "moe.gather": _IN_STEP, "moe.experts": _IN_STEP,
    "moe.combine": _IN_STEP,
}
MATCH_SPANS = {
    "sweep.count": (None,), "plan.attempt": (None,),
    **{name: ("plan.attempt",) for name in (
        "sweep.passes_ab", "sweep.segment_max", "sweep.bitmasks",
        "sweep.scan", "sweep.pass_c", "sweep.stitch")},
}


@pytest.fixture(autouse=True)
def clean_store():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _granite(capacity_factor=8.0):
    return dataclasses.replace(reduce_config(get_config(GRANITE)),
                               moe_capacity_factor=capacity_factor)


def _wave():
    """One engine wave of two 8-token prompts, two tokens each (a prefill
    and a decode step) on a tiny granite."""
    model = Model(_granite(), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = ServeEngine(model, params, num_slots=2, max_len=16, device="cpu")
    for rid in (7, 9):
        eng.submit(Request(rid, list(range(1 + rid, 9 + rid)), 2))
    out = eng.run()
    assert sorted(out) == [7, 9] and all(len(r.tokens) == 2
                                         for r in out.values())
    return {"wave": 0, "requests": [7, 9]}


def _match():
    """``sweep.count``, then the planned enumeration on the sweep kernels'
    plain versions (as the service's rebuild runs them)."""
    subs, upds = make_uniform_workload(
        300, 300, 20.0, generator=torch.Generator().manual_seed(3),
        device="cpu")
    k = int(ops.sbm_count_kernel(subs, upds))
    _, count, stats = runtime.execute_enumeration(
        lambda s, u, *, max_pairs: ops.sbm_enumerate_kernel(
            s, u, max_pairs=max_pairs, block_size=64),
        subs, upds, estimate=k)
    assert int(count) == k > 0 and stats.retries == 0
    return {"capacity": stats.capacity}


PATHS = {"wave": (_wave, WAVE_SPANS), "match": (_match, MATCH_SPANS)}


def test_inactive_spans_record_nothing_and_open_no_range(monkeypatch):
    import torch.autograd.profiler as prof
    calls = []
    real = prof.record_function
    monkeypatch.setattr(prof, "record_function",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event", None)      # any event would fail
    assert not spans.active()
    _wave()
    _match()
    snap = spans.snapshot()
    assert calls == [] and snap.spans == [] and snap.counts == []
    # no object, range or event a call: every inactive span is one object
    one = spans.span("a", device=True, wave=1)
    assert one is spans.span("b") and one.seconds == 0.0
    with spans.span("c", timed=True) as t:
        sum(range(1000))
    assert t.seconds > 0.0
    spans.count("moe.dropped", torch.tensor(3))
    assert spans.snapshot().counts == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_span_is_in_the_profiler_and_nests(path):
    run, want = PATHS[path]
    with profile(activities=[ProfilerActivity.CPU]) as p:
        ids = run()
    assert not spans.active()
    host = {e.name for e in p.events()}
    assert set(want) <= host, sorted(set(want) - host)
    recs = spans.snapshot().spans
    assert {r.name for r in recs} == set(want)
    for r in recs:
        assert r.parent in want[r.name], r
        assert r.t0 <= r.t1 and r.device_ms is None     # no CUDA path
    assert {(r.name, r.parent) for r in recs} == {
        (name, up) for name, ups in want.items() for up in ups}
    if path == "wave":
        # every span of the wave (the MoE's inside its steps) has its id,
        # and those after the admission its requests' ids too
        for r in recs:
            assert r.ids == (ids if r.name != "serve.admit"
                             else {"wave": ids["wave"]}), r
    else:
        inner = [r for r in recs if r.name != "sweep.count"]
        assert len({r.ids["match"] for r in inner}) == 1
        assert all(r.ids["capacity"] == ids["capacity"] for r in inner)
        assert [r.ids for r in recs if r.name == "sweep.count"] == [{}]


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5, 8.0])
def test_drop_counter_equals_the_layers_drop_fraction(capacity_factor):
    cfg = _granite(capacity_factor)
    g = torch.Generator().manual_seed(1)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = {"router": torch.randn(d, e, generator=g),
              "w_gate": torch.randn(e, d, f, generator=g) / d ** 0.5,
              "w_up": torch.randn(e, d, f, generator=g) / d ** 0.5,
              "w_down": torch.randn(e, f, d, generator=g) / f ** 0.5}
    x = torch.randn(2, 24, d, generator=g)
    spans.enable()
    _, aux = moe.moe_layer(params, x, cfg)
    snap = spans.snapshot()
    total = {n: sum(c.value for c in snap.counts if c.name == n)
             for n in ("moe.records", "moe.dropped")}
    assert total["moe.records"] == 2 * 24 * cfg.num_experts_per_token
    assert total["moe.dropped"] / total["moe.records"] == pytest.approx(
        float(aux["moe_drop_fraction"]), abs=1e-6)
    assert (total["moe.dropped"] > 0) == (capacity_factor < 1.0)
    assert {r.name for r in snap.spans} == {
        "moe.route", "moe.dispatch", "moe.gather", "moe.experts",
        "moe.combine"}


@pytest.mark.parametrize("active", [False, True])
def test_match_stats_phases_come_from_the_spans(active):
    if active:
        spans.enable()
    subs, upds = make_uniform_workload(
        200, 200, 10.0, generator=torch.Generator().manual_seed(5),
        device="cpu")
    _, count, stats = ddim.enumerate_matches_ddim_planned(subs, upds)
    assert set(stats.phase_seconds) == {"probe", "emit"}
    assert all(s > 0.0 for s in stats.phase_seconds.values())
    names = [r.name for r in spans.snapshot().spans]
    assert ("plan.probe" in names and "plan.attempt" in names) == active
    if active:
        probe = next(r for r in spans.snapshot().spans
                     if r.name == "plan.probe")
        assert stats.phase_seconds["probe"] == pytest.approx(
            probe.t1 - probe.t0)


def test_the_bounded_store_counts_what_it_drops():
    store = spans.Store(limit=3)
    store.enabled = True
    with store.span("outer", wave=4):
        for i in range(4):
            with store.span("inner", i=i):
                store.count("n", i)
    snap = store.snapshot()
    assert len(snap.spans) + len(snap.counts) == 3
    assert snap.dropped == 4 + 4 + 1 - 3
    assert [c.ids for c in snap.counts] == [{"wave": 4, "i": 0},
                                            {"wave": 4, "i": 1}]
    store.reset()
    assert store.snapshot() == spans.Snapshot([], [], 0)
