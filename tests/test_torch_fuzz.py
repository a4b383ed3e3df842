"""The port's fuzz, metamorphic and shrink harness against the JAX
package's (``repro.testing``): the same corpus and churn scripts bit for
bit from one seed, the same shrinks, artifacts with the same fields, the
relations and the batch split on every port engine, and the harness's own
teeth (the injected tie bug caught and shrunk as the JAX harness shrinks
it).  Everything runs on ``cpu`` tensors, where the kernel engines take
their plain versions."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.intervals import Extents as JExtents
from repro.testing import conformance as jconformance
from repro.testing import fuzz as jfuzz
from repro.testing import oracles as joracles
from repro.testing import shrink as jshrink
from repro_torch.core.intervals import Extents
from repro_torch.testing import conformance, fuzz, metamorphic, oracles
from repro_torch.testing.shrink import (ReproArtifact, shrink_script,
                                        shrink_workload)

jax.config.update("jax_platform_name", "cpu")

CPU = "cpu"
ENGINE_NAMES = sorted(conformance.all_engines())
# seeds of the tie-bug run through both harnesses (the JAX test runs 12;
# the JAX harness's eager sweep makes each seed cost seconds here)
TIE_BUG_SEEDS = 6


def _bits(x) -> np.ndarray:
    a = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_extents(j, t) -> None:
    for a, b in ((j.lo, t.lo), (j.hi, t.hi)):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))


def _jax_extents(lo, hi, d):
    lo = np.asarray(lo, np.float32).reshape(d, -1)
    hi = np.asarray(hi, np.float32).reshape(d, -1)
    if d == 1:
        lo, hi = lo[0], hi[0]
    return JExtents(jnp.asarray(lo), jnp.asarray(hi))


def _port_extents(lo, hi, d):
    lo = np.asarray(lo, np.float32).reshape(d, -1)
    hi = np.asarray(hi, np.float32).reshape(d, -1)
    if d == 1:
        lo, hi = lo[0], hi[0]
    return Extents(torch.from_numpy(np.ascontiguousarray(lo)),
                   torch.from_numpy(np.ascontiguousarray(hi)))


# ---------------------------------------------------------------------------
# corpus and scripts: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", (1, 2, 3))
@pytest.mark.parametrize("corpus", sorted(fuzz.CORPUS))
def test_corpus_equals_jax_bit_for_bit(corpus, d):
    assert list(fuzz.CORPUS) == list(jfuzz.CORPUS)
    for seed in (0, 5, 77):
        for n, m in ((1, 1), (3, 8), (34, 21)):
            r_j, r_t = (np.random.RandomState(seed) for _ in range(2))
            js, ju = jfuzz.CORPUS[corpus](r_j, n, m, d)
            ts, tu = fuzz.CORPUS[corpus](r_t, n, m, d, device=CPU)
            _same_extents(js, ts)
            _same_extents(ju, tu)
            # the generator stream is left in the same state
            assert r_j.randint(2**31) == r_t.randint(2**31)


@pytest.mark.parametrize("seed,dims", [(0, 1), (3, 1), (6, 2), (9, 3)])
def test_random_script_equals_jax(seed, dims):
    got = fuzz.random_script(np.random.RandomState(seed), dims, 8, 6)
    want = jfuzz.random_script(np.random.RandomState(seed), dims, 8, 6)
    enc = jshrink.ReproArtifact.from_script
    assert enc("x", 0, "", dims, got).script \
        == enc("x", 0, "", dims, want).script
    assert conformance.check_churn_script(got, dims, device=CPU) == []


# ---------------------------------------------------------------------------
# shrinking: the same minimum as the JAX package's
# ---------------------------------------------------------------------------

def _witness_workload():
    rng = np.random.RandomState(3)
    lo_s = rng.randint(0, 50, 16).astype(np.float32)
    lo_u = rng.randint(0, 50, 16).astype(np.float32)
    return lo_s, lo_s + 2.5, lo_u, lo_u + 2.0


def test_shrink_workload_equals_jax():
    """A sub-0 witness predicate and the tie-bug predicate, each on both
    packages: the same surviving regions, snapped the same way."""
    lo_s, hi_s, lo_u, hi_u = _witness_workload()

    def witness(s, u):
        return bool(np.any(np.atleast_1d(np.asarray(
            s.lo.numpy() if torch.is_tensor(s.lo) else s.lo)) == lo_s[0]))

    jb = jfuzz.broken_open_interval_engine()
    tb = fuzz.broken_open_interval_engine()
    preds = {
        "witness": (witness, witness),
        "tie_bug": (
            lambda s, u: jb.pairs(s, u) != joracles.reference_pairs(s, u),
            lambda s, u: tb.pairs(s, u) != oracles.reference_pairs(s, u)),
    }
    # the tie bug needs a touching pair: sub 4 ends where upd 7 begins
    hi_s_tie = hi_s.copy()
    hi_s_tie[4] = lo_u[7]
    for name, (jp, tp) in preds.items():
        h = hi_s if name == "witness" else hi_s_tie
        js, ju = jshrink.shrink_workload(_jax_extents(lo_s, h, 1),
                                         _jax_extents(lo_u, hi_u, 1), jp)
        ts, tu = shrink_workload(_port_extents(lo_s, h, 1),
                                 _port_extents(lo_u, hi_u, 1), tp)
        _same_extents(js, ts)
        _same_extents(ju, tu)
    assert ts.size + tu.size <= 2


def test_shrink_script_equals_jax_and_keeps_legality():
    lo, hi = np.zeros(1, np.float32), np.ones(1, np.float32)
    script = [
        ([("sub", 0, lo, hi), ("upd", 0, lo, hi)], [], []),
        ([("sub", 1, lo, hi)], [("sub", 0, lo, hi * 2)], []),
    ]

    def failing_for(runner):
        def failing(sc):
            for adds, moves, removes in sc:
                for side, rid, *_ in moves:
                    if (side, rid) == ("sub", 0):
                        r = runner()
                        for a, m, x in sc:
                            r.apply(a, m, x)
                        return True
            return False
        return failing

    want = jshrink.shrink_script(script, failing_for(
        lambda: jconformance.churn_runner("vector", 1)))
    got = shrink_script(script, failing_for(
        lambda: conformance.churn_runner("vector", 1, device=CPU)))
    enc = jshrink.ReproArtifact.from_script
    assert enc("x", 0, "", 1, got).script == enc("x", 0, "", 1, want).script
    flat = [(s, r) for a, m, _ in got for s, r, *_ in a + m]
    assert ("sub", 0) in flat                    # the add survived
    assert all(rid == 0 for _, rid in flat)      # noise ops dropped


def test_repro_artifact_matches_jax_and_its_snippet_passes():
    lo_s, hi_s, lo_u, hi_u = ([0.0], [1.0], [1.0], [2.0])
    art = ReproArtifact.from_workload(
        "sweep", "pairs", 42, "detail", _port_extents(lo_s, hi_s, 1),
        _port_extents(lo_u, hi_u, 1), want={(0, 0)}, got=set())
    jart = jshrink.ReproArtifact.from_workload(
        "sweep", "pairs", 42, "detail", _jax_extents(lo_s, hi_s, 1),
        _jax_extents(lo_u, hi_u, 1), want={(0, 0)}, got=set())
    assert json.loads(art.to_json()) == json.loads(jart.to_json())
    art2 = ReproArtifact(**json.loads(art.to_json()))
    s2, u2 = art2.workload(device=CPU)
    assert torch.equal(s2.lo, torch.tensor(lo_s)) and art2.region_count() == 2
    script_art = ReproArtifact.from_script(
        "churn", 7, "d", 1, fuzz.random_script(np.random.RandomState(7), 1,
                                               3, 3))
    for a in (art, script_art):
        assert ReproArtifact(**json.loads(a.to_json())).to_json() \
            == a.to_json()
        code = a.to_pytest(device=CPU)
        assert "repro_torch" in code and "import jax" not in code
        ns = {}
        exec(compile(code, "<repro>", "exec"), ns)
        next(v for k, v in ns.items() if k.startswith("test_repro_"))()


# ---------------------------------------------------------------------------
# metamorphic relations and the batch split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine_name", ENGINE_NAMES)
def test_metamorphic_relations_hold(engine_name):
    engine = conformance.get_engine(engine_name)
    rng = np.random.RandomState(7)
    for d in (1, 3):
        if not engine.supports(d):
            continue
        lo_s = rng.randint(0, 10, (d, 6)).astype(np.float32)
        lo_u = rng.randint(0, 10, (d, 5)).astype(np.float32)
        subs = _port_extents(lo_s, lo_s + rng.randint(0, 4, (d, 6)), d)
        upds = _port_extents(lo_u, lo_u + rng.randint(0, 4, (d, 5)), d)
        violations = metamorphic.check_relations(engine.pairs, subs, upds)
        assert violations == [], [str(v) for v in violations]


def test_metamorphic_catches_translation_breakage():
    def shifty(subs, upds):
        base = conformance.get_engine("sequential_numpy").pairs(subs, upds)
        if float(subs.lo.reshape(-1)[0]) > 100.0:
            return set(list(base)[:-1]) if base else base
        return base
    subs = _port_extents([0.0, 1.0, 2.0, 3.0], [1.0, 2.0, 3.0, 4.0], 1)
    upds = _port_extents([1.0, 3.0], [2.0, 3.0], 1)
    v = metamorphic.check_translation(shifty, subs, upds)
    assert v is not None and v.relation == "translation"


@pytest.mark.parametrize("impl", conformance.CHURN_IMPLS)
def test_batch_split_equivalence(impl):
    rng = np.random.RandomState(11)
    for dims in (1, 2):
        script = fuzz.random_script(rng, dims, batches=2, max_ops=6)
        v = metamorphic.check_batch_split(dims, script[0], script[1],
                                          impl=impl, device=CPU)
        assert v is None, str(v)


def test_duplicate_rid_batches_rejected():
    assert fuzz.probe_duplicate_rid(1, device=CPU) == []
    assert fuzz.probe_duplicate_rid(2, device=CPU) == []


# ---------------------------------------------------------------------------
# the harness's own teeth, the loop and the CLI
# ---------------------------------------------------------------------------

def test_injected_tie_bug_caught_and_shrunk_as_jax_shrinks_it():
    broken = fuzz.broken_open_interval_engine()
    _, failures = fuzz.run_fuzz(TIE_BUG_SEEDS, engine_names=[], smoke=True,
                                extra_engines={broken.name: broken},
                                verbose=False, device=CPU)
    caught = [f.artifact for f in failures if f.artifact.kind == "pairs"]
    assert caught, "injected off-by-one escaped the fuzzer"
    assert min(a.region_count() for a in caught) <= 6
    jbroken = jfuzz.broken_open_interval_engine()
    _, jfailures = jfuzz.run_fuzz(TIE_BUG_SEEDS, engine_names=[], smoke=True,
                                  extra_engines={jbroken.name: jbroken},
                                  verbose=False)
    jcaught = [f.artifact for f in jfailures if f.artifact.kind == "pairs"]
    assert [(a.seed, a.region_count()) for a in caught] \
        == [(a.seed, a.region_count()) for a in jcaught]
    for a, ja in zip(caught, jcaught):
        assert (a.subs_lo, a.subs_hi, a.upds_lo, a.upds_hi, a.want, a.got) \
            == (ja.subs_lo, ja.subs_hi, ja.upds_lo, ja.upds_hi, ja.want,
                ja.got)


def test_fuzz_smoke_runs_green():
    checks, failures = fuzz.run_fuzz(4, smoke=True, verbose=False,
                                     device=CPU)
    assert checks > 0
    assert failures == [], [str(f) for f in failures]


def test_cli_self_check_and_device_cpu(capsys, tmp_path):
    assert fuzz.main(["--self-check", "--device", "cpu"]) == 0
    assert "best shrink" in capsys.readouterr().out
    assert fuzz.main(["--seeds", "3", "--smoke", "--device", "cpu",
                      "--artifacts", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "0 failure(s)" in out
    with pytest.raises(SystemExit):
        fuzz.main(["--engines", "no_such_engine", "--device", "cpu"])
