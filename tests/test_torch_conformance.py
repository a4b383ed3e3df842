"""The port's engine registry (repro_torch.testing.conformance) on the CPU.

Its 11 built-ins are discovered without a second list; every one conforms
on the JAX package's edge-case corpus (``tests/test_conformance``) and on
seeded workloads, an engine with an injected tie bug is caught, and the
churn harness agrees with the JAX package's on the same seeded scripts,
``BatchDelta`` for ``BatchDelta``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.testing import conformance as ref_conformance
from repro.testing import fuzz
from repro_torch import api
from repro_torch.core.intervals import Extents
from repro_torch.testing import conformance, oracles
from test_conformance import EDGE_CASES

jax.config.update("jax_platform_name", "cpu")

BUILTINS = {"sequential_numpy", "blocked", "sweep", "sweep_gen0",
            "sweep_kernel", "bitmatrix", "bitmatrix_kernel",
            "incremental_index", "incremental_blocked", "ddm_service",
            "api_facade"}


def _port(ext):
    """A JAX-package Extents as the port's, on the CPU."""
    return Extents(torch.from_numpy(np.array(ext.lo, np.float32)),
                   torch.from_numpy(np.array(ext.hi, np.float32)))


def _seeded(kind, d, seed):
    rng = np.random.default_rng(seed)
    n, m = (120, 90) if d == 1 else (80, 70)
    length = 1000.0
    seg = 8.0 * length / (n + m)
    shape = (n + m,) if d == 1 else (d, n + m)
    if kind == "clustered":
        centers = rng.uniform(0.0, length, 3)
        lo = centers[rng.integers(0, 3, shape)] + rng.normal(0, 20.0, shape)
    else:
        lo = rng.uniform(0.0, length - seg, shape)
    lo = lo.astype(np.float32)
    hi = lo + np.float32(seg)
    if kind == "tall_thin":
        lo[0] = rng.uniform(0.0, 20.0, n + m).astype(np.float32)
        hi[0] = lo[0] + np.float32(980.0)
    return (Extents(torch.from_numpy(lo[..., :n].copy()),
                    torch.from_numpy(hi[..., :n].copy())),
            Extents(torch.from_numpy(lo[..., n:].copy()),
                    torch.from_numpy(hi[..., n:].copy())))


def test_registry_auto_discovers_its_builtins():
    engines = conformance.all_engines()
    assert BUILTINS <= set(engines)
    assert set(api.all_engines()) == set(engines)
    assert api.get_engine("sweep_kernel").dims == (1,)
    assert {e.name for e in api.engines_for(1)} == BUILTINS - {"sweep_gen0"}
    assert {e.name for e in api.engines_for(3)} \
        == BUILTINS - {"sweep_kernel"}
    assert all(e.stateful == e.name.startswith(("incremental", "ddm",
                                                "api"))
               for e in engines.values() if e.name in BUILTINS)
    with pytest.raises(api.ValidationError, match="already registered"):
        api.register_engine(api.get_engine("sweep"))


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_every_engine_conforms_on_the_edge_cases(case):
    subs, upds = (_port(e) for e in EDGE_CASES[case])
    want = oracles.reference_pairs(subs, upds)
    assert want == ref_conformance.oracles.reference_pairs(*EDGE_CASES[case])
    engines = api.engines_for(subs.ndim_space)
    assert engines
    for engine in engines:
        mm = conformance.check_engine(engine, subs, upds, want)
        assert mm is None, mm.describe()


@pytest.mark.parametrize("kind,d", [("uniform", 1), ("clustered", 1),
                                    ("uniform", 2), ("tall_thin", 2),
                                    ("tall_thin", 3)])
def test_every_engine_conforms_on_seeded_workloads(kind, d):
    subs, upds = _seeded(kind, d, 30 + d)
    want = oracles.reference_pairs(subs, upds)
    assert want
    for engine in api.engines_for(d):
        mm = conformance.check_engine(engine, subs, upds, want)
        assert mm is None, mm.describe()


def test_an_injected_tie_bug_is_caught():
    """The sweep with its closed ``<=`` tie flipped to ``<`` (single-point
    overlaps dropped), registered, fails conformance on the tie cases."""
    def broken(subs, upds):
        base = conformance.get_engine("sweep").pairs(subs, upds)
        s_lo, s_hi, u_lo, u_hi = (np.atleast_2d(x.numpy()) for x in
                                  (subs.lo, subs.hi, upds.lo, upds.hi))
        return {(i, j) for i, j in base
                if not np.any(np.maximum(s_lo[:, i], u_lo[:, j])
                              == np.minimum(s_hi[:, i], u_hi[:, j]))}

    engine = api.register_engine(api.MatchEngine("sweep#open-tie-bug", broken))
    try:
        assert "sweep#open-tie-bug" in api.all_engines()
        caught = []
        for case in ("single_region_touch", "exact_tie_ladder",
                     "zero_width_points"):
            subs, upds = (_port(e) for e in EDGE_CASES[case])
            mm = conformance.check_engine(engine, subs, upds)
            if mm is not None:
                caught.append(mm.describe())
        assert len(caught) == 3, caught
        assert "missing" in caught[0]
    finally:
        conformance.unregister("sweep#open-tie-bug")
    assert "sweep#open-tie-bug" not in api.all_engines()


@pytest.mark.parametrize("seed,dims", [(0, 1), (3, 1), (6, 2), (9, 3)])
def test_churn_harness_agrees_with_the_reference(seed, dims):
    script = fuzz.random_script(np.random.RandomState(seed), dims,
                                batches=6, max_ops=6)
    assert conformance.check_churn_script(script, dims, device="cpu") == []
    assert ref_conformance.check_churn_script(script, dims) == []
    for impl in conformance.CHURN_IMPLS:
        port = conformance.churn_runner(impl, dims, device="cpu")
        ref = ref_conformance.churn_runner(impl, dims)
        for batch in script:
            assert port.apply(*batch) == ref.apply(*batch), (impl, batch)
        assert port.all_pairs() == ref.all_pairs()


def test_churn_harness_reports_a_drifted_index():
    """An index whose delta drops a pair is reported at its first batch."""
    script = fuzz.random_script(np.random.RandomState(4), 1, batches=5,
                                max_ops=6)
    runner_cls = conformance._IndexChurnRunner
    real_apply = runner_cls.apply

    def lossy(self, adds, moves, removes):
        delta = real_apply(self, adds, moves, removes)
        if self.impl == "arrays" and delta.added:
            delta.added.discard(min(delta.added))
        return delta

    runner_cls.apply = lossy
    try:
        problems = conformance.check_churn_script(script, 1, device="cpu")
    finally:
        runner_cls.apply = real_apply
    assert problems and "BatchDelta of 'arrays'" in problems[0]
    with pytest.raises(api.ValidationError, match="unknown churn impl"):
        conformance.churn_runner("nope", 1, device="cpu")
