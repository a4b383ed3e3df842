"""Churn, service and conformance parity of the PyTorch port (repro_torch)
with the JAX package, on the CPU.

The same churn scripts (the reference fuzzer's ``random_script``) and the
same service operations drive both packages, for d = 1, 2 and 3; every
``BatchDelta``, rid, count and pair set must be identical, batch by batch.
The port's engines (1-d and d-dim) are registered into the reference's
conformance registry for the duration of a test and graded by its battery.
"""
import jax
import numpy as np
import pytest

from repro import api as ref_api
from repro.core import IncrementalIndex as RefIndex
from repro.testing import conformance, fuzz, metamorphic
from repro_torch import convert
from repro_torch.api import DDMService, ValidationError
from repro_torch.core import ddim as tddim
from repro_torch.core import runtime as truntime
from repro_torch.core.enumerate import sbm_enumerate
from repro_torch.core.incremental import IncrementalIndex
from repro_torch.kernels.bitmatch import sbm_bitmatrix_kernel
from repro_torch.kernels.ops import sbm_enumerate_kernel
from test_conformance import EDGE_CASES

jax.config.update("jax_platform_name", "cpu")


# ---------------------------------------------------------------------------
# the incremental index: identical BatchDeltas batch by batch
# ---------------------------------------------------------------------------

PORT_INDEXES = {
    "loop_flat": dict(delta_impl="loop", index_impl="flat"),
    "vector_flat": dict(index_impl="flat"),
    "arrays_blocked": dict(),
    "blocked_b8": dict(block_target=8),
    "device_regime": dict(regime_policy=truntime.BulkRegimePolicy(
        force="device")),
    "sort_regime": dict(regime_policy=truntime.BulkRegimePolicy(force="sort")),
}


def _grouped(batch):
    """A tuple-format batch as the array API's side-grouped mappings."""
    adds, moves, removes = batch
    out = []
    for ops in (adds, moves):
        grp = {}
        for side in ("sub", "upd"):
            sel = [(r, lo, hi) for s, r, lo, hi in ops if s == side]
            if sel:
                grp[side] = (np.asarray([r for r, _, _ in sel], np.int64),
                             np.stack([np.atleast_1d(lo) for _, lo, _ in sel]),
                             np.stack([np.atleast_1d(hi) for _, _, hi in sel]))
        out.append(grp)
    rem = {}
    for side in ("sub", "upd"):
        sel = [r for s, r in removes if s == side]
        if sel:
            rem[side] = np.asarray(sel, np.int64)
    return out[0], out[1], rem


@pytest.mark.parametrize("seed,dims", [(0, 1), (1, 1), (2, 1), (3, 2), (4, 3)])
def test_index_churn_deltas_match_reference(seed, dims):
    """The index is ported whole, d-dim streams included."""
    rng = np.random.RandomState(seed)
    script = fuzz.random_script(rng, dims, batches=10, max_ops=8)
    ref_flat = conformance.churn_runner("vector", dims)
    ref_blocked = conformance.churn_runner("blocked", dims)
    ports = {name: IncrementalIndex(dims=dims, capacity=4, device="cpu", **kw)
             for name, kw in PORT_INDEXES.items()}
    for step, batch in enumerate(script):
        want = ref_flat.apply(*batch)
        assert ref_blocked.apply(*batch) == want
        for name, idx in ports.items():
            if name in ("loop_flat", "vector_flat"):
                got = idx.apply_batch(adds=batch[0], moves=batch[1],
                                      removes=batch[2])
            else:
                a, m, r = _grouped(batch)
                got = idx.apply_batch_arrays(adds=a, moves=m, removes=r)
            assert got == want, f"batch {step}: {name} delta differs"
        pairs = ref_flat.all_pairs()
        for name, idx in ports.items():
            assert idx.all_pairs() == pairs, f"batch {step}: {name} pairs"


@pytest.mark.parametrize("regime", truntime.BULK_REGIMES)
def test_bulk_churn_regimes_match_reference(regime):
    """Bulk batches through each forced rematch regime, including the fused
    moves-only delta (one side moved) and mixed add/move/remove batches."""
    rng = np.random.default_rng(7)
    n = 120
    lo = rng.uniform(0, 200, (2, n)).astype(np.float32)
    hi = lo + rng.uniform(0, 6, (2, n)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64)
    want_idx = RefIndex(dims=1, capacity=4)
    got_idx = IncrementalIndex(dims=1, capacity=4, device="cpu",
                               regime_policy=truntime.BulkRegimePolicy(
                                   force=regime))
    batches = [
        dict(adds={"sub": (ids, lo[0], hi[0]), "upd": (ids, lo[1], hi[1])}),
        dict(moves={"sub": (ids[:40], lo[1, :40] + 3, hi[1, :40] + 3)}),
        dict(moves={"upd": (ids[10:90], lo[0, 10:90], hi[0, 10:90])}),
        dict(removes={"sub": ids[::3]},
             moves={"upd": (ids[:5], lo[0, :5], hi[0, :5] + 50)}),
        dict(adds={"sub": (ids[::3], lo[1, ::3], hi[1, ::3])},
             removes={"upd": ids[100:]}),
    ]
    for step, kw in enumerate(batches):
        want = want_idx.apply_batch_arrays(**kw)
        got = got_idx.apply_batch_arrays(**kw)
        assert got == want, f"batch {step}"
        assert got_idx.all_pairs() == want_idx.all_pairs()
    regimes = got_idx.recorder.by_regime
    assert regimes.get(regime, 0) > 0, regimes


# ---------------------------------------------------------------------------
# the service: same operations, same rids, deltas, counts and pairs
# ---------------------------------------------------------------------------

def _service_ops(rng, live, steps, dims=1):
    """Random service operations over both sides: block/scalar register,
    move and unregister; ``live`` mirrors the live rids.  Blocks are
    ``(k,)`` bounds for d = 1 and ``(k, d)`` for d > 1; a single region's
    bounds are a scalar (d = 1) or a length-d row."""
    shape = (lambda k: k) if dims == 1 else (lambda k: (k, dims))
    one = float if dims == 1 else (lambda row: row)
    for _ in range(steps):
        side = ("sub", "upd")[rng.integers(2)]
        op = rng.integers(6)
        cand = sorted(live[side])
        k = int(rng.integers(1, 6))
        lo = rng.integers(0, 30, shape(k)).astype(np.float32)
        hi = lo + rng.integers(0, 5, shape(k)).astype(np.float32)
        if op == 0 or len(cand) < k:
            yield ("register", side, lo, hi)
        elif op == 1:
            yield ("register", side, one(lo[0]), one(hi[0]))
        elif op == 2:
            yield ("move", side, rng.choice(cand, k, replace=False), lo, hi)
        elif op == 3:
            yield ("move", side, int(cand[0]), one(lo[0]), one(hi[0]))
        elif op == 4:
            yield ("unregister", side, rng.choice(cand, k, replace=False))
        else:
            yield ("unregister", side, int(cand[-1]))


def _apply(svc, op):
    verb, side, *args = op
    return getattr(svc, verb)(side, *args)


# d = 1 keeps the ids "<seed>-<impl>"; d > 1 cases are "<seed>-<impl>-d<d>"
SERVICE_CHURN_CASES = [
    pytest.param(seed, impl, dims,
                 id=f"{seed}-{impl}" + ("" if dims == 1 else f"-d{dims}"))
    for dims in (1, 2, 3) for impl in ("blocked", "flat") for seed in (0, 1, 2)]


@pytest.mark.parametrize("seed,index_impl,dims", SERVICE_CHURN_CASES)
def test_service_churn_matches_reference(seed, index_impl, dims):
    rng = np.random.default_rng(seed)
    ref = ref_api.DDMService(dims=dims, capacity=4, index_impl=index_impl)
    port = DDMService(dims=dims, capacity=4, index_impl=index_impl,
                      device="cpu")
    live = {"sub": set(), "upd": set()}
    for step in range(10):
        for op in _service_ops(rng, live, steps=4, dims=dims):
            want = _apply(ref, op)
            got = _apply(port, op)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
            if op[0] == "register":
                live[op[1]].update(np.atleast_1d(want).tolist())
            elif op[0] == "unregister":
                live[op[1]].difference_update(np.atleast_1d(op[2]).tolist())
        assert port.flush() == ref.flush(), f"step {step}: BatchDelta"
        if step % 3 == 1:
            assert port.match_count() == ref.match_count()
            assert port.pairs() == ref.pairs()
        assert port.matches_for_update(0) == ref.matches_for_update(0)
    assert port.pairs() == ref.pairs()
    assert port.match_count() == ref.match_count()
    assert port.route(0, "x") == ref.route(0, "x")
    if dims > 1:
        # a cold count runs the selective sweep and records its generator
        port.invalidate_cache()
        ref.invalidate_cache()
        assert port.match_count() == ref.match_count()
        assert set(port.stats()["by_regime"]) == set(ref.stats()["by_regime"])


def test_service_rebuild_runs_the_kernel_engine_plan():
    port = DDMService(device="cpu")
    port.register("sub", np.arange(50, dtype=np.float32),
                  np.arange(50, dtype=np.float32) + 2)
    port.register("upd", np.arange(40, dtype=np.float32) * 1.5,
                  np.arange(40, dtype=np.float32) * 1.5 + 1)
    k = port.match_count()
    assert len(port.pairs()) == k
    stats = port.stats()
    assert stats["by_engine"].get("service_rebuild") == 1
    last = [s for s in port.recorder.history() if s.engine == "service_rebuild"]
    assert last[-1].retries == 0 and last[-1].recompiles == 0


def test_service_rejects_d_above_one_and_keeps_the_error_hierarchy():
    """d > 1 is now served (it was refused before the d-dim slice); d = 0
    is still refused, and the error hierarchy holds."""
    with pytest.raises(ValidationError, match="dims must be >= 1"):
        DDMService(dims=0, device="cpu")
    svc2 = DDMService(dims=2, device="cpu")
    sids = svc2.register("sub", np.array([[0.0, 0.0], [5.0, 5.0]], np.float32),
                         np.array([[2.0, 2.0], [6.0, 9.0]], np.float32))
    uid = svc2.register("upd", [1.0, 8.0], [5.0, 8.0])
    assert list(sids) == [0, 1] and uid == 0
    assert svc2.flush().added == {(1, 0)}
    assert svc2.match_count() == 1 and svc2.matches_for_update(uid) == [1]
    with pytest.raises(ValueError):
        svc2.register("sub", [0.0, 2.0], [1.0, 1.0])          # lo > hi in dim 1
    with pytest.raises(ValidationError):
        svc2.register("sub", [0.0], [1.0])                    # wrong length
    svc = DDMService(device="cpu")
    with pytest.raises(ValueError):
        svc.register("sub", 2.0, 1.0)
    with pytest.raises(ValidationError):
        svc.register("nope", 0.0, 1.0)
    with pytest.deprecated_call():
        rid = svc.register_subscription(0.0, 1.0)
    assert rid == 0


# ---------------------------------------------------------------------------
# conformance battery over the port's d = 1 engines
# ---------------------------------------------------------------------------

def _port_sides(subs, upds):
    return (convert.extents_from_arrays(np.asarray(subs.lo),
                                        np.asarray(subs.hi), device="cpu"),
            convert.extents_from_arrays(np.asarray(upds.lo),
                                        np.asarray(upds.hi), device="cpu"))


def _sweep(subs, upds):
    s, u = _port_sides(subs, upds)
    return truntime.pairs_via_retry(
        lambda a, b, max_pairs: sbm_enumerate(a, b, max_pairs=max_pairs), s, u)


def _sweep_kernel(subs, upds):
    s, u = _port_sides(subs, upds)
    return truntime.pairs_via_retry(
        lambda a, b, max_pairs: sbm_enumerate_kernel(
            a, b, max_pairs=max_pairs, block_size=64), s, u)


def _index(subs, upds, **kw):
    idx = IncrementalIndex(dims=1, capacity=4, device="cpu", **kw)
    adds = {}
    for side, ext in (("sub", subs), ("upd", upds)):
        lo = np.asarray(ext.lo, np.float32)
        if lo.size:
            adds[side] = (np.arange(lo.size, dtype=np.int64), lo,
                          np.asarray(ext.hi, np.float32))
    if adds:
        idx.apply_batch_arrays(adds=adds, want_delta=False)
    return idx.all_pairs()


def _service(subs, upds):
    s_lo, s_hi = np.asarray(subs.lo), np.asarray(subs.hi)
    u_lo, u_hi = np.asarray(upds.lo), np.asarray(upds.hi)
    dims = subs.ndim_space
    if dims > 1:                                  # the (b, d) block layout
        s_lo, s_hi, u_lo, u_hi = s_lo.T, s_hi.T, u_lo.T, u_hi.T
    svc = DDMService(dims=dims, capacity=4, device="cpu")
    sids = svc.register("sub", s_lo, s_hi)
    uids = svc.register("upd", u_lo, u_hi)
    inv_s = {int(r): i for i, r in enumerate(sids)}
    inv_u = {int(r): j for j, r in enumerate(uids)}
    return {(inv_s[a], inv_u[b]) for a, b in svc.pairs()}


def _ddim(**kw):
    def pairs(subs, upds):
        s, u = _port_sides(subs, upds)
        return truntime.pairs_via_retry(
            lambda a, b, max_pairs: tddim.enumerate_matches_ddim(
                a, b, max_pairs=max_pairs, **kw), s, u)
    return pairs


def _bitmatrix_kernel(subs, upds):
    s, u = _port_sides(subs, upds)
    return truntime.pairs_via_retry(
        lambda a, b, max_pairs: sbm_bitmatrix_kernel(a, b,
                                                     max_pairs=max_pairs),
        s, u)


# name -> (pairs runner, supported dims; None = every d)
PORT_ENGINES = {
    "torch_sweep": (_sweep, (1,)),
    "torch_sweep_kernel": (_sweep_kernel, (1,)),
    "torch_incremental_flat": (lambda s, u: _index(s, u, index_impl="flat"),
                               (1,)),
    "torch_incremental_blocked": (lambda s, u: _index(s, u, block_target=8),
                                  (1,)),
    "torch_service": (_service, (1, 2, 3)),
    "torch_ddim_sweep": (_ddim(method="sweep"), None),
    "torch_sweep_gen0": (_ddim(method="sweep", generator_dim=0), (2, 3, 4)),
    "torch_bitmatrix": (_ddim(method="bitmatrix"), None),
    "torch_bitmatrix_kernel": (_bitmatrix_kernel, None),
}


@pytest.fixture
def port_engines():
    engines = [conformance.register(conformance.MatchEngine(
        name, fn, dims=dims, stateful=name.startswith(("torch_inc",
                                                       "torch_serv"))))
        for name, (fn, dims) in PORT_ENGINES.items()]
    try:
        yield engines
    finally:
        for e in engines:
            conformance.unregister(e.name)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_port_engines_pass_edge_cases(port_engines, case):
    subs, upds = EDGE_CASES[case]
    assert all(e.name in conformance.all_engines() for e in port_engines)
    engines = [e for e in port_engines if e.supports(subs.ndim_space)]
    assert engines
    for engine in engines:
        mm = conformance.check_engine(engine, subs, upds)
        assert mm is None, mm.describe()


def test_port_engines_pass_metamorphic_relations(port_engines):
    from test_conformance import _mk
    rng = np.random.RandomState(7)
    lo_s = rng.randint(0, 10, 6).astype(np.float32)
    lo_u = rng.randint(0, 10, 5).astype(np.float32)
    cases = {1: _mk(lo_s, lo_s + rng.randint(0, 4, 6),
                    lo_u, lo_u + rng.randint(0, 4, 5), 1)}
    lo_s = rng.randint(0, 10, (3, 6)).astype(np.float32)
    lo_u = rng.randint(0, 10, (3, 5)).astype(np.float32)
    cases[3] = _mk(lo_s, lo_s + rng.randint(0, 4, (3, 6)),
                   lo_u, lo_u + rng.randint(0, 4, (3, 5)), 3)
    for d, (subs, upds) in cases.items():
        for engine in port_engines:
            if not engine.supports(d):
                continue
            violations = metamorphic.check_relations(engine.pairs, subs, upds)
            assert violations == [], (engine.name, d,
                                      [str(v) for v in violations])


def test_port_engines_pass_the_differential_fuzzer(port_engines):
    checks, failures = fuzz.run_fuzz(
        3, engine_names=[e.name for e in port_engines], smoke=True,
        verbose=False)
    assert checks > 0
    assert failures == [], [str(f) for f in failures]


# ---------------------------------------------------------------------------
# state carried across from a reference service
# ---------------------------------------------------------------------------

def test_state_carry_over_keeps_rids_and_follow_up_churn():
    rng = np.random.default_rng(11)
    ref = ref_api.DDMService(capacity=4)
    lo = rng.integers(0, 40, 24).astype(np.float32)
    hi = lo + rng.integers(0, 6, 24).astype(np.float32)
    ref.register("sub", lo[:12], hi[:12])
    ref.register("upd", lo[12:], hi[12:])
    ref.flush()
    # holes in the rid space, a history-dependent free list, pending moves
    ref.unregister("sub", np.array([3, 7, 1]))
    ref.unregister("upd", 5)
    ref.move("upd", np.array([0, 2]), np.array([1.0, 2.0], np.float32),
             np.array([9.0, 30.0], np.float32))
    ref.flush()
    ref.unregister("sub", 10)

    states = [convert.RegionTableState(t.lo, t.hi, t.live, list(t.free))
              for t in (ref._subs, ref._upds)]
    port = convert.service_from_tables(*states, device="cpu")
    assert port.pairs() == ref.pairs()
    assert port.match_count() == ref.match_count()

    nlo = rng.integers(0, 40, 8).astype(np.float32)
    nhi = nlo + 3
    for svc in (ref, port):
        svc.pairs()                  # both caches warm: flushes carry deltas
    ops = [("register", "sub", nlo[:5], nhi[:5]),
           ("register", "upd", float(nlo[5]), float(nhi[5])),
           ("move", "sub", np.array([0, 2]), nlo[6:8], nhi[6:8]),
           ("unregister", "upd", np.array([1, 3]))]
    for op in ops:
        np.testing.assert_array_equal(np.asarray(_apply(port, op)),
                                      np.asarray(_apply(ref, op)))
    assert port.flush() == ref.flush()
    assert port.pairs() == ref.pairs()
    assert port._subs.free == ref._subs.free
    assert port._upds.free == ref._upds.free


def test_state_carry_over_rejects_bad_tables():
    """2-D tables carry over (d comes from the tables); a bad free list, a
    d that differs between the sides, or mismatched shapes are refused."""
    rng = np.random.default_rng(5)
    ref = ref_api.DDMService(dims=2, capacity=4)
    lo = rng.integers(0, 20, (14, 2)).astype(np.float32)
    hi = lo + rng.integers(0, 6, (14, 2)).astype(np.float32)
    ref.register("sub", lo[:8], hi[:8])
    ref.register("upd", lo[8:], hi[8:])
    ref.flush()
    ref.unregister("sub", np.array([2, 5]))
    states = [convert.RegionTableState(t.lo, t.hi, t.live, list(t.free))
              for t in (ref._subs, ref._upds)]
    port = convert.service_from_tables(*states, device="cpu")
    assert port.dims == 2
    assert port.pairs() == ref.pairs()
    assert port.match_count() == ref.match_count()
    for svc in (ref, port):
        svc.move("upd", 1, [0.0, 0.0], [30.0, 30.0])
    assert port.flush() == ref.flush()

    live = np.array([True, False])
    lo = np.zeros((1, 2), np.float32)
    bad_free = convert.RegionTableState(lo, lo + 1, live, [0])
    ok = convert.RegionTableState(lo, lo + 1, live, [1])
    with pytest.raises(ValidationError):
        convert.service_from_tables(bad_free, ok, device="cpu")
    two_d = convert.RegionTableState(np.zeros((2, 2), np.float32),
                                     np.ones((2, 2), np.float32), live, [1])
    with pytest.raises(ValidationError):                  # d = 2 against d = 1
        convert.service_from_tables(two_d, ok, device="cpu")
    ragged = convert.RegionTableState(np.zeros((2, 2), np.float32),
                                      np.ones((2, 3), np.float32), live, [1])
    with pytest.raises(ValidationError):
        convert.service_from_tables(ragged, two_d, device="cpu")
