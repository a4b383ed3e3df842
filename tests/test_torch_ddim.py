"""d-dimensional matching parity of the PyTorch port (repro_torch) with the
JAX package, on the CPU.

Inputs are made once with numpy from a seed and handed to both packages.
Every comparison is exact (tolerance 0): the results are integers and bit
words of identical float32 comparisons.  The port's bit-matrix wrapper
takes the kernel's plain version for CPU tensors; the reference's Pallas
kernel runs in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ddim as rddim
from repro.core.intervals import Extents as RExtents
from repro.data.synthetic import ddm_workload as r_ddm_workload
from repro.kernels import bitmatrix_pallas
from repro.kernels import sbm_bitmatrix_kernel as r_sbm_bitmatrix_kernel
from repro_torch.core import ddim as tddim
from repro_torch.core import intervals as tintervals
from repro_torch.core import runtime as truntime
from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents as TExtents
from repro_torch.data import DDM_WORKLOADS, ddm_workload
from repro_torch.kernels import bitmatch as tbitmatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

jax.config.update("jax_platform_name", "cpu")


def _arrays(seed, d, n, m, span=40.0):
    """(d, n) / (d, m) float32 bounds ((n,) / (m,) for d = 1)."""
    rng = np.random.default_rng(seed)
    out = []
    for size in (n, m):
        shape = (size,) if d == 1 else (d, size)
        lo = rng.uniform(0, span, shape).astype(np.float32)
        hi = lo + rng.uniform(0, span / 2, shape).astype(np.float32)
        out += [lo, hi]
    return out


def _both(s_lo, s_hi, u_lo, u_hi):
    ref = (RExtents(jnp.asarray(s_lo), jnp.asarray(s_hi)),
           RExtents(jnp.asarray(u_lo), jnp.asarray(u_hi)))
    port = (TExtents(torch.from_numpy(np.array(s_lo)),
                     torch.from_numpy(np.array(s_hi))),
            TExtents(torch.from_numpy(np.array(u_lo)),
                     torch.from_numpy(np.array(u_hi))))
    return ref, port


def _u32(words: torch.Tensor) -> np.ndarray:
    """The port's int32-held words as the reference's uint32."""
    return words.numpy().view(np.uint32)


SHAPES = [(1, 33, 40), (2, 64, 70), (2, 37, 130), (3, 96, 257), (2, 20, 1)]


# ---------------------------------------------------------------------------
# the bit-matrix words, row counts and K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,n,m", SHAPES)
def test_bitmatrix_words_counts_and_k_match_reference(d, n, m):
    (rs, ru), (ts, tu) = _both(*_arrays(d * 100 + n, d, n, m))
    want = np.asarray(rddim.bitmatrix_words(rs, ru))
    before = tbitmatch.bitmatch.launches
    words, counts, k = tbitmatch.bitmatrix_kernel(ts, tu)
    assert tbitmatch.bitmatch.launches == before      # CPU: plain version
    np.testing.assert_array_equal(_u32(words), want)
    np.testing.assert_array_equal(_u32(tddim.bitmatrix_words(ts, tu)), want)
    _, r_counts, r_k = bitmatrix_pallas(rs, ru, block_n=16, interpret=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(r_counts))
    assert counts.dtype == torch.int32
    assert int(k) == int(r_k) == int(rddim.bitmatrix_count(rs, ru)) \
        == int(tddim.bitmatrix_count(ts, tu)) \
        == int(tddim._popcount_total(words))
    assert k.dtype == torch.int64
    # the plain version over row blocks equals it whole
    s_lo, s_hi = tddim._dim_rows(ts)
    u_lo, u_hi = tddim._dim_rows(tu)
    blocked = tref.ref_bitmatrix(s_lo.contiguous(), s_hi.contiguous(),
                                 u_lo.contiguous(), u_hi.contiguous(),
                                 row_block=7)
    assert torch.equal(blocked[0], words) and torch.equal(blocked[1], counts)


def test_unbounded_subscription_matches_the_xla_form():
    """[-inf, +inf]² against m = 5: every bit of the 5 is set, none past m.
    Held against the XLA form only — the Pallas form pads the update axis
    with [+inf, -inf] sentinels that an unbounded interval overlaps (the
    Pallas bit-matrix padding entry of ROADMAP.md's watch-list)."""
    inf = np.float32(np.inf)
    s_lo = np.full((2, 1), -inf, np.float32)
    s_hi = np.full((2, 1), inf, np.float32)
    u_lo = np.arange(10, dtype=np.float32).reshape(2, 5)
    u_hi = u_lo + 1
    (rs, ru), (ts, tu) = _both(s_lo, s_hi, u_lo, u_hi)
    want = np.asarray(rddim.bitmatrix_words(rs, ru))
    words, counts, k = tbitmatch.bitmatrix_kernel(ts, tu)
    np.testing.assert_array_equal(_u32(words), want)
    assert int(want[0, 0]) == 31
    assert int(counts[0]) == int(k) == int(rddim.bitmatrix_count(rs, ru)) == 5
    pairs, count = tbitmatch.sbm_bitmatrix_kernel(ts, tu, max_pairs=8)
    r_pairs, _ = rddim.bitmatrix_enumerate(rs, ru, max_pairs=8)
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(r_pairs))
    assert int(count) == 5


# ---------------------------------------------------------------------------
# pair emission from the bit matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_pairs", [1, 17, 64, 400])
def test_bitmatrix_pair_emission_matches_reference(max_pairs):
    (rs, ru), (ts, tu) = _both(*_arrays(5, 2, 45, 61))
    r_words = rddim.bitmatrix_words(rs, ru)
    want, want_k = rddim.pairs_from_bitmatrix(r_words, m=61,
                                              max_pairs=max_pairs)
    words = tddim.bitmatrix_words(ts, tu)
    got, k = tddim.pairs_from_bitmatrix(words, m=61, max_pairs=max_pairs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(k) == int(want_k)                  # exact past the buffer
    for fn in (lambda: tddim.bitmatrix_enumerate(ts, tu, max_pairs=max_pairs),
               lambda: tbitmatch.sbm_bitmatrix_kernel(ts, tu,
                                                      max_pairs=max_pairs)):
        pairs, count = fn()
        np.testing.assert_array_equal(pairs.numpy(), np.asarray(want))
        assert int(count) == int(want_k)
    r_pairs, r_count = r_sbm_bitmatrix_kernel(rs, ru, max_pairs=max_pairs,
                                              block_n=16, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(r_pairs))
    assert int(r_count) == int(k)
    if max_pairs < int(k):
        assert (got.numpy() >= 0).all()            # the buffer fills up


def test_bitmatrix_empty_sides():
    for n, m in ((0, 3), (4, 0)):
        (rs, ru), (ts, tu) = _both(*_arrays(1, 2, n, m))
        pairs, count = tddim.bitmatrix_enumerate(ts, tu, max_pairs=4)
        r_pairs, r_count = rddim.bitmatrix_enumerate(rs, ru, max_pairs=4)
        np.testing.assert_array_equal(pairs.numpy(), np.asarray(r_pairs))
        assert int(count) == int(r_count) == 0
        words, counts, k = tbitmatch.bitmatrix_kernel(ts, tu)
        assert words.shape == (n, max(-(-m // 32), 1)) and int(k) == 0
        assert not words.any() and counts.shape == (n,)


def test_bitmatch_wrapper_validates():
    lo = torch.zeros((2, 4))
    hi = torch.ones((2, 4))
    with pytest.raises(ValidationError):
        tbitmatch.bitmatch(lo, hi, lo[:1], hi[:1])            # d differs
    with pytest.raises(ValidationError):
        tbitmatch.bitmatch(lo.double(), hi, lo, hi)
    with pytest.raises(ValidationError):
        tbitmatch.bitmatch(lo.t().contiguous().t(), hi, lo, hi)
    with pytest.raises(ValidationError):                    # no meta kernel
        tbitmatch.bitmatch(*(x.to("meta") for x in (lo, hi, lo, hi)))


# ---------------------------------------------------------------------------
# dimension selection
# ---------------------------------------------------------------------------

def test_per_dimension_counts_and_select_dimension():
    (rs, ru), (ts, tu) = _both(*_arrays(3, 3, 50, 40))
    assert tddim.per_dimension_counts(ts, tu) \
        == rddim.per_dimension_counts(rs, ru)
    assert tddim.select_dimension(ts, tu) == rddim.select_dimension(rs, ru)
    # the kernel entry point as the probe gives the same counts
    assert tddim.per_dimension_counts(ts, tu, count_fn=tops.sbm_count_kernel) \
        == rddim.per_dimension_counts(rs, ru)
    # equal selectivity in both dimensions: the tie goes to dimension 0
    lo = np.array([[0, 2, 0, 2], [0, 2, 0, 2]], np.float32)
    (rs, ru), (ts, tu) = _both(lo, lo + 1, lo + 1, lo + 2)
    gen, counts = tddim.select_dimension(ts, tu)
    assert (gen, counts) == rddim.select_dimension(rs, ru)
    assert gen == 0 and counts[0] == counts[1]
    (rs, ru), (ts, tu) = _both(*_arrays(4, 1, 10, 12))
    assert tddim.select_dimension(ts, tu) == rddim.select_dimension(rs, ru)


def test_extents_dim_projection():
    (rs, _), (ts, _) = _both(*_arrays(2, 3, 6, 5))
    assert torch.equal(ts.dim(2).lo, torch.from_numpy(np.array(rs.dim(2).lo)))
    (_, _), (t1, _) = _both(*_arrays(2, 1, 6, 5))
    assert t1.dim(0) is t1
    with pytest.raises(ValidationError):
        t1.dim(1)


# ---------------------------------------------------------------------------
# enumerate_matches_ddim: array equality for every method
# ---------------------------------------------------------------------------

CALLS = {
    "sweep": dict(method="sweep"),
    "sweep_gen0": dict(method="sweep", generator_dim=0),
    "sweep_gen1": dict(method="sweep", generator_dim=1),
    "blocked": dict(method="blocked", block=16),
    "blocked_gen1": dict(method="blocked", block=16, generator_dim=1),
    "bitmatrix": dict(method="bitmatrix"),
}


# 1-d extents have one dimension: no generator_dim=1 case there
@pytest.mark.parametrize("d,call", [(d, c) for d in (1, 2, 3)
                                    for c in sorted(CALLS)
                                    if d > 1 or not c.endswith("gen1")])
def test_enumerate_matches_ddim_matches_reference(d, call):
    kw = CALLS[call]
    (rs, ru), (ts, tu) = _both(*_arrays(10 + d, d, 48, 56, span=60.0))
    k = int(rddim.bitmatrix_count(rs, ru))
    max_pairs = 2 * 48 * 56
    want, want_count = rddim.enumerate_matches_ddim(rs, ru,
                                                    max_pairs=max_pairs, **kw)
    got, count = tddim.enumerate_matches_ddim(ts, tu, max_pairs=max_pairs,
                                              **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(count) == int(want_count) == k
    assert count.dtype == torch.int64


def test_enumerate_matches_ddim_kernel_engine_gives_the_same_pair_set():
    """The service's engine (the kernel entry points, plain on the CPU)
    emits in pass C's order; the pair set and count are the reference's."""
    (rs, ru), (ts, tu) = _both(*_arrays(21, 3, 40, 44, span=50.0))
    want, want_count = rddim.enumerate_matches_ddim(rs, ru, max_pairs=1024)
    got, count = tddim.enumerate_matches_ddim(
        ts, tu, max_pairs=1024, engine=tops.sbm_enumerate_kernel,
        count_fn=tops.sbm_count_kernel)
    as_set = lambda a: {tuple(p) for p in np.asarray(a).tolist() if p[0] >= 0}
    assert as_set(got.numpy()) == as_set(want)
    assert int(count) == int(want_count)


def test_generator_overflow_returns_the_generator_count():
    rs, ru = r_ddm_workload("tall_thin", jax.random.PRNGKey(12), 32, 32,
                            alpha=12.0, d=2, length=1000.0)
    _, (ts, tu) = _both(*(np.asarray(a) for a in (rs.lo, rs.hi, ru.lo, ru.hi)))
    gen, counts = rddim.select_dimension(rs, ru)
    short = max(counts[gen] // 4, 1)
    for kw in (dict(), dict(generator_dim=0)):
        g = kw.get("generator_dim", gen)
        want, want_count = rddim.enumerate_matches_ddim(rs, ru,
                                                        max_pairs=short, **kw)
        got, count = tddim.enumerate_matches_ddim(ts, tu, max_pairs=short,
                                                  **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(count) == int(want_count) == counts[g] > short


@pytest.mark.parametrize("method", ["sweep", "bitmatrix", "blocked"])
def test_planned_form_matches_reference_retry_free(method):
    (rs, ru), (ts, tu) = _both(*_arrays(31, 2, 50, 60, span=60.0))
    want, want_count, r_stats = rddim.enumerate_matches_ddim_planned(
        rs, ru, method=method, block=16)
    rec = truntime.StatsRecorder()
    got, count, stats = tddim.enumerate_matches_ddim_planned(
        ts, tu, method=method, block=16, recorder=rec)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(count) == int(want_count)
    assert stats.regime == r_stats.regime
    if method == "sweep":
        assert stats.regime == f"sweep_dim{rddim.select_dimension(rs, ru)[0]}"
    if method != "blocked":
        assert stats.retries == 0
    assert stats.attempts == r_stats.attempts
    assert stats.capacity == r_stats.capacity
    assert rec.by_regime == {stats.regime: 1}
    with pytest.raises(ValidationError):
        tddim.enumerate_matches_ddim_planned(ts, tu, method="nope")
    with pytest.raises(ValidationError):
        tddim.enumerate_matches_ddim(ts, tu, max_pairs=4, method="nope")


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wide_dim", [0, 2])
def test_tall_thin_workload_shape(wide_dim):
    g = torch.Generator().manual_seed(0)
    length = 1000.0
    subs, upds = tintervals.make_tall_thin_workload(
        30, 40, alpha=6.0, length=length, d=3, wide_dim=wide_dim,
        generator=g, device="cpu")
    assert subs.lo.shape == (3, 30) and upds.lo.shape == (3, 40)
    for e in (subs, upds):
        span = (e.hi[wide_dim] - e.lo[wide_dim]).double()
        assert bool((span >= np.float32(0.98 * length) - 1e-3).all())
        assert bool((e.lo[wide_dim] >= 0).all())
        assert bool((e.hi <= length).all()) and bool((e.lo <= e.hi).all())
    counts = tddim.per_dimension_counts(subs, upds)
    assert counts[wide_dim] == 30 * 40
    assert tddim.select_dimension(subs, upds)[0] != wide_dim


@pytest.mark.parametrize("name", DDM_WORKLOADS)
@pytest.mark.parametrize("d", [2, 3])
def test_registry_workloads_shapes(name, d):
    g = torch.Generator().manual_seed(d)
    subs, upds = ddm_workload(name, 20, 25, alpha=3.0, d=d, length=1000.0,
                              generator=g, device="cpu")
    rs, ru = r_ddm_workload(name, jax.random.PRNGKey(d), 20, 25, alpha=3.0,
                            d=d, length=1000.0)
    assert subs.lo.shape == tuple(rs.lo.shape) and upds.hi.shape \
        == tuple(ru.hi.shape)
    assert subs.lo.dtype == torch.float32


def test_registry_errors_match_reference():
    bad = [dict(name="nope", d=1, alpha=1.0),
           dict(name="tall_thin", d=1, alpha=1.0),
           dict(name="uniform", d=2, alpha=100.0)]    # alpha > N
    for kw in bad:
        with pytest.raises(ValidationError):
            ddm_workload(kw["name"], 4, 4, alpha=kw["alpha"], d=kw["d"],
                         device="cpu")
        with pytest.raises(ValueError):
            r_ddm_workload(kw["name"], jax.random.PRNGKey(0), 4, 4,
                           alpha=kw["alpha"], d=kw["d"])
