"""Parity of the port's core surface (repro_torch.core) with the JAX
package on the CPU: rank, brute-force, grid and matrix engines, the
``scan_impl`` variants, the prefix scans, the set-form sweep and the d-dim
host reference.

The same numpy inputs, made from a seed, go through both packages; every
quantity is an integer, a boolean or a float32 passed through unchanged, so
every comparison is exact equality.  Where the JAX package counts in int32
that wraps (``bf_count``, ``rank_count`` past 2³¹), the port's int64 total
is held against ``sbm_count_exact`` instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rcore
from repro.core import prefix as rprefix
from repro.core import sweep as rsweep
from repro.core.intervals import Extents as RefExtents
from repro_torch import core as tcore
from repro_torch.core import prefix as tprefix
from repro_torch.core import sweep as tsweep
from repro_torch.core.intervals import Extents

jax.config.update("jax_platform_name", "cpu")

LENGTH = 1000.0
SCANS = ("two_level", "blelloch", "xla")


def _side(lo, hi):
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    return (RefExtents(jnp.asarray(lo), jnp.asarray(hi)),
            Extents(torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())))


def _both(lo, hi, n):
    """Columns [:n] subscriptions, [n:] updates, as (ref pair, port pair)."""
    rs, ts = _side(lo[..., :n], hi[..., :n])
    ru, tu = _side(lo[..., n:], hi[..., n:])
    return (rs, ru), (ts, tu)


def _uniform(rng, n, m, alpha, d=1):
    seg = alpha * LENGTH / (n + m)
    shape = (n + m,) if d == 1 else (d, n + m)
    lo = rng.uniform(0.0, LENGTH - seg, shape).astype(np.float32)
    return lo, lo + np.float32(seg)


def _clustered(rng, n, m, alpha):
    seg = alpha * LENGTH / (n + m)
    centers = rng.uniform(0.0, LENGTH, 5)
    lo = np.clip(centers[rng.integers(0, 5, n + m)]
                 + rng.normal(0.0, LENGTH / 60, n + m), 0.0, LENGTH - seg)
    lo = lo.astype(np.float32)
    return lo, lo + np.float32(seg)


def _tall_thin(rng, n, m, d):
    lo, hi = _uniform(rng, n, m, 4.0, d)
    wide = rng.uniform(0.0, 0.02 * LENGTH, n + m).astype(np.float32)
    lo[0], hi[0] = wide, wide + np.float32(0.98 * LENGTH)
    return lo, hi


def _ties(rng, n, m):
    """Integer-grid extents: shared endpoints, zero widths, -0.0 lows."""
    lo = rng.integers(0, 24, n + m).astype(np.float32)
    hi = lo + rng.integers(0, 5, n + m).astype(np.float32)
    lo[lo == 0.0] = np.float32(-0.0)
    return lo, hi


def _workload(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return _both(*_uniform(rng, 400, 300, 6.0), 400)
    if kind == "clustered":
        return _both(*_clustered(rng, 400, 300, 3.0), 400)
    if kind == "ties":
        return _both(*_ties(rng, 120, 140), 120)
    if kind == "empty_subs":
        return _both(*_uniform(rng, 0, 40, 2.0), 0)
    if kind == "empty_upds":
        return _both(*_uniform(rng, 40, 0, 2.0), 40)
    if kind == "single":
        return _both(np.array([1.0, 1.0], np.float32),
                     np.array([2.0, 1.0], np.float32), 1)
    raise ValueError(kind)


KINDS_1D = ("uniform", "clustered", "ties", "empty_subs", "empty_upds",
            "single")
NONEMPTY_1D = ("uniform", "clustered", "ties", "single")


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# rank and brute force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS_1D)
def test_rank_counts_equal_reference(kind):
    (rs, ru), (ts, tu) = _workload(kind, 1)
    per_sub = tcore.per_sub_match_counts(ts, tu)
    per_upd = tcore.per_upd_match_counts(ts, tu)
    assert per_sub.dtype == per_upd.dtype == torch.int32
    _eq(per_sub, rcore.per_sub_match_counts(rs, ru))
    _eq(per_upd, rcore.per_upd_match_counts(rs, ru))
    k = tcore.rank_count(ts, tu)
    assert k.dtype == torch.int64
    assert int(k) == int(rcore.rank_count(rs, ru)) \
        == rcore.sequential_sbm_count_numpy(rs, ru)


@pytest.mark.parametrize("block", [7, 1024])
@pytest.mark.parametrize("kind", KINDS_1D)
def test_bf_count_equals_reference(kind, block):
    (rs, ru), (ts, tu) = _workload(kind, 2)
    k = tcore.bf_count(ts, tu, block=block)
    assert k.dtype == torch.int64 and k.ndim == 0
    assert int(k) == int(rcore.bf_count(rs, ru, block=block))


def test_rank_count_past_2_pow_31_is_exact_int64():
    """n·m identical extents pass 2³¹ pairs: the JAX package's int32 total
    wraps there, the port's equals sbm_count_exact (bf_count's is held so
    on the card, in chip_smoke.py)."""
    n, m = 65_536, 32_769
    ts = Extents(torch.zeros(n), torch.ones(n))
    tu = Extents(torch.zeros(m), torch.ones(m))
    want = tcore.sbm_count_exact(ts, tu)
    assert want == n * m > 2 ** 31
    assert int(tcore.rank_count(ts, tu)) == want


# ---------------------------------------------------------------------------
# grid
# ---------------------------------------------------------------------------

def _grid_case(case):
    rng = np.random.default_rng(3)
    if case == "uniform":
        return _both(*_uniform(rng, 500, 600, 20.0), 500)
    if case == "ties":
        return _both(*_ties(rng, 200, 180), 200)
    lo, hi = _uniform(rng, 300, 300, 15.0)
    if case == "negative":            # folds into cell 0
        lo[::3] -= np.float32(400.0)
        hi[::5] -= np.float32(300.0)
        lo = np.minimum(lo, hi)
    elif case == "past_length":       # folds into the last cell
        hi[::4] += np.float32(700.0)
        lo[::9] += np.float32(900.0)
        hi = np.maximum(lo, hi)
    return _both(lo, hi, 300)


@pytest.mark.parametrize("cells,cap", [(64, 512), (16, 40), (7, 64)])
@pytest.mark.parametrize("case", ["uniform", "ties", "negative",
                                  "past_length"])
def test_grid_count_equals_reference(case, cells, cap):
    (rs, ru), (ts, tu) = _grid_case(case)
    count, over = tcore.grid_count(ts, tu, num_cells=cells, length=LENGTH,
                                   cap=cap)
    r_count, r_over = rcore.grid_count(rs, ru, num_cells=cells, length=LENGTH,
                                       cap=cap)
    assert (int(count), int(over)) == (int(r_count), int(r_over))
    if int(over) == 0:
        assert int(count) == rcore.sequential_sbm_count_numpy(rs, ru)


def test_grid_count_overflow_is_the_reference_lower_bound_and_strict_raises():
    (rs, ru), (ts, tu) = _grid_case("negative")
    count, over = tcore.grid_count(ts, tu, num_cells=16, length=LENGTH, cap=24)
    r_count, r_over = rcore.grid_count(rs, ru, num_cells=16, length=LENGTH,
                                       cap=24)
    assert int(over) == int(r_over) > 0
    assert int(count) == int(r_count) < tcore.sequential_sbm_count_numpy(ts, tu)
    with pytest.raises(tcore.GridOverflowError, match="cap=24"):
        tcore.grid_count(ts, tu, num_cells=16, length=LENGTH, cap=24,
                         strict=True)
    with pytest.raises(rcore.GridOverflowError):
        rcore.grid_count(rs, ru, num_cells=16, length=LENGTH, cap=24,
                         strict=True)


# ---------------------------------------------------------------------------
# matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2, 3])
def test_match_matrices_and_row_lists_equal_reference(d):
    rng = np.random.default_rng(4 + d)
    lo, hi = _ties(rng, 60 * d, 50)
    lo = np.stack([rng.permutation(lo) for _ in range(d)]) if d > 1 else lo
    hi = lo + rng.integers(0, 5, lo.shape).astype(np.float32)
    (rs, ru), (ts, tu) = _both(lo, hi, 60 * d)
    mask = tcore.match_matrix_ddim(ts, tu)
    _eq(mask, rcore.match_matrix_ddim(rs, ru))
    if d == 1:
        _eq(tcore.match_matrix(ts, tu), rcore.match_matrix(rs, ru))
    for max_per_row in (ru.size, 5):
        idx, counts = tcore.row_index_lists(mask, max_per_row=max_per_row)
        r_idx, r_counts = rcore.row_index_lists(jnp.asarray(mask.numpy()),
                                                max_per_row=max_per_row)
        assert idx.dtype == counts.dtype == torch.int32
        _eq(idx, r_idx)
        _eq(counts, r_counts)


@pytest.mark.parametrize("seq_len,block,window,causal,globals_", [
    (1000, 64, None, True, 0), (1000, 64, 200, True, 0),
    (1024, 128, None, False, 0), (999, 100, 300, True, 2),
    (4096, 512, 1024, False, 1), (70, 16, 1, True, 5)])
def test_block_extents_and_mask_equal_reference(seq_len, block, window,
                                                causal, globals_):
    kw = dict(window=window, causal=causal, num_global_blocks=globals_)
    q, kv = tcore.block_extents_for_sequence(seq_len, block, device="cpu",
                                             **kw)
    rq, rkv = rcore.block_extents_for_sequence(seq_len, block, **kw)
    for got, want in ((q.lo, rq.lo), (q.hi, rq.hi), (kv.lo, rkv.lo),
                      (kv.hi, rkv.hi)):
        assert got.dtype == torch.float32
        _eq(got, want)
    _eq(tcore.block_mask_from_extents(q, kv),
        rcore.block_mask_from_extents(rq, rkv))


def test_document_extents_equal_reference():
    rng = np.random.default_rng(6)
    doc_ids = np.sort(rng.choice([0, 1, 1, 3, 4, 4, 4, 7], 300)).astype(np.int32)
    got = tcore.document_extents(torch.from_numpy(doc_ids), 10)
    want = rcore.document_extents(jnp.asarray(doc_ids), 10)
    _eq(got.lo, want.lo)
    _eq(got.hi, want.hi)


# ---------------------------------------------------------------------------
# prefix scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (7,), (1000,), (3, 33), (2, 4, 64)])
def test_cumsum_blelloch_equals_reference(shape):
    rng = np.random.default_rng(7)
    x = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64).astype(np.int32)
    x[..., : shape[-1] // 2] = rng.integers(0, 9, shape[:-1]
                                            + (shape[-1] // 2,))
    got = tprefix.cumsum_blelloch(torch.from_numpy(x))
    assert got.dtype == torch.int32
    _eq(got, jax.jit(rprefix.cumsum_blelloch)(jnp.asarray(x)))


@pytest.mark.parametrize("case", ["small", "past_2_pow_31", "saturated_start"])
def test_cumsum_saturating_i32_equals_reference(case):
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1000, (4, 300)).astype(np.int32)
    if case == "past_2_pow_31":
        x[:, 100::40] = 2 ** 30 + 7
    elif case == "saturated_start":
        x[:, 0] = 2 ** 31 - 1
    got = tprefix.cumsum_saturating_i32(torch.from_numpy(x))
    want = np.asarray(jax.jit(rprefix.cumsum_saturating_i32)(jnp.asarray(x)))
    _eq(got, want)
    exact = np.cumsum(x.astype(np.int64), axis=-1)
    np.testing.assert_array_equal(got.numpy(), np.minimum(exact, 2 ** 31 - 1))


def test_cumsum_saturating_i32_off_contract_is_the_clamped_exact_prefix():
    """Negative inputs lie outside the contract; the port pins each exact
    prefix clamped into the int32 range."""
    x = np.array([5, -7, 2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31, -2 ** 31,
                  -2 ** 31, 3], np.int32)
    got = tprefix.cumsum_saturating_i32(torch.from_numpy(x)).numpy()
    exact = np.cumsum(x.astype(np.int64))
    np.testing.assert_array_equal(got, np.clip(exact, -2 ** 31, 2 ** 31 - 1))


def test_delta_combine_bool_equals_reference():
    rng = np.random.default_rng(9)
    a1, d1, a2, d2 = (rng.random((5, 70)) < 0.4 for _ in range(4))
    got = tprefix.delta_combine_bool(
        (torch.from_numpy(a1), torch.from_numpy(d1)),
        (torch.from_numpy(a2), torch.from_numpy(d2)))
    want = rprefix.delta_combine_bool((jnp.asarray(a1), jnp.asarray(d1)),
                                      (jnp.asarray(a2), jnp.asarray(d2)))
    for g, w in zip(got, want):
        _eq(g, w)


# ---------------------------------------------------------------------------
# scan_impl through the sweep and the enumeration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("kind", KINDS_1D)
def test_sbm_count_under_each_scan_equals_reference(kind, scan):
    (rs, ru), (ts, tu) = _workload(kind, 10)
    for segs in ((8, 5) if kind == "uniform" else (8,)):
        k = tcore.sbm_count(ts, tu, num_segments=segs, scan_impl=scan)
        assert int(k) == int(rcore.sbm_count(rs, ru, num_segments=segs,
                                             scan_impl=scan))
        assert tcore.sbm_count_exact(ts, tu, num_segments=segs,
                                     scan_impl=scan) == int(k)
        assert tsweep.probe_count(ts, tu, scan_impl=scan)[0] == int(k)


@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("kind", NONEMPTY_1D)
def test_sbm_enumerate_under_each_scan_equals_reference(kind, scan):
    """The pair buffer element for element, also cut short by max_pairs
    (uniform), and the planned form (uniform)."""
    (rs, ru), (ts, tu) = _workload(kind, 11)
    k = rcore.sequential_sbm_count_numpy(rs, ru)
    caps = (k + 5, k // 2) if kind == "uniform" else (k + 5,)
    for max_pairs in caps:
        pairs, count = tcore.sbm_enumerate(ts, tu, max_pairs=max_pairs,
                                           scan_impl=scan)
        r_pairs, r_count = rcore.sbm_enumerate(rs, ru, max_pairs=max_pairs,
                                               scan_impl=scan)
        _eq(pairs, r_pairs)
        assert int(count) == int(r_count) == k
    if kind == "uniform":
        pairs, count, stats = tcore.sbm_enumerate_planned(ts, tu,
                                                          scan_impl=scan)
        r_pairs, r_count, _ = rcore.sbm_enumerate_planned(rs, ru,
                                                          scan_impl=scan)
        _eq(pairs, r_pairs)
        assert int(count) == int(r_count) and stats.retries == 0


def test_unknown_scan_impl_raises_validation_error():
    (rs, ru), (ts, tu) = _workload("uniform", 12)
    for fn in (lambda: tcore.sbm_count(ts, tu, scan_impl="hillis"),
               lambda: tcore.sbm_enumerate(ts, tu, max_pairs=4,
                                           scan_impl="hillis"),
               lambda: tsweep.probe_count(ts, tu, scan_impl="cub"),
               lambda: tsweep.resolve_cumsum("serial", 8)):
        with pytest.raises(tcore.ValidationError, match="scan_impl"):
            fn()
    with pytest.raises(rcore.ValidationError):
        rcore.sbm_count(rs, ru, scan_impl="hillis")


# ---------------------------------------------------------------------------
# the set-form sweep and the host references
# ---------------------------------------------------------------------------

def _stream_eq(ep, r_ep):
    _eq(ep.values, r_ep.values)
    _eq(ep.is_upper, r_ep.is_upper)
    _eq(ep.is_sub, r_ep.is_sub)
    _eq(ep.owner, r_ep.owner)


@pytest.mark.parametrize("segs", [8, 3])
@pytest.mark.parametrize("kind", NONEMPTY_1D)
def test_active_profile_equals_reference(kind, segs):
    (rs, ru), (ts, tu) = _workload(kind, 13)
    ep, a_sub, a_upd = tcore.sbm_active_profile(ts, tu, num_segments=segs)
    r_ep, r_sub, r_upd = rcore.sbm_active_profile(rs, ru, num_segments=segs)
    _stream_eq(ep, r_ep)
    _eq(a_sub, r_sub)
    _eq(a_upd, r_upd)


@pytest.mark.parametrize("segs", [8, 3])
@pytest.mark.parametrize("kind", NONEMPTY_1D)
def test_delta_sets_and_active_sets_equal_reference(kind, segs):
    (rs, ru), (ts, tu) = _workload(kind, 14)
    n, m = ts.size, tu.size
    ep = tsweep._pad_stream(tsweep.encode_endpoints(ts, tu), segs)
    r_ep = rsweep._pad_stream(rsweep.encode_endpoints(rs, ru), segs)
    ref_sets = jax.jit(rsweep.segment_delta_sets, static_argnums=(1, 2, 3))
    for got, want in zip(tsweep.segment_delta_sets(ep, segs, n, m),
                         ref_sets(r_ep, segs, n, m)):
        assert got.dtype == torch.bool
        _eq(got, want)
    ep, s_act, u_act = tcore.active_sets_at_segment_starts(ts, tu, segs)
    r_ep, rs_act, ru_act = jax.jit(rcore.active_sets_at_segment_starts,
                                   static_argnums=2)(rs, ru, segs)
    _stream_eq(ep, r_ep)
    _eq(s_act, rs_act)
    _eq(u_act, ru_act)


def test_segment_delta_sets_refuses_an_unpadded_stream():
    (_, _), (ts, tu) = _workload("uniform", 15)
    ep = tsweep.encode_endpoints(ts, tu)         # 1400 records
    with pytest.raises(tcore.ValidationError, match="padded"):
        tsweep.segment_delta_sets(ep, 9, ts.size, tu.size)


@pytest.mark.parametrize("d", [2, 3])
def test_sequential_pairs_ddim_equals_reference(d):
    rng = np.random.default_rng(16 + d)
    (rs, ru), (ts, tu) = _both(*_tall_thin(rng, 300, 250, d), 300)
    want = rcore.brute_force_pairs_numpy(rs, ru)
    for sweep_dim in range(d):
        got = tcore.sequential_sbm_pairs_numpy_ddim(ts, tu, sweep_dim)
        assert got == rcore.sequential_sbm_pairs_numpy_ddim(rs, ru, sweep_dim)
        assert got == want
    (rs, ru), (ts, tu) = _workload("ties", 17)
    assert tcore.sequential_sbm_pairs_numpy_ddim(ts, tu) \
        == rcore.sequential_sbm_pairs_numpy_ddim(rs, ru)
