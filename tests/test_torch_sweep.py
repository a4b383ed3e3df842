"""Parity of the PyTorch port's sweep (repro_torch) with the JAX package.

The same numpy inputs go through both packages on the CPU; where the
reference reaches a Pallas kernel it runs in interpret mode, and the port's
kernel wrappers take their plain versions (the tensors lie on the CPU).
Every quantity is an integer, a bit word or a float32 endpoint passed
through unchanged, so every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import enumerate as ref_enum
from repro.core import prefix as ref_prefix
from repro.core import sweep as ref_sweep
from repro.core.intervals import Extents as RefExtents
from repro.kernels import ops as ref_ops
from repro.kernels import sbm_sweep as ref_kernels
from repro_torch.core import enumerate as tenum
from repro_torch.core import prefix as tprefix
from repro_torch.core import runtime as truntime
from repro_torch.core import sweep as tsweep
from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sbm_sweep as tkernels

jax.config.update("jax_platform_name", "cpu")


def _both(lo_s, hi_s, lo_u, hi_u):
    """One workload as (reference Extents, port Extents on the CPU)."""
    arrs = [np.asarray(a, np.float32) for a in (lo_s, hi_s, lo_u, hi_u)]
    ref = (RefExtents(jnp.asarray(arrs[0]), jnp.asarray(arrs[1])),
           RefExtents(jnp.asarray(arrs[2]), jnp.asarray(arrs[3])))
    port = (Extents(torch.from_numpy(arrs[0]), torch.from_numpy(arrs[1])),
            Extents(torch.from_numpy(arrs[2]), torch.from_numpy(arrs[3])))
    return ref, port


def _uniform(seed, n, m, alpha, length=1000.0):
    rng = np.random.default_rng(seed)
    seg = alpha * length / (n + m)
    lo = rng.uniform(0.0, length - seg, n + m).astype(np.float32)
    hi = lo + np.float32(seg)
    return _both(lo[:n], hi[:n], lo[n:], hi[n:])


def _clustered(seed, n, m, alpha, length=1000.0, clusters=4):
    rng = np.random.default_rng(seed)
    seg = alpha * length / (n + m)
    centers = rng.uniform(0.0, length, clusters)
    lo = np.clip(centers[rng.integers(0, clusters, n + m)]
                 + rng.normal(0.0, length / 80, n + m), 0.0, length - seg)
    lo = lo.astype(np.float32)
    hi = lo + np.float32(seg)
    return _both(lo[:n], hi[:n], lo[n:], hi[n:])


def _duplicates(seed, n, m):
    """Integer grid endpoints: heavy ties, duplicates, zero-length extents."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 12, n + m).astype(np.float32)
    hi = lo + rng.integers(0, 4, n + m).astype(np.float32)
    return _both(lo[:n], hi[:n], lo[n:], hi[n:])


WORKLOADS = {
    "uniform": lambda: _uniform(1, 90, 70, 20.0),
    "clustered": lambda: _clustered(2, 80, 100, 8.0),
    "duplicates": lambda: _duplicates(3, 60, 50),
}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# stream order
# ---------------------------------------------------------------------------

ORDER_CASES = {
    "ties_and_duplicates": ([1.0, 1.0, 2.0], [1.0, 3.0, 2.0],
                            [1.0, 2.0, 0.0], [2.0, 2.0, 1.0]),
    "lower_before_upper": ([0.0, 1.0], [1.0, 2.0], [1.0, 2.0], [1.0, 3.0]),
    "signed_zero": ([0.0, -0.0, -0.0], [0.0, 0.0, -0.0],
                    [-0.0, 0.0], [-0.0, 1.0]),
    "zero_length": ([5.0, 5.0], [5.0, 5.0], [5.0], [5.0]),
}


@pytest.mark.parametrize("case", sorted(ORDER_CASES) + sorted(WORKLOADS))
def test_encode_endpoints_matches_reference_lexsort(case):
    if case in ORDER_CASES:
        (rs, ru), (ts, tu) = _both(*ORDER_CASES[case])
    else:
        (rs, ru), (ts, tu) = WORKLOADS[case]()
    want = ref_sweep.encode_endpoints(rs, ru)
    got = tsweep.encode_endpoints(ts, tu)
    # float32 bit patterns, so −0.0 and +0.0 must land where the reference
    # put them
    np.testing.assert_array_equal(_np(got.values).view(np.int32),
                                  np.asarray(want.values).view(np.int32))
    for field in ("is_upper", "is_sub", "owner"):
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(want, field)))


# ---------------------------------------------------------------------------
# counting: passes A/B and the count entry points
# ---------------------------------------------------------------------------

# 4, 12 and 36: segments shorter than one warp's span of the pass-B kernel
# (a block of 32 threads, most idle), so its small shapes have a CPU oracle
@pytest.mark.parametrize("block_size", [4, 12, 36, 64, 256])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pass_ab_plain_matches_pallas_interpret(name, block_size):
    (rs, ru), (ts, tu) = WORKLOADS[name]()
    ep = ref_sweep._pad_stream(ref_sweep.encode_endpoints(rs, ru), block_size)
    deltas = jnp.stack(ref_sweep._indicator_deltas(ep))
    emit_r, k_r = ref_kernels.sweep_count_pallas(deltas, block_size=block_size,
                                                 interpret=True)
    tdeltas = torch.from_numpy(np.array(deltas))
    emit, seg, k = tkernels.sweep_count(tdeltas, block_size=block_size)
    np.testing.assert_array_equal(emit.numpy(), np.asarray(emit_r))
    assert int(k) == int(k_r) == int(seg.sum())
    np.testing.assert_array_equal(
        seg.numpy(), np.asarray(emit_r).reshape(-1, block_size).sum(axis=1))
    emit_m, k_m = tref.ref_sweep_count(tdeltas)      # monolithic oracle
    assert torch.equal(emit_m, emit) and int(k_m) == int(k)
    assert tkernels.block_sums.launches == 0         # CPU: no kernel launched


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_counts_match_sbm_count_exact(name):
    (rs, ru), (ts, tu) = WORKLOADS[name]()
    want = ref_sweep.sbm_count_exact(rs, ru)
    assert want == ref_sweep.sequential_sbm_count_numpy(rs, ru)
    assert tsweep.sbm_count_exact(ts, tu) == want
    assert int(tsweep.sbm_count(ts, tu, num_segments=4)) == want
    assert tsweep.sequential_sbm_count_numpy(ts, tu) == want
    for bs in (64, 2048):
        k = tops.sbm_count_kernel(ts, tu, block_size=bs)
        assert k.dtype == torch.int64 and int(k) == want
    assert tsweep.probe_count(ts, tu)[0] == want


def test_count_exact_beyond_int32():
    """Identical extents: K = n·m = 2^32 overflows int32; the port's counts
    are int64-exact (the reference's x64 behaviour)."""
    n = 1 << 16
    subs = Extents(torch.zeros(n), torch.ones(n))
    assert tsweep.sbm_count_exact(subs, subs) == n * n
    assert int(tops.sbm_count_kernel(subs, subs)) == n * n


# ---------------------------------------------------------------------------
# prefix: bit layout and the delta monoid
# ---------------------------------------------------------------------------

def test_pack_bits_layout_matches_reference():
    rng = np.random.default_rng(4)
    mask = rng.random((3, 70)) < 0.4
    want = np.asarray(ref_prefix.pack_bits(jnp.asarray(mask)))
    got = tprefix.pack_bits(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tprefix.unpack_bits(got, 70).numpy(), mask)


def test_delta_scan_exclusive_matches_reference():
    rng = np.random.default_rng(5)
    add = rng.integers(0, 2**32, (6, 3), dtype=np.uint64).astype(np.uint32)
    rem = rng.integers(0, 2**32, (6, 3), dtype=np.uint64).astype(np.uint32) \
        & ~add
    want = np.asarray(ref_prefix.delta_scan_exclusive(jnp.asarray(add),
                                                      jnp.asarray(rem)))
    got = tprefix.delta_scan_exclusive(torch.from_numpy(add.view(np.int32)),
                                       torch.from_numpy(rem.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    a, d = tprefix.delta_combine_bits(
        (torch.from_numpy(add[0].view(np.int32)),
         torch.from_numpy(rem[0].view(np.int32))),
        (torch.from_numpy(add[1].view(np.int32)),
         torch.from_numpy(rem[1].view(np.int32))))
    ra, rd = ref_prefix.delta_combine_bits((jnp.asarray(add[0]), jnp.asarray(rem[0])),
                                           (jnp.asarray(add[1]), jnp.asarray(rem[1])))
    np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(ra))
    np.testing.assert_array_equal(d.numpy().view(np.uint32), np.asarray(rd))


def _random_words(rng, shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["disjoint", "overlapping"])
@pytest.mark.parametrize("w", [1, 3, 5])
@pytest.mark.parametrize("p", [1, 2, 7])
def test_delta_scan_exclusive_matches_reference_on_any_words(p, w, overlap):
    """The plain scan on packed words equals the JAX package's associative
    scan over P segments of W words, Add and Del disjoint or sharing bits
    (as the delta-bitmask kernel's words may)."""
    rng = np.random.default_rng(100 * p + 10 * w + overlap)
    add = _random_words(rng, (p, w))
    rem = _random_words(rng, (p, w))
    if not overlap:
        rem &= ~add
    assert bool((add & rem).any()) == overlap
    got = tprefix.delta_scan_exclusive(torch.from_numpy(add.view(np.int32)),
                                       torch.from_numpy(rem.view(np.int32)))
    want = ref_prefix.delta_scan_exclusive(jnp.asarray(add), jnp.asarray(rem))
    assert got.dtype == torch.int32 and got.shape == add.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_delta_scan_wrapper_on_cpu_is_the_plain_scan():
    """On CPU words the scan kernel's wrapper returns the plain scan and
    counts no launch."""
    rng = np.random.default_rng(11)
    add, rem = (torch.from_numpy(_random_words(rng, (7, 5)).view(np.int32))
                for _ in range(2))
    before = tkernels.delta_scan.launches
    got = tkernels.delta_scan(add, rem)
    assert tkernels.delta_scan.launches == before
    assert torch.equal(got, tprefix.delta_scan_exclusive(add, rem))


def _scan_args(kind):
    add, rem = (torch.zeros((3, 4), dtype=torch.int32) for _ in range(2))
    if kind == "float":
        return add.float(), rem.float()
    if kind == "bool":
        return add.bool(), rem.bool()
    if kind == "int64":
        return add.long(), rem.long()
    if kind == "shapes":
        return add, torch.zeros((3, 5), dtype=torch.int32)
    if kind == "one_d":
        return add[0], rem[0]
    if kind == "empty":
        return (torch.zeros((3, 0), dtype=torch.int32),) * 2
    assert kind == "non_contiguous"
    return torch.zeros((4, 3), dtype=torch.int32).t(), rem


@pytest.mark.parametrize("kind", ["float", "bool", "int64", "shapes",
                                  "one_d", "empty", "non_contiguous"])
def test_delta_scan_refuses_what_the_kernel_cannot_take(kind):
    with pytest.raises(ValidationError):
        tkernels.delta_scan(*_scan_args(kind))


# ---------------------------------------------------------------------------
# delta bitmasks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_size", [32, 128])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_delta_bitmasks_match_pallas_interpret(name, block_size):
    (rs, ru), (ts, tu) = WORKLOADS[name]()
    want = ref_ops.sbm_delta_bitmasks(rs, ru, block_size=block_size,
                                      interpret=True)
    got = tops.sbm_delta_bitmasks(ts, tu, block_size=block_size)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
    # second check: the vectorized plain version against the sequential
    # replay of Algorithm 6
    ep = tsweep._pad_stream(tsweep.encode_endpoints(ts, tu), block_size)
    up = ep.is_upper.to(torch.int32)
    valid = (ep.is_sub & (ep.owner >= 0)).to(torch.int32)
    replay = tref.ref_delta_bitmasks_replay(ep.owner.clamp(min=0), up, valid,
                                            num_words=got[0].shape[1],
                                            block_size=block_size)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), replay[0])
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), replay[1])


# records of one type, block 8, owners 3 and 5, num_words 1: the streams on
# which a plain version reading Algorithm 6's invariant ("lower in this
# segment, upper not") departs from the Pallas replay
BITMASK_CASES = {
    "lower_upper_upper": ([3, 3, 3] + [0] * 5, [0, 1, 1] + [0] * 5,
                          [1, 1, 1] + [0] * 5),
    "upper_then_lower": ([3, 3] + [0] * 6, [1, 0] + [0] * 6,
                         [1, 1] + [0] * 6),
    "lower_in_two_segments": ([5] + [0] * 7 + [5, 5] + [0] * 6,
                              [0] * 8 + [0, 1] + [0] * 6,
                              [1] + [0] * 7 + [1, 1] + [0] * 6),
    "negative_owner": ([-4, 0, -1, 7] + [0] * 4, [0, 1, 1, 0] + [0] * 4,
                       [1, 1, 1, 1] + [0] * 4),
}


def _bitmask_off_contract(kind, name, block_size):
    """One extent type's records of a well-formed stream (built by the
    reference) pushed off the contract by ``tref.off_contract_records``:
    numpy int32 (owner, is_upper, valid) and num_words."""
    (rs, ru), _ = WORKLOADS[name]()
    ep = ref_sweep._pad_stream(ref_sweep.encode_endpoints(rs, ru), block_size)
    valid = np.asarray(ep.is_sub & (ep.owner >= 0)).astype(np.int32)
    records = [torch.from_numpy(np.array(a, np.int32))
               for a in (ep.owner, ep.is_upper, valid)]
    records = tref.off_contract_records(kind, *records, block_size=block_size)
    return [r.numpy() for r in records], -(-rs.lo.shape[0] // 32)


BITMASK_OFF_CONTRACT = sorted(BITMASK_CASES) + [
    f"{kind}-{name}-{bs}" for kind in tref.OFF_CONTRACT_KINDS
    for name in sorted(WORKLOADS) for bs in (32, 64)]


@pytest.mark.parametrize("case", BITMASK_OFF_CONTRACT)
def test_delta_bitmasks_plain_matches_pallas_on_any_records(case):
    """The plain version (the wrapper's CPU route) equals the Pallas kernel
    in interpret mode and the sequential replay exactly on records outside
    the sorted stream's contract."""
    if case in BITMASK_CASES:
        records = [np.array(a, np.int32) for a in BITMASK_CASES[case]]
        block_size, num_words = 8, 1
    else:
        kind, name, bs = case.rsplit("-", 2)
        block_size = int(bs)
        records, num_words = _bitmask_off_contract(kind, name, block_size)
    want = ref_kernels.delta_bitmasks_pallas(
        *(jnp.asarray(a) for a in records), num_words=num_words,
        block_size=block_size, interpret=True)
    got = tkernels.delta_bitmasks(*(torch.from_numpy(a) for a in records),
                                  num_words=num_words, block_size=block_size)
    replay = tref.ref_delta_bitmasks_replay(*records, num_words=num_words,
                                            block_size=block_size)
    for g, w, r in zip(got, want, replay):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))
        np.testing.assert_array_equal(g.numpy().view(np.uint32), r)
    if case not in BITMASK_CASES:         # really off the contract
        assert _bitmask_faults(*records) > 0


def _bitmask_faults(owner, up, valid):
    """Records that break the contract of a sorted stream: a lower of an
    extent opened before, an upper of one never opened or closed before."""
    faults, opened, closed = 0, set(), set()
    for o, u, v in zip(owner.tolist(), up.tolist(), valid.tolist()):
        if not v:
            continue
        if u:
            faults += o not in opened or o in closed
            closed.add(o)
        else:
            faults += o in opened
            opened.add(o)
    return faults


@pytest.mark.parametrize("block_size", [32, 64])
def test_delta_bitmasks_ignore_owners_beyond_the_words(block_size):
    """Owners >= 32·num_words write nothing: the plain version gives what
    it gives with those records dropped, and the replay's answer."""
    rng = np.random.default_rng(block_size)
    num_words, total = 2, 4 * block_size
    owner = rng.integers(-5, 64 + 40, total).astype(np.int32)
    up = rng.integers(0, 2, total).astype(np.int32)
    valid = rng.integers(0, 2, total).astype(np.int32)
    wide = (owner >= 32 * num_words) & (valid != 0)
    assert wide.any()
    kw = dict(num_words=num_words, block_size=block_size)
    got = tkernels.delta_bitmasks(*map(torch.from_numpy, (owner, up, valid)),
                                  **kw)
    dropped = tkernels.delta_bitmasks(
        *map(torch.from_numpy, (owner, up, np.where(wide, 0, valid))), **kw)
    replay = tref.ref_delta_bitmasks_replay(owner, up, valid, **kw)
    for g, d, r in zip(got, dropped, replay):
        assert g.shape == (4, num_words) and torch.equal(g, d)
        np.testing.assert_array_equal(g.numpy().view(np.uint32), r)
    # within the words the Pallas kernel gives the same answer
    want = ref_kernels.delta_bitmasks_pallas(
        *(jnp.asarray(a) for a in (owner, up, np.where(wide, 0, valid))),
        interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


# ---------------------------------------------------------------------------
# pass C and the kernel enumeration engine
# ---------------------------------------------------------------------------

def _pass_c_inputs(rs, ru, block_size):
    """Pass C's inputs, built by the reference and handed to both."""
    n, m = rs.lo.shape[0], ru.lo.shape[0]
    ep = ref_sweep._pad_stream(ref_sweep.encode_endpoints(rs, ru), block_size)
    deltas = jnp.stack(ref_sweep._indicator_deltas(ep))
    emit, _ = ref_kernels.sweep_count_pallas(deltas, block_size=block_size,
                                             interpret=True)
    cap = max(int(np.asarray(emit).reshape(-1, block_size).sum(1).max()), 1)
    sadd, sdel, uadd, udel = ref_ops.sbm_delta_bitmasks(
        rs, ru, block_size=block_size, interpret=True)
    args = (jnp.clip(ep.owner, 0, None), ep.is_upper.astype(jnp.int32),
            ep.is_sub.astype(jnp.int32), (ep.owner >= 0).astype(jnp.int32),
            ref_prefix.delta_scan_exclusive(sadd, sdel),
            ref_prefix.delta_scan_exclusive(uadd, udel))
    assert n and m
    return args, cap


def _signed_zero_ties(seed, n, m):
    """A small integer grid around 0 with random -0.0 bounds: ties between
    lowers and uppers, zero-length extents and both zeros."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(-3, 4, n + m).astype(np.float32)
    hi = lo + rng.integers(0, 3, n + m).astype(np.float32)
    for x in (lo, hi):
        x[(x == 0) & (rng.random(n + m) < 0.5)] = np.float32(-0.0)
    return _both(lo[:n], hi[:n], lo[n:], hi[n:])


def _emit_counts_closed_form(up, is_sub, real, sub_active0, upd_active0,
                             block_size):
    """Pass C's per-endpoint counts as its kernel derives them: at an upper
    endpoint, the counterpart popcount entering the segment plus the
    counterpart lowers before it in the segment minus the counterpart
    uppers before it; 0 elsewhere."""
    nb = up.shape[0] // block_size
    up, sb, va = (x.reshape(nb, block_size) for x in (up != 0, is_sub, real))
    step = torch.where(up, -1, 1).to(torch.int32)
    active = []
    for side, words in ((sb, sub_active0), (~sb, upd_active0)):
        d = torch.where(va & side, step, 0)
        before = torch.cumsum(d, dim=1, dtype=torch.int32) - d
        entering = tprefix.popcount32(words).sum(dim=1, dtype=torch.int32)
        active.append(before + entering[:, None])
    emit = torch.where(va & up, torch.where(sb, active[1], active[0]), 0)
    return emit.to(torch.int32).reshape(-1)


@pytest.mark.parametrize("block_size", [16, 64])
@pytest.mark.parametrize("name", sorted(WORKLOADS) + ["signed_zero_ties"])
def test_pass_c_slot_counts_equal_pass_b_emit(name, block_size):
    """The identity the pass-C kernel derives its slot bases from: at an
    upper endpoint, the counterpart popcount entering the segment plus the
    counterpart lowers before it in the segment minus the uppers before it
    equals pass B's emission count, segment by segment.  It holds because
    the streams the engine builds meet the contract the kernel checks on
    the card: every lower finds its bit clear, every upper finds it set."""
    make = WORKLOADS.get(name, lambda: _signed_zero_ties(4, 70, 60))
    _, (ts, tu) = make()
    n, m = ts.size, tu.size
    ep = tsweep._pad_stream(tsweep.encode_endpoints(ts, tu), block_size)
    deltas = torch.stack(tsweep._indicator_deltas(ep))
    sums = tref.ref_block_sums(deltas, block_size=block_size)
    offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
    emit, seg = tref.ref_emission(deltas, offsets, block_size=block_size)
    up = ep.is_upper.to(torch.int32)
    real = ep.owner >= 0
    active0 = []
    for side, count in ((ep.is_sub, n), (~ep.is_sub, m)):
        add, rem = tref.ref_delta_bitmasks(
            ep.owner, up, (side & real).to(torch.int32),
            num_words=-(-count // 32), block_size=block_size)
        active0.append(tprefix.delta_scan_exclusive(add, rem))
    got = _emit_counts_closed_form(up, ep.is_sub, real, *active0,
                                   block_size)
    assert got.dtype == torch.int32
    assert torch.equal(got, emit)
    assert torch.equal(got.reshape(-1, block_size).sum(dim=1,
                                                       dtype=torch.int64), seg)
    # where the count is 1, the XOR of the counterpart's ids entering the
    # segment and of its endpoints before this one is the one member: the
    # pair the replay writes at the endpoint's slot base
    cap = max(int(seg.max()), 1)
    out_i, out_j = tref.ref_emit_pairs(ep.owner.clamp(min=0), up,
                                       ep.is_sub.to(torch.int32),
                                       real.to(torch.int32), *active0,
                                       block_size=block_size, cap=cap)
    owner = ep.owner.numpy().reshape(-1, block_size)
    is_sub = ep.is_sub.numpy().reshape(-1, block_size)
    live = real.numpy().reshape(-1, block_size)
    counts = got.numpy().reshape(-1, block_size)
    upper = ep.is_upper.numpy().reshape(-1, block_size)
    singles = 0
    for p in range(owner.shape[0]):
        acc = {True: 0, False: 0}
        live_sets = {}
        for side, words in ((True, active0[0][p]), (False, active0[1][p])):
            live_sets[side] = tref._members(words.numpy().view(np.uint32))
            for member in live_sets[side]:
                acc[side] ^= member
        slot = 0
        for t in range(block_size):
            if not live[p, t]:
                continue
            side = bool(is_sub[p, t])
            o = int(owner[p, t])
            if upper[p, t] and counts[p, t] == 1:
                pair = (int(out_i[p, slot]), int(out_j[p, slot]))
                assert pair == ((o, acc[False]) if side else (acc[True], o))
                singles += 1
            assert (o in live_sets[side]) == bool(upper[p, t])  # the contract
            live_sets[side] ^= {o}
            acc[side] ^= o
            slot += int(counts[p, t])
    assert singles > 0 or name == "signed_zero_ties"   # dense ties: none


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pass_c_arrays_match_pallas_interpret(name):
    (rs, ru), (ts, tu) = WORKLOADS[name]()
    block_size = 64
    args, cap = _pass_c_inputs(rs, ru, block_size)
    want_i, want_j = ref_kernels.sweep_emit_pairs_pallas(
        *args, block_size=block_size, cap=cap, interpret=True)
    targs = [torch.from_numpy(np.array(a).view(np.int32)) for a in args]
    got_i, got_j = tkernels.emit_pairs(*targs, block_size=block_size, cap=cap)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))


def _off_contract(kind, args, cap, block_size, seed):
    """Pass C's inputs pushed outside the contract its CUDA kernel's closed
    forms need (every lower finds its bit clear, every upper finds it set),
    as numpy int32 / uint32 arrays, and the cap."""
    owner, up, sub, valid = (np.array(a, np.int32) for a in args[:4])
    sets = [np.array(a, np.uint32) for a in args[4:]]
    rng = np.random.default_rng(seed)
    segs = owner.size // block_size
    if kind in ("lower_twice", "cap_cuts"):
        # the first subscription lower of each segment comes again in place
        # of the record after it: it finds its bit set
        for p in range(segs):
            t = np.arange(p * block_size, (p + 1) * block_size - 1)
            lows = t[(sub[t] == 1) & (up[t] == 0) & (valid[t] == 1)]
            if lows.size:
                nxt = lows[0] + 1
                owner[nxt], up[nxt], sub[nxt], valid[nxt] = \
                    owner[lows[0]], 0, 1, 1
    if kind == "upper_bit_clear":
        # a lower whose upper lies in its segment is dropped (made padding):
        # the upper finds its bit clear
        for p in range(segs):
            t = np.arange(p * block_size, (p + 1) * block_size)
            for i in t[(up[t] == 0) & (valid[t] == 1)]:
                later = t[(t > i) & (owner[t] == owner[i]) & (sub[t] == sub[i])
                          & (up[t] == 1)]
                if later.size:
                    valid[i] = 0
                    break
    if kind in ("stray_bits", "cap_cuts"):
        # entering sets with stray members, some of them extents whose lower
        # comes in the segment
        for words in sets:
            words |= (rng.integers(0, 2 ** 32, words.shape, dtype=np.uint64)
                      & rng.integers(0, 2 ** 32, words.shape,
                                     dtype=np.uint64)).astype(np.uint32)
    if kind == "cap_cuts":
        cap = max(cap // 3, 1)
    return (owner, up, sub, valid, *sets), cap


OFF_CONTRACT = ("lower_twice", "upper_bit_clear", "stray_bits", "cap_cuts")


@pytest.mark.parametrize("kind", OFF_CONTRACT)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pass_c_plain_matches_pallas_outside_the_contract(name, kind):
    """Records outside the contract of the CUDA kernel's fast path: the
    plain replay (which the kernel's general path follows) and the Pallas
    kernel in interpret mode give equal arrays element for element."""
    (rs, ru), _ = WORKLOADS[name]()
    block_size = 64
    args, cap = _pass_c_inputs(rs, ru, block_size)
    args, cap = _off_contract(kind, args, cap, block_size, seed=len(name))
    want_i, want_j = ref_kernels.sweep_emit_pairs_pallas(
        *(jnp.asarray(a) for a in args), block_size=block_size, cap=cap,
        interpret=True)
    targs = [torch.from_numpy(a.view(np.int32)) for a in args]
    got_i, got_j = tkernels.emit_pairs(*targs, block_size=block_size, cap=cap)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
    assert _toggle_faults(*args, block_size) > 0     # really outside it
    assert kind != "cap_cuts" or bool((got_i[:, -1] >= 0).any())  # it cuts


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pass_c_list_rule_matches_pallas_interpret(name):
    """The membership rule of the CUDA kernel's list path (each upper's
    counterpart set: the entries (id, open, close) with open < i < close,
    in id order) gives the Pallas kernel's arrays element for element, at
    the full cap and at one that cuts, and flags no segment of a stream
    the engine builds."""
    (rs, ru), _ = WORKLOADS[name]()
    block_size = 64
    args, cap = _pass_c_inputs(rs, ru, block_size)
    targs = [torch.from_numpy(np.array(a).view(np.int32)) for a in args]
    for c in (cap, max(cap // 3, 1)):
        want_i, want_j = ref_kernels.sweep_emit_pairs_pallas(
            *args, block_size=block_size, cap=c, interpret=True)
        got_i, got_j, flagged = tref.ref_emit_pairs_lists(
            *targs, block_size=block_size, cap=c)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
        assert flagged.dtype == torch.bool and not bool(flagged.any())


@pytest.mark.parametrize("kind", OFF_CONTRACT)
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_pass_c_list_rule_flags_every_kind_outside_the_contract(name, kind):
    """Records outside the contract: the list rule flags a segment (which
    the kernel sends to its general path) and, with those segments
    replayed, still gives the Pallas kernel's arrays."""
    (rs, ru), _ = WORKLOADS[name]()
    block_size = 64
    args, cap = _pass_c_inputs(rs, ru, block_size)
    args, cap = _off_contract(kind, args, cap, block_size, seed=len(name))
    want_i, want_j = ref_kernels.sweep_emit_pairs_pallas(
        *(jnp.asarray(a) for a in args), block_size=block_size, cap=cap,
        interpret=True)
    got_i, got_j, flagged = tref.ref_emit_pairs_lists(
        *(torch.from_numpy(a.view(np.int32)) for a in args),
        block_size=block_size, cap=cap)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_j.numpy(), np.asarray(want_j))
    assert bool(flagged.any())


def _toggle_faults(owner, up, sub, valid, s0, u0, block_size):
    """How many toggles of the records find their bit the wrong way."""
    faults = 0
    for p in range(owner.size // block_size):
        live = {1: tref._members(s0[p]), 0: tref._members(u0[p])}
        for t in range(p * block_size, (p + 1) * block_size):
            if not valid[t]:
                continue
            side, o = int(sub[t] != 0), int(owner[t])
            faults += (o in live[side]) != bool(up[t])
            if up[t]:
                live[side].discard(o)
            else:
                live[side].add(o)
    return faults


@pytest.mark.parametrize("max_pairs", [16, 4096])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_enumerate_kernel_arrays_match_pallas_interpret(name, max_pairs):
    """The whole engine (passes A/B, bitmasks, monoid scan, pass C, stitch)
    gives the reference's padded buffer element for element, including a
    buffer too short for K (count stays exact)."""
    (rs, ru), (ts, tu) = WORKLOADS[name]()
    want, k_r = ref_ops.sbm_enumerate_kernel(rs, ru, max_pairs=max_pairs,
                                             block_size=64, interpret=True)
    got, k = tops.sbm_enumerate_kernel(ts, tu, max_pairs=max_pairs,
                                       block_size=64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(k) == int(k_r)


@pytest.mark.parametrize("block_size", [16, 4096, 32768])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_enumerate_kernel_output_does_not_depend_on_segment_size(name,
                                                                 block_size):
    """Pass C writes each segment's pairs in stream order and the stitch
    concatenates segments in stream order: the engine's buffer and count
    at any segment size equal those at 64, element for element (on the
    card a segment above the kernels' limits runs at ``card_segment``'s
    size, which this makes safe)."""
    (_, _), (ts, tu) = WORKLOADS[name]()
    want, k_want = tops.sbm_enumerate_kernel(ts, tu, max_pairs=4096,
                                             block_size=64)
    got, k = tops.sbm_enumerate_kernel(ts, tu, max_pairs=4096,
                                       block_size=block_size)
    assert torch.equal(got, want) and int(k) == int(k_want) > 0


@pytest.mark.parametrize("max_pairs", [16, 4096])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_sbm_enumerate_order_matches_reference(name, max_pairs):
    (rs, ru), (ts, tu) = WORKLOADS[name]()
    want, k_r = ref_enum.sbm_enumerate(rs, ru, max_pairs=max_pairs)
    got, k = tenum.sbm_enumerate(ts, tu, max_pairs=max_pairs)
    assert got.dtype == torch.int32 and k.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(k) == int(k_r)


def test_oracles_match_reference():
    (rs, ru), (ts, tu) = WORKLOADS["duplicates"]()
    want, k_r = ref_enum.enumerate_matches(rs, ru, max_pairs=512, block=16)
    got, k = tenum.enumerate_matches(ts, tu, max_pairs=512, block=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(k) == int(k_r)
    np.testing.assert_array_equal(tenum.enumerate_matches_sweep_numpy(ts, tu),
                                  ref_enum.enumerate_matches_sweep_numpy(rs, ru))
    assert tsweep.sequential_sbm_pairs_numpy(ts, tu) \
        == ref_sweep.sequential_sbm_pairs_numpy(rs, ru)


def test_planned_enumeration_is_retry_free_and_counts_builds():
    (_, _), (ts, tu) = WORKLOADS["uniform"]()
    rec = truntime.StatsRecorder()
    pairs, count, stats = tenum.sbm_enumerate_planned(ts, tu, recorder=rec)
    assert stats.retries == 0 and stats.recompiles == 0
    assert stats.capacity == truntime.round_up_pow2(int(count))
    assert rec.calls == 1
    assert truntime.pair_set(pairs) == tsweep.sequential_sbm_pairs_numpy(ts, tu)


@pytest.mark.parametrize("n,m,block_size,want", [
    # ceil(4e6 / 4096) = 977 segments x 8 arrays x 31,250 words: ~1 GB
    (10 ** 6, 10 ** 6, 4096, 977_000_000),
    # ceil(4e7 / 4096) = 9,766 segments x 8 x 312,500 words: ~98 GB
    (10 ** 7, 10 ** 7, 4096, 97_660_000_000),
    (10 ** 5, 10 ** 5, 4096, 9_800_000),        # the main path: ~10 MB
    (33, 1, 64, 4 * 2 * 4 * (2 + 1)),           # words round up
    (0, 5, 4096, 0),
])
def test_pass_c_scratch_bytes(n, m, block_size, want):
    """The pass-C engine's live (num_blocks, W) words, as the engine
    allocates them: Add/Del of both sides, both entering sets, pass C's two
    scratch copies."""
    assert tops.pass_c_scratch_bytes(n, m, block_size) == want


def test_pass_c_scratch_bytes_counts_the_engines_arrays():
    """On a small stream the reckoning equals the bytes of the arrays the
    engine builds: the four bitmask outputs and the two entering sets (pass
    C's scratch copies are the entering sets' shapes again)."""
    (_, _), (ts, tu) = WORKLOADS["uniform"]()
    bs = 64
    sadd, sdel, uadd, udel = tops.sbm_delta_bitmasks(ts, tu, block_size=bs)
    s0 = tprefix.delta_scan_exclusive(sadd, sdel)
    u0 = tprefix.delta_scan_exclusive(uadd, udel)
    arrays = (sadd, sdel, uadd, udel, s0, u0, s0, u0)
    assert sum(a.numel() * a.element_size() for a in arrays) == \
        tops.pass_c_scratch_bytes(ts.size, tu.size, bs)


def test_round_up_pow2_matches_reference_ladder():
    from repro.core.runtime import round_up_pow2
    for k in list(range(1, 70)) + [1000, 1 << 20, (1 << 20) + 1]:
        assert truntime.round_up_pow2(k) == round_up_pow2(k)
