"""Boundaries of the PyTorch port (repro_torch): it imports neither JAX nor
the JAX package, its entry points default to the card, its kernel wrappers
never fall back silently, and ``chip_smoke.py`` refuses to run without a
card.  The CUDA kernels themselves are tested by the ``cuda``-marked test,
which skips on a machine without a card and ``nvcc``."""
import ast
import inspect
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import extents_from_arrays, model_params_from_arrays
from repro_torch.core import intervals
from repro_torch.core import prefix as tprefix
from repro_torch.core.errors import ValidationError
from repro_torch.core.incremental import IncrementalIndex
from repro_torch.core.service import DDMService
from repro_torch.data import ddm_workload
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import bitmatch as tbitmatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sbm_sweep as tkernels
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.models import Model
from repro_torch.models.api import init_params
from repro_torch.serve.engine import ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == [], f"{path.name} imports {bad}"


def test_entry_points_default_to_the_card():
    for fn in (DDMService, IncrementalIndex, intervals.make_uniform_workload,
               intervals.make_clustered_workload,
               intervals.make_tall_thin_workload, ddm_workload,
               extents_from_arrays, Model, init_params, ServeEngine,
               model_params_from_arrays, SyntheticLM):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn
    assert DDMService().device == torch.device("cuda")
    cfg = reduce_config(get_config("smollm-360m"))
    assert Model(cfg).device == torch.device("cuda")


def test_no_silent_cpu_path_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    svc = DDMService()
    svc.register("sub", np.zeros(3, np.float32), np.ones(3, np.float32))
    svc.register("upd", np.zeros(2, np.float32), np.ones(2, np.float32))
    with pytest.raises((RuntimeError, AssertionError)):
        svc.match_count()
    with pytest.raises((RuntimeError, AssertionError)):
        intervals.make_uniform_workload(4, 4, 1.0)
    model = Model(reduce_config(get_config("smollm-360m")))
    with pytest.raises((RuntimeError, AssertionError)):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises((RuntimeError, AssertionError)):
        model.init_cache(1, 8)


def test_wrappers_validate_and_do_not_count_plain_runs():
    deltas = torch.zeros((4, 64), dtype=torch.int32)
    before = tkernels.block_sums.launches
    assert torch.equal(tkernels.block_sums(deltas, block_size=32),
                       torch.zeros((2, 4), dtype=torch.int32))
    assert tkernels.block_sums.launches == before
    with pytest.raises(ValidationError):
        tkernels.block_sums(deltas, block_size=48)          # ragged segment
    with pytest.raises(ValidationError):
        tkernels.block_sums(deltas.to(torch.int64), block_size=32)
    with pytest.raises(ValidationError):
        tkernels.block_sums(deltas.t().contiguous().t(), block_size=32)
    with pytest.raises(ValidationError):                    # no meta kernel
        tkernels.block_sums(deltas.to("meta"), block_size=32)
    # the flash wrapper: the plain version on the CPU, at any head width
    q = torch.zeros((1, 2, 64, 256))
    idx, cnt, _ = tops.build_block_structure(64, 64, block_q=32, block_k=32)
    idx, cnt = torch.from_numpy(idx), torch.from_numpy(cnt)
    before = flash_attention_kernel.launches
    assert torch.equal(flash_attention_kernel(q, q, q, idx, cnt, block_q=32,
                                              block_k=32), q)
    assert flash_attention_kernel.launches == before
    with pytest.raises(ValidationError):                    # mixed devices
        flash_attention_kernel(q, q, q, idx.to("meta"), cnt, block_q=32,
                               block_k=32)


def test_delta_bitmask_block_limit_is_the_kernels_alone():
    """Above ``BITMASK_MAX_BLOCK`` only the kernel refuses (the
    ``cuda``-marked test checks that); on the CPU the plain version takes
    any segment size and launches nothing."""
    bs = tkernels.BITMASK_MAX_BLOCK + 1
    owner = torch.arange(2 * bs, dtype=torch.int32) % 64
    up = (torch.arange(2 * bs, dtype=torch.int32) // 64) % 2
    valid = torch.ones(2 * bs, dtype=torch.int32)
    before = tkernels.delta_bitmasks.launches
    got = tkernels.delta_bitmasks(owner, up, valid, num_words=2,
                                  block_size=bs)
    assert tkernels.delta_bitmasks.launches == before
    want = tref.ref_delta_bitmasks_replay(owner, up, valid, num_words=2,
                                          block_size=bs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_pass_c_block_limit_is_the_kernels_alone():
    """Above pass C's shared-memory limit (about 9,300 records at small W)
    only the kernel refuses (the ``cuda``-marked test checks that); on the
    CPU the plain version takes any segment size and launches nothing."""
    from repro_torch.core.sweep import _pad_stream, encode_endpoints

    g = torch.Generator().manual_seed(4)
    subs, upds = intervals.make_uniform_workload(300, 200, 5.0, generator=g,
                                                 device="cpu")
    ws, wu = tops._num_words(subs.size), tops._num_words(upds.size)
    outs = []
    for bs in (64, 12_000):
        ep = _pad_stream(encode_endpoints(subs, upds), bs)
        nb = ep.owner.shape[0] // bs
        add_s, del_s, add_u, del_u = tops._type_bitmasks(
            ep, ep.is_upper.to(torch.int32), subs.size, upds.size, bs)
        args = (ep.owner.clamp(min=0), ep.is_upper.to(torch.int32),
                ep.is_sub.to(torch.int32), (ep.owner >= 0).to(torch.int32),
                tprefix.delta_scan_exclusive(add_s, del_s),
                tprefix.delta_scan_exclusive(add_u, del_u))
        assert args[4].shape == (nb, ws) and args[5].shape == (nb, wu)
        before = tkernels.emit_pairs.launches
        out_i, out_j = tkernels.emit_pairs(*args, block_size=bs, cap=4096)
        assert tkernels.emit_pairs.launches == before
        keep = out_i.flatten() >= 0
        outs.append(torch.stack([out_i.flatten()[keep],
                                 out_j.flatten()[keep]], 1))
    assert outs[0].shape[0] > 0 and torch.equal(outs[0], outs[1])


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok": true' not in proc.stdout


@pytest.mark.cuda
def test_delta_bitmask_kernel_matches_plain_on_any_records():
    """The delta-bitmask kernel against its plain version on the card,
    exactly: every block size up to the kernel's limit on well-formed
    streams, the off-contract kinds and random records (negative owners,
    owners >= 32·W); owners wide enough that a 32-bit (owner, position)
    key would overflow; rows surrounded by canaries that must survive;
    the refusal above the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from repro_torch.core.sweep import _pad_stream, encode_endpoints
    from repro_torch.kernels import _build

    limit = tkernels.BITMASK_MAX_BLOCK
    g = torch.Generator().manual_seed(1)
    subs, upds = intervals.make_uniform_workload(3000, 2500, 20.0,
                                                 generator=g)
    rng = np.random.default_rng(11)

    def check(owner, up, valid, num_words, bs):
        before = tkernels.delta_bitmasks.launches
        got = tkernels.delta_bitmasks(owner, up, valid, num_words=num_words,
                                      block_size=bs)
        assert tkernels.delta_bitmasks.launches == before + 1
        want = tref.ref_delta_bitmasks(owner, up, valid, num_words=num_words,
                                       block_size=bs)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    def random_records(total, num_words, low=-5, extra=40):
        cols = (rng.integers(low, 32 * num_words + extra, total),
                rng.integers(0, 2, total), rng.integers(0, 2, total))
        return [torch.from_numpy(c.astype(np.int32)).cuda() for c in cols]

    for bs in (32, 256, 2048, 4096, limit):
        ep = _pad_stream(encode_endpoints(subs, upds), bs)
        up = ep.is_upper.to(torch.int32)
        valid = (ep.is_sub & (ep.owner >= 0)).to(torch.int32)
        check(ep.owner, up, valid, 94, bs)
        for kind in tref.OFF_CONTRACT_KINDS:
            check(*tref.off_contract_records(kind, ep.owner, up, valid,
                                             block_size=bs), 94, bs)
        check(*random_records(2 * bs, 3), 3, bs)
    # owners up to 2^21 at block 4096: (owner << 12 | position) needs 33
    # bits; up to 2^24 (a fourth radix pass)
    check(*random_records(3 * 4096, 1 << 16, low=0, extra=0), 1 << 16, 4096)
    check(*random_records(2 * 256, 1 << 19, low=0, extra=0), 1 << 19, 256)
    # owners >= 32·W write nothing outside the block's rows: canaries
    bs, num_words, pad = 256, 2, 64
    owner, up, valid = random_records(4 * bs, num_words, extra=200)
    canary = int(np.uint32(0xA5A5A5A5).view(np.int32))
    bufs = [torch.full((2 * pad + 4 * num_words,), canary, dtype=torch.int32,
                       device="cuda") for _ in range(2)]
    rc = _build.library().sbm_delta_bitmasks(
        owner.data_ptr(), up.data_ptr(), valid.data_ptr(),
        bufs[0][pad:].data_ptr(), bufs[1][pad:].data_ptr(), 4 * bs, bs,
        num_words, _build.stream_handle(owner.device))
    _build.check(rc, "sbm_delta_bitmasks")
    want = tref.ref_delta_bitmasks(owner, up, valid, num_words=num_words,
                                   block_size=bs)
    for buf, w in zip(bufs, want):
        assert torch.equal(buf[pad:-pad].view(4, num_words), w)
        assert bool((buf[:pad] == canary).all())
        assert bool((buf[-pad:] == canary).all())
    over = torch.zeros(limit + 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValidationError, match=str(limit)):
        tkernels.delta_bitmasks(over, over, over, num_words=1,
                                block_size=limit + 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_float32_flash_kernel_matches_plain_at_every_width():
    """The float32 register-tile kernel against ``ref_flash_attention``
    within 2e-5 (FLASH_TOL of chip_smoke), one launch a call: D = 1 to 593
    (16-byte copies where D % 4 == 0, element copies otherwise, two blocks
    of O columns above 512) at schedule units of 32 (a 64-row q tile
    overhanging its block) and 512 (eight tiles a block), causal; every
    feature (GQA 3:1, window, softcap, segments, q_offset, a global block)
    at D = 63 and 200; q one element off 16-byte alignment at D = 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    gen = torch.Generator().manual_seed(21)

    def check(b, h, hkv, sq, skv, d, blk, shift=0, window=None,
              softcap=None, segments=False, num_global_blocks=0):
        qf = torch.randn((b, h, sq, d), generator=gen) / d ** 0.25
        buf = torch.empty(qf.numel() + shift, device="cuda")
        q = buf[shift:].view(qf.shape)
        q.copy_(qf)
        k = (torch.randn((b, hkv, skv, d), generator=gen) / d ** 0.25).cuda()
        v = torch.randn((b, hkv, skv, d), generator=gen).cuda()
        seg = qseg = None
        if segments:
            seg = torch.sort(torch.randint(0, 3, (b, skv), generator=gen),
                             dim=1).values.to(torch.int32).cuda()
            qseg = seg[:, skv - sq:].contiguous()
        idx, cnt, _ = tops.build_block_structure(
            sq, skv, block_q=blk, block_k=blk, window=window,
            num_global_blocks=num_global_blocks)
        args = (q, k, v, torch.from_numpy(idx), torch.from_numpy(cnt), qseg,
                seg)
        kw = dict(scale=d ** -0.5, causal=True, window=window,
                  softcap=softcap, block_q=blk, block_k=blk,
                  q_offset=skv - sq)
        before = flash_attention_kernel.launches
        got = flash_attention_kernel(*args, **kw)
        assert flash_attention_kernel.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == q.shape
        want = tref.ref_flash_attention(*args, **kw)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)

    for d in (1, 16, 63, 64, 96, 128, 200, 256, 257, 512, 593):
        check(1, 2, 1, 96, 160, d, 32)
        check(1, 2, 2, 512, 1024, d, 512)
    for d in (63, 200):
        check(2, 6, 2, 96, 192, d, 32, window=40, softcap=30.0,
              segments=True, num_global_blocks=1)
        check(1, 3, 1, 512, 1536, d, 512, window=700, softcap=50.0)
    check(1, 2, 2, 128, 128, 64, 32, shift=1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pass_c_kernel_refuses_segments_above_its_shared_memory():
    """Pass C's limit, pinned beside the delta-bitmask kernel's: at
    ``emit_pairs_max_block`` records a segment it launches and equals its
    plain version; one record more and the wrapper raises
    :class:`ValidationError` naming the limit, launching nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    ws = wu = 4
    most = tkernels.emit_pairs_max_block(ws, wu)
    assert 9000 < most < tkernels.BITMASK_MAX_BLOCK
    rng = np.random.default_rng(9)
    for bs in (most, most + 1):
        total = 2 * bs
        owner = torch.from_numpy(rng.integers(0, 32 * ws, total)
                                 .astype(np.int32)).cuda()
        up, sub = (torch.from_numpy(rng.integers(0, 2, total)
                                    .astype(np.int32)).cuda()
                   for _ in range(2))
        valid = torch.from_numpy((rng.random(total) < 0.01)
                                 .astype(np.int32)).cuda()
        act = torch.zeros((2, ws), dtype=torch.int32, device="cuda")
        args = (owner, up, sub, valid, act, act)
        before = tkernels.emit_pairs.launches
        if bs > most:
            with pytest.raises(ValidationError, match=str(most)):
                tkernels.emit_pairs(*args, block_size=bs, cap=64)
            assert tkernels.emit_pairs.launches == before
            continue
        got = tkernels.emit_pairs(*args, block_size=bs, cap=64)
        assert tkernels.emit_pairs.launches == before + 1
        want = tref.ref_emit_pairs(*args, block_size=bs, cap=64)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_enumerate_kernel_answers_at_any_segment_size():
    """``ops.sbm_enumerate_kernel`` on the card at block sizes 4096, 16385
    and 32768 (above the delta-bitmask kernel's and pass C's limits, so run
    at ``card_segment``'s size): the same pairs in the same order and the
    same count, equal to the plain versions' at 32768 and, as a set, to the
    rank-table engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from repro_torch.core import enumerate as tenum
    from repro_torch.core.runtime import pair_set

    g = torch.Generator().manual_seed(5)
    subs, upds = intervals.make_uniform_workload(20_000, 20_000, 1.0,
                                                 generator=g, device="cuda")
    n, m = subs.size, upds.size
    limit = min(tkernels.BITMASK_MAX_BLOCK,
                tkernels.emit_pairs_max_block(tops._num_words(n),
                                              tops._num_words(m)))
    seg = tops.card_segment(32768, n, m)
    assert tops.card_segment(4096, n, m) == 4096
    assert seg == tops.card_segment(16385, n, m)
    assert seg <= limit < seg + 4 and seg % 4 == 0
    k = int(tops.sbm_count_kernel(subs, upds))
    outs = [tops.sbm_enumerate_kernel(subs, upds, max_pairs=k, block_size=bs)
            for bs in (4096, 16385, 32768)]
    for pairs, count in outs:
        assert int(count) == k and torch.equal(pairs, outs[0][0])
    cpu = [intervals.Extents(e.lo.cpu(), e.hi.cpu()) for e in (subs, upds)]
    plain, count = tops.sbm_enumerate_kernel(*cpu, max_pairs=k,
                                             block_size=32768)
    assert int(count) == k and torch.equal(plain, outs[0][0].cpu())
    want, _ = tenum.sbm_enumerate(subs, upds, max_pairs=k)
    assert pair_set(outs[0][0]) == pair_set(want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_pass_b_kernel_matches_plain_at_every_block_size():
    """Pass B against ``ref_emission``, exactly: block sizes 4 and 36
    (shorter than a warp's span), 2048 and 4096 (the main path's), 8192
    (two tiles of 4096), 5 and 37 (not a multiple of 4: the scalar path),
    each with 16-byte aligned rows (the int4 path where the size allows
    it) and with every row one int32 off alignment (the scalar path); one
    launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    rng = np.random.default_rng(3)
    for bs in (4, 5, 36, 37, 2048, 4096, 8192):
        nb = max(3, 30000 // bs)
        total = nb * bs
        d = torch.from_numpy(rng.integers(-2, 3, (4, total))
                             .astype(np.int32)).cuda()
        for shift in (0, 1):
            buf = torch.empty(4 * total + shift, dtype=torch.int32,
                              device="cuda")
            deltas = buf[shift:].view(4, total)
            deltas.copy_(d)
            assert (deltas.data_ptr() % 16 == 0) == (shift == 0)
            sums = tkernels.block_sums(deltas, block_size=bs)
            offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
            before = tkernels.emission.launches
            got = tkernels.emission(deltas, offsets, block_size=bs)
            assert tkernels.emission.launches == before + 1
            want = tref.ref_emission(deltas, offsets, block_size=bs)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Each CUDA kernel against its plain version on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from repro_torch.core import prefix
    from repro_torch.core.sweep import (_indicator_deltas, _pad_stream,
                                        encode_endpoints)

    g = torch.Generator().manual_seed(0)
    subs, upds = intervals.make_uniform_workload(3000, 2500, 20.0,
                                                 generator=g)
    for bs in (256, 2048):
        ep = _pad_stream(encode_endpoints(subs, upds), bs)
        deltas = torch.stack(_indicator_deltas(ep))
        sums = tkernels.block_sums(deltas, block_size=bs)
        assert torch.equal(sums, tref.ref_block_sums(deltas, block_size=bs))
        offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums
        for g_, w in zip(tkernels.emission(deltas, offsets, block_size=bs),
                         tref.ref_emission(deltas, offsets, block_size=bs)):
            assert torch.equal(g_, w)
        up = ep.is_upper.to(torch.int32)
        real = ep.owner >= 0
        masks = []
        for valid, count in (((ep.is_sub & real), 3000),
                             ((~ep.is_sub & real), 2500)):
            args = (ep.owner, up, valid.to(torch.int32))
            got = tkernels.delta_bitmasks(*args, num_words=-(-count // 32),
                                          block_size=bs)
            want = tref.ref_delta_bitmasks(*args, num_words=-(-count // 32),
                                           block_size=bs)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            masks.append(prefix.delta_scan_exclusive(*got))
        _, seg, _ = tkernels.sweep_count(deltas, block_size=bs)
        cap = max(int(seg.max()), 1)
        c_args = (ep.owner.clamp(min=0), up, ep.is_sub.to(torch.int32),
                  real.to(torch.int32), *masks)
        for c in (cap, max(cap // 2, 1)):        # and a cap that cuts
            got = tkernels.emit_pairs(*c_args, block_size=bs, cap=c)
            want = tref.ref_emit_pairs(*c_args, block_size=bs, cap=c)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert int(tkernels.emit_pairs.general_blocks) == 0
        # outside the contract of its fast path pass C equals the replay
        # too: segment 0's first subscription lower finds its bit set; a
        # second lower of it; a dropped lower whose upper then finds its
        # bit clear; stray bits in every entering set; a cap that cuts those
        first = int(torch.nonzero(ep.is_sub[:bs] & real[:bs])[0])
        o = int(ep.owner[first])
        bad = masks[0].clone()
        bad[0, o // 32] ^= int(np.uint32(1 << (o % 32)).view(np.int32))
        twice = [x.clone() for x in c_args[:4]]
        for x, val in zip(twice, (o, 0, 1, 1)):
            x[first + 1] = val
        live = (ep.is_sub[:bs] & real[:bs]).cpu().numpy()
        owners, ups = ep.owner[:bs].cpu().numpy(), up[:bs].cpu().numpy()
        closed = np.isin(owners, owners[live & (ups == 1)])
        dropped = real.to(torch.int32).clone()
        dropped[int(np.flatnonzero(live & (ups == 0) & closed)[0])] = 0
        rng = np.random.default_rng(bs)
        stray = []
        for m in masks:                 # 16 stray members per entering set
            ids = rng.integers(0, 32 * m.shape[1], (m.shape[0], 16))
            bits = np.zeros(tuple(m.shape), np.uint32)
            np.bitwise_or.at(bits, (np.arange(m.shape[0])[:, None], ids // 32),
                             np.uint32(1) << (ids % 32).astype(np.uint32))
            stray.append(m | torch.from_numpy(bits.view(np.int32)).cuda())
        for args, c in (((*c_args[:4], bad, masks[1]), cap),
                        ((*twice, *masks), cap),
                        ((*c_args[:3], dropped, *masks), cap),
                        ((*c_args[:4], *stray), cap),
                        ((*c_args[:4], *stray), max(cap // 3, 1))):
            got = tkernels.emit_pairs(*args, block_size=bs, cap=c)
            want = tref.ref_emit_pairs(*args, block_size=bs, cap=c)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert int(tkernels.emit_pairs.general_blocks) > 0
    # the bit-matrix AND, d = 1..4 and the run-time d of 5 and 8, ragged
    # rows and words; blocks of several update chunks (n = 1500, m = 8192)
    for d, n, m in ((1, 33, 40), (2, 37, 130), (3, 300, 257), (4, 65, 1000),
                    (5, 70, 300), (8, 40, 65), (2, 1500, 8192),
                    (5, 1500, 8192)):
        g = torch.Generator().manual_seed(d)
        subs, upds = intervals.make_uniform_workload(n, m, 50.0, d=d,
                                                     generator=g)
        rows = [x if x.ndim == 2 else x[None] for x in
                (subs.lo, subs.hi, upds.lo, upds.hi)]
        got = tbitmatch.bitmatch(*(x.contiguous() for x in rows))
        want = tref.ref_bitmatrix(*(x.contiguous() for x in rows))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # edge shapes: m = 1, 31, 33, 1025 against the row tiles, d = 1, 4, 5,
    # integer-grid ties with -0.0 and +-inf bounds
    rng = np.random.default_rng(7)
    for d, n, m in ((1, 1030, 1), (4, 1030, 31), (5, 515, 33),
                    (1, 7, 1025), (4, 513, 1025), (5, 1030, 1025)):
        arrs = []
        for size in (n, m):
            lo = rng.integers(-4, 5, (d, size)).astype(np.float32)
            hi = lo + rng.integers(0, 4, (d, size)).astype(np.float32)
            lo[(lo == 0) & (rng.random(lo.shape) < 0.5)] = np.float32(-0.0)
            lo[rng.random(lo.shape) < 0.1] = -np.inf
            hi[rng.random(hi.shape) < 0.1] = np.inf
            arrs += [lo, hi]
        rows = [torch.from_numpy(a).cuda() for a in arrs]
        got = tbitmatch.bitmatch(*rows)
        want = tref.ref_bitmatrix(*rows)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # block-sparse flash attention, f32 and bf16: GQA, window, softcap,
    # segments, q_offset, a ragged 32-block schedule, D = 64, 128 and 256
    gen = torch.Generator().manual_seed(5)
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for h, hkv, sq, skv, d, blk, window, softcap, segs in (
                (8, 2, 256, 256, 128, 64, None, None, False),
                (5, 1, 128, 256, 64, 64, 100, 30.0, False),
                (4, 2, 96, 96, 64, 32, 40, None, True),
                (4, 2, 128, 192, 256, 64, None, 50.0, False),
                (4, 2, 96, 96, 256, 32, 40, 50.0, True)):
            q = torch.randn((2, h, sq, d), generator=gen).cuda().to(dt)
            k = torch.randn((2, hkv, skv, d), generator=gen).cuda().to(dt)
            v = torch.randn((2, hkv, skv, d), generator=gen).cuda().to(dt)
            seg = torch.sort(torch.randint(0, 3, (2, skv), generator=gen),
                             dim=1).values.to(torch.int32).cuda() \
                if segs else None
            qseg = None if seg is None else seg[:, skv - sq:].contiguous()
            idx, cnt, _ = tops.build_block_structure(
                sq, skv, block_q=blk, block_k=blk, window=window)
            args = (q, k, v, torch.from_numpy(idx), torch.from_numpy(cnt),
                    qseg, seg)
            kw = dict(scale=d ** -0.5, causal=True, window=window,
                      softcap=softcap, block_q=blk, block_k=blk,
                      q_offset=skv - sq)
            before = flash_attention_kernel.launches
            got = flash_attention_kernel(*args, **kw)
            assert flash_attention_kernel.launches == before + 1
            want = tref.ref_flash_attention(*args, **kw)
            assert got.dtype == dt
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
    # D = 96 runs zero-padded to the D = 128 instance, one launch
    idx, cnt, _ = tops.build_block_structure(64, 64, block_q=32, block_k=32)
    idx, cnt = torch.from_numpy(idx), torch.from_numpy(cnt)
    q, k, v = (torch.randn((1, 2, 64, 96), generator=gen).cuda()
               for _ in range(3))
    kw = dict(scale=96 ** -0.5, causal=True, window=None, softcap=None,
              block_q=32, block_k=32, q_offset=0)
    before = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, idx, cnt, **kw)
    assert flash_attention_kernel.launches == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got, tref.ref_flash_attention(q, k, v, idx, cnt,
                                                             **kw),
                               rtol=2e-5, atol=2e-5)
    # D = 257 to 593: float32 on the scalar run-time-width kernel, bf16 on
    # the wide tensor-core kernel (scores of std 4, held also to the bound
    # of chip_smoke.flash_full_tol), one launch each (window, softcap,
    # segments, GQA, q_offset); 257 and 593 stage rows by element loads,
    # and so does 320 with q one element off 16-byte alignment
    seg = torch.sort(torch.randint(0, 3, (1, 96), generator=gen),
                     dim=1).values.to(torch.int32).cuda()
    idx, cnt, _ = tops.build_block_structure(64, 96, block_q=32, block_k=32,
                                             window=40)
    idx, cnt = torch.from_numpy(idx), torch.from_numpy(cnt)
    for dt, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for d, shift in ((257, 0), (320, 0), (320, 1), (384, 0), (512, 0),
                         (593, 0)):
            gain = 4.0 if dt == torch.bfloat16 else 1.0
            qf = torch.randn((1, 4, 64, d), generator=gen) * gain
            buf = torch.empty(qf.numel() + shift, device="cuda", dtype=dt)
            q = buf[shift:].view(qf.shape)
            q.copy_(qf)
            k, v = (torch.randn((1, 2, 96, d), generator=gen).cuda().to(dt)
                    for _ in range(2))
            args = (q, k, v, idx, cnt, seg[:, 32:].contiguous(), seg)
            kw = dict(scale=d ** -0.5, causal=True, window=40, softcap=30.0,
                      block_q=32, block_k=32, q_offset=32)
            before = flash_attention_kernel.launches
            got = flash_attention_kernel(*args, **kw)
            assert flash_attention_kernel.launches == before + 1
            assert got.dtype == dt and got.shape == q.shape
            want = tref.ref_flash_attention(*args, **kw).float()
            torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
            if dt == torch.bfloat16:
                # |p~ - p| <= 2^-9 p moves out by 2^-9 max|v|, then both
                # sides round to bf16 (chip_smoke.flash_full_tol)
                delta = 2.0 ** -9 * float(v.float().abs().max())
                bound = (1 + 2.0 ** -8) * delta + 1e-4 \
                    + 2.0 ** -7 / (1 - 2.0 ** -8) * want.abs()
                assert bool(((got.float() - want).abs() <= bound).all())
    idx, cnt, _ = tops.build_block_structure(64, 64, block_q=32, block_k=32)
    idx, cnt = torch.from_numpy(idx), torch.from_numpy(cnt)
    q594 = torch.zeros((1, 2, 64, 594), device="cuda")
    with pytest.raises(ValidationError):        # above the run-time limit
        flash_attention_kernel(q594, q594, q594, idx, cnt, block_q=32,
                               block_k=32)
    q64 = torch.zeros((1, 2, 64, 64), device="cuda")
    with pytest.raises(ValidationError):            # schedule on the card
        flash_attention_kernel(q64, q64, q64, idx.cuda(), cnt.cuda(),
                               block_q=32, block_k=32)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_function_on_the_card():
    """On the card: ``ops.flash_attention`` with grad required launches the
    kernel once (bf16 instance, padded and float32 routes), its output is
    the kernel's, and dq, dk, dv equal autograd through the twin on the
    card within float32 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    from repro_torch.kernels.flash_vjp import blockwise_attention_twin

    for dtype, d in ((torch.bfloat16, 64), (torch.bfloat16, 96),
                     (torch.float32, 64)):
        rng = np.random.default_rng(0)
        q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                       ((2, 6, 1024, d), (2, 2, 1024, d), (2, 2, 1024, d),
                        (2, 6, 1024, d)))
        segs = np.sort(rng.integers(0, 3, (2, 1024)), axis=1).astype(np.int32)
        tq, tk, tv = (torch.from_numpy(a).cuda().to(dtype).requires_grad_()
                      for a in (q, k, v))
        tseg = torch.from_numpy(segs).cuda()
        before = flash_attention_kernel.launches
        out = tops.flash_attention(tq, tk, tv, scale=d ** -0.5, block_q=512,
                                   block_k=512, q_segments=tseg,
                                   kv_segments=tseg)
        assert flash_attention_kernel.launches == before + 1
        with torch.no_grad():
            kernel = tops.flash_attention(tq, tk, tv, scale=d ** -0.5,
                                          block_q=512, block_k=512,
                                          q_segments=tseg, kv_segments=tseg)
        assert torch.equal(out.detach(), kernel)
        dout = torch.from_numpy(do).cuda().to(dtype)
        grads = torch.autograd.grad(out, (tq, tk, tv), dout)
        index, count = tops._host_schedule(1024, 1024, 512, 512, True,
                                           None, 0)
        twin = blockwise_attention_twin(
            tq, tk, tv, index, count, tseg, tseg, scale=d ** -0.5,
            causal=True, window=None, softcap=None, block_q=512,
            block_k=512)
        want = torch.autograd.grad(twin, (tq, tk, tv), dout.float())
        for got, w in zip(grads, want):
            assert got.dtype == dtype
            err = float((got.float() - w.float()).abs().max()
                        / w.float().abs().max())
            assert err <= (1e-2 if dtype == torch.bfloat16 else 1e-5), err
