"""The port's attention kernels' plain path against the JAX package.

Inputs are made once with numpy from a seed and handed to both packages:
``build_block_structure`` must give the same arrays; the port's
``ref_flash_attention`` (the plain version of the CUDA flash kernel, which
the wrapper runs on CPU tensors) must agree with the Pallas kernel in
interpret mode and with the JAX model's ``blockwise_attention`` (float32,
within 2e-5, the bound of ``tests/test_kernels_attention.py``); the port's
``ref_attention`` must agree with the JAX dense oracle.  The feature grid is
the one ``chip_smoke.py`` runs on the card: GQA, MQA, windows, softcap,
segments, ``q_offset > 0``, global blocks, D = 64, 128 and 256, causal and
not (non-causal at Sq == Skv, as an encoder's self-attention, and at
Sq != Skv either way, as cross-attention).  The model's
``attention_layer`` (dense and blockwise, global blocks, cross-attention
through ``kv_override``) is held against the JAX layer.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import ref_attention as jax_ref_attention
from repro.models.attention import attention_layer as jax_attention_layer
from repro.models.attention import blockwise_attention as jax_blockwise
from repro.models.attention import make_cross_kv as jax_make_cross_kv
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.errors import ValidationError
from repro_torch.kernels.flash_attention import (RT_MAX_HEAD_DIM,
                                                 _pad_head_dim,
                                                 flash_attention_kernel,
                                                 flash_route)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import (attention_layer,
                                          blockwise_attention, make_cross_kv)

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, B, H, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, Sq, D)) / D ** 0.25).astype(np.float32)
    k = (rng.standard_normal((B, Hkv, Skv, D)) / D ** 0.25).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    return q, k, v


def _segments(seed, B, S):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)


# (B, H, Hkv, Sq, Skv, D, block, features)
CASES = {
    "mha": (1, 2, 2, 256, 256, 64, 64, {}),
    "gqa2": (2, 4, 2, 128, 128, 64, 64, {}),
    "gqa4_d128": (1, 8, 2, 256, 256, 128, 64, {}),
    "mqa5": (1, 5, 1, 128, 128, 64, 64, {}),
    "window64": (1, 2, 2, 256, 256, 64, 64, {"window": 64}),
    "window100": (1, 2, 2, 256, 256, 64, 64, {"window": 100}),
    "window128": (1, 2, 2, 256, 256, 64, 64, {"window": 128}),
    "softcap": (1, 2, 2, 128, 128, 64, 64, {"softcap": 30.0}),
    "segments": (2, 2, 2, 256, 256, 64, 64, {"segments": True}),
    "q_offset": (1, 2, 2, 128, 512, 64, 64, {}),
    "global": (1, 2, 2, 256, 256, 64, 64,
               {"window": 64, "num_global_blocks": 1}),
    "block32_all": (1, 4, 2, 128, 128, 16, 32,
                    {"window": 40, "softcap": 30.0, "segments": True}),
    # gemma2-2b's head width
    "d256": (1, 4, 2, 128, 128, 256, 64, {}),
    "d256_all": (2, 4, 2, 128, 128, 256, 32,
                 {"window": 40, "softcap": 50.0, "segments": True}),
    # non-causal: an encoder's self-attention (Sq == Skv, with GQA,
    # segments and softcap), cross-attention (Sq < Skv, and queries longer
    # than the keys), a window with a global block
    "bidir": (1, 2, 2, 256, 256, 64, 64, {"causal": False}),
    "bidir_gqa_seg": (2, 4, 2, 128, 128, 64, 32,
                      {"causal": False, "segments": True, "softcap": 30.0}),
    "cross_kv_longer": (1, 4, 2, 128, 256, 64, 64, {"causal": False}),
    "cross_q_longer": (1, 2, 2, 256, 128, 64, 64, {"causal": False}),
    "bidir_global": (1, 2, 2, 256, 256, 64, 64,
                     {"causal": False, "window": 64,
                      "num_global_blocks": 1}),
}


def _case(name):
    B, H, Hkv, Sq, Skv, D, blk, feats = CASES[name]
    q, k, v = _qkv(len(name), B, H, Hkv, Sq, Skv, D)
    seg = _segments(7, B, Skv) if feats.get("segments") else None
    kw = dict(causal=feats.get("causal", True), window=feats.get("window"),
              softcap=feats.get("softcap"),
              num_global_blocks=feats.get("num_global_blocks", 0),
              block_q=blk, block_k=blk)
    return (q, k, v), seg, kw


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("S,block,causal,window,globals_", [
    (s, b, c, w, g) for s, b, c, w, g in itertools.product(
        (128, 512), (32, 64), (True, False), (None, 40, 64, 130), (0, 1))])
def test_block_structure_equals_jax(S, block, causal, window, globals_):
    for sq in (S, S // 2):            # self-attention and q right-aligned
        got = tops.build_block_structure(
            sq, S, block_q=block, block_k=block, causal=causal,
            window=window, num_global_blocks=globals_)
        want = jops.build_block_structure(
            sq, S, block_q=block, block_k=block, causal=causal,
            window=window, num_global_blocks=globals_)
        for g_, w_ in zip(got, want):
            assert g_.dtype == w_.dtype
            np.testing.assert_array_equal(g_, w_)


def test_block_structure_extra_mask_equals_jax():
    extra = np.zeros((4, 4), bool)
    extra[0, 3] = extra[2, 3] = True
    got = tops.build_block_structure(256, 256, block_q=64, block_k=64,
                                     window=64, extra_block_mask=extra)
    want = jops.build_block_structure(256, 256, block_q=64, block_k=64,
                                      window=64, extra_block_mask=extra)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_, w_)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_flash_equals_pallas_interpret(name):
    (q, k, v), seg, kw = _case(name)
    sq = q.shape[2]
    qseg = None if seg is None else seg[:, -sq:]
    want = jops.flash_attention(_j(q), _j(k), _j(v), q_segments=_j(qseg),
                                kv_segments=_j(seg), interpret=True, **kw)
    got = tops.flash_attention(_t(q), _t(k), _t(v), q_segments=_t(qseg),
                               kv_segments=_t(seg), **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["mha", "gqa2", "gqa4_d128", "mqa5",
                                  "window100", "softcap", "segments",
                                  "global", "block32_all", "d256", "d256_all",
                                  "bidir", "bidir_gqa_seg", "cross_kv_longer",
                                  "cross_q_longer", "bidir_global"])
def test_blockwise_attention_equals_jax(name):
    """The model's blockwise path against the JAX one.  The JAX path masks
    tokens with q at position 0 where its schedule right-aligns q; they
    agree where neither causality nor a window plays a part at Sq != Skv,
    which is where the model calls it (cross-attention)."""
    (q, k, v), seg, kw = _case(name)
    d = q.shape[-1]
    args = dict(scale=d ** -0.5, causal=kw["causal"], window=kw["window"],
                softcap=kw["softcap"], block_q=kw["block_q"],
                block_k=kw["block_k"],
                num_global_blocks=kw["num_global_blocks"])
    want = jax_blockwise(_j(q), _j(k), _j(v), q_segments=_j(seg),
                         kv_segments=_j(seg), **args)
    got = blockwise_attention(_t(q), _t(k), _t(v), q_segments=_t(seg),
                              kv_segments=_t(seg), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_attention_equals_jax_ref(name):
    (q, k, v), seg, kw = _case(name)
    sq = q.shape[2]
    qseg = None if seg is None else seg[:, -sq:]
    args = dict(causal=kw["causal"], window=kw["window"],
                softcap=kw["softcap"])
    want = jax_ref_attention(_j(q), _j(k), _j(v), q_segments=_j(qseg),
                             kv_segments=_j(seg), **args)
    got = tref.ref_attention(_t(q), _t(k), _t(v), q_segments=_t(qseg),
                             kv_segments=_t(seg), **args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ref_attention_block_mask_equals_jax_ref():
    q, k, v = _qkv(3, 1, 2, 2, 128, 128, 16)
    _, _, bm = tops.build_block_structure(128, 128, block_q=32, block_k=32,
                                          window=40)
    want = jax_ref_attention(_j(q), _j(k), _j(v), block_mask=jnp.asarray(bm),
                             block_q=32, block_k=32)
    got = tref.ref_attention(_t(q), _t(k), _t(v), block_mask=_t(bm),
                             block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_schedule_decides_the_answer():
    """A schedule that leaves out a block the token mask allows gives
    another answer than the dense oracle: the plain version follows the
    schedule, not the mask."""
    (q, k, v), _, _ = _case("mha")
    q, k, v = _t(q), _t(k), _t(v)
    idx, cnt, _ = tops.build_block_structure(256, 256, block_q=64,
                                             block_k=64)
    args = dict(scale=64 ** -0.5, causal=True, window=None, softcap=None,
                block_q=64, block_k=64, q_offset=0)
    full = tref.ref_flash_attention(q, k, v, idx, cnt, **args)
    np.testing.assert_allclose(full.numpy(),
                               tref.ref_attention(q, k, v).numpy(), **TOL)
    cut = cnt.copy()
    cut[3] -= 1                        # q block 3 loses its diagonal block
    part = tref.ref_flash_attention(q, k, v, idx, cut, **args)
    assert torch.equal(part[:, :, :192], full[:, :, :192])
    assert not torch.allclose(part[:, :, 192:], full[:, :, 192:])


@pytest.mark.parametrize("d", [16, 96])
def test_padded_head_dim_equals_unpadded_and_pallas(d):
    """What the wrapper launches on the card at a width it has no instance
    for: q, k, v zero-padded to the next built width, the scale fixed from
    the true width, the output cut back.  Replayed by the plain version
    here, it equals the unpadded replay and the Pallas kernel (interpret
    mode) at the true width."""
    B, H, Hkv, S, blk = 2, 4, 2, 128, 32
    q, k, v = _qkv(d, B, H, Hkv, S, S, d)
    seg = _segments(d + 1, B, S)
    feats = dict(causal=True, window=40, softcap=30.0)
    want = jops.flash_attention(_j(q), _j(k), _j(v), q_segments=_j(seg),
                                kv_segments=_j(seg), block_q=blk, block_k=blk,
                                interpret=True, **feats)
    idx, cnt, _ = tops.build_block_structure(S, S, block_q=blk, block_k=blk,
                                             window=40)
    sched = (torch.from_numpy(idx), torch.from_numpy(cnt), _t(seg), _t(seg))
    kw = dict(scale=d ** -0.5, block_q=blk, block_k=blk, q_offset=0, **feats)
    route, d_pad = flash_route(d, torch.bfloat16)
    assert (route, d_pad) == ("padded", 64 if d <= 64 else 128)
    pq, pk, pv = _pad_head_dim(_t(q), _t(k), _t(v), d_pad)
    assert pq.shape[-1] == pk.shape[-1] == pv.shape[-1] == d_pad
    assert torch.equal(pq[..., :d], _t(q)) and not pq[..., d:].any()
    got = tref.ref_flash_attention(pq, pk, pv, *sched, **kw)[..., :d]
    plain = tref.ref_flash_attention(_t(q), _t(k), _t(v), *sched, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # no instance above 256: wider heads run at their own width
    assert flash_route(320, torch.bfloat16) == ("wide", 320)


# (atol, rtol): float32 as above; bf16 outputs of two float32 computations
# rounded to bf16 may differ by one bf16 unit in the last place, 2^-6 at
# |out| < 4 (the repo's bf16 bound, tests/test_kernels_attention.py)
WIDE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [320, 512])
def test_plain_flash_equals_pallas_interpret_above_256(d, dtype):
    """Head widths that the card serves with the run-time-width kernels
    (bf16 the wide tensor-core kernel, float32 the scalar one): the plain
    version against the Pallas kernel in interpret mode, both fed
    the same (bf16-rounded, for bf16) inputs; causal, window, softcap."""
    B, H, S, blk = 1, 2, 128, 32
    q, k, v = _qkv(d, B, H, H, S, S, d)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    feats = dict(causal=True, window=40, softcap=30.0)
    want = jops.flash_attention(*(_j(x).astype(jdt) for x in (q, k, v)),
                                block_q=blk, block_k=blk, interpret=True,
                                **feats)
    got = tops.flash_attention(*(_t(x).to(tdt) for x in (q, k, v)),
                               block_q=blk, block_k=blk, **feats)
    assert got.dtype == tdt and got.shape == q.shape and want.dtype == jdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **WIDE_TOL[dtype])
    assert flash_route(d, tdt) == ("wide" if dtype == "bfloat16"
                                   else "runtime", d)


ROUTE_WIDTHS = [16, 64, 96, 128, 200, 256, 257, 320, 512, 593, 594, 1024]


@pytest.mark.parametrize("d,route", zip(ROUTE_WIDTHS, [
    "padded", "instance", "padded", "instance", "padded", "instance",
    "wide", "wide", "wide", "wide", None, None]))
def test_flash_route_by_head_width(d, route):
    """The wrapper's routing of bf16 on the card: an instance, zero-padding
    to the next instance, or the wide tensor-core kernel above 256 at the
    width itself, up to the largest width whose run-time-width tiles fit a
    block's shared memory, which the refusal names."""
    assert RT_MAX_HEAD_DIM == 593
    if route is None:
        with pytest.raises(ValidationError, match="up to 593"):
            flash_route(d, torch.bfloat16)
    else:
        width = (min(w for w in (64, 128, 256) if w >= d)
                 if route == "padded" else d)
        assert flash_route(d, torch.bfloat16) == (route, width)


@pytest.mark.parametrize("d", ROUTE_WIDTHS)
def test_flash_route_float32_runs_every_width_at_run_time(d):
    """float32 takes the run-time-width kernel at its own width, padded
    never, up to the same limit."""
    if d > RT_MAX_HEAD_DIM:
        with pytest.raises(ValidationError, match="up to 593"):
            flash_route(d, torch.float32)
    else:
        assert flash_route(d, torch.float32) == ("runtime", d)


def test_bf16_plain_flash_close_to_f32():
    (q, k, v), _, kw = _case("gqa2")
    kw.pop("num_global_blocks")
    got = tops.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                               **kw)
    want = tops.flash_attention(_t(q), _t(k), _t(v), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_wrapper_validates_and_counts_no_plain_run():
    q = torch.zeros((1, 2, 64, 256))
    k = torch.zeros((1, 2, 64, 256))
    idx, cnt, _ = tops.build_block_structure(64, 64, block_q=32, block_k=32)
    idx, cnt = torch.from_numpy(idx), torch.from_numpy(cnt)
    before = flash_attention_kernel.launches
    out = flash_attention_kernel(q, k, k, idx, cnt, block_q=32,
                                        block_k=32)
    assert out.shape == q.shape            # D = 256 is fine on the CPU
    assert flash_attention_kernel.launches == before
    with pytest.raises(ValidationError):   # ragged block
        flash_attention_kernel(q, k, k, idx, cnt, block_q=48,
                                      block_k=32)
    with pytest.raises(ValidationError):   # H not a multiple of Hkv
        flash_attention_kernel(torch.zeros((1, 3, 64, 256)), k, k, idx,
                                      cnt, block_q=32, block_k=32)
    with pytest.raises(ValidationError):   # int schedule of the wrong dtype
        flash_attention_kernel(q, k, k, idx.long(), cnt, block_q=32,
                                      block_k=32)
    with pytest.raises(ValidationError):   # float16 is not taken
        flash_attention_kernel(q.half(), k.half(), k.half(), idx, cnt,
                                      block_q=32, block_k=32)
    with pytest.raises(ValidationError):   # a KV block past Skv
        flash_attention_kernel(q, k, k, idx + 2, cnt, block_q=32, block_k=32)
    with pytest.raises(ValidationError):   # a count past max_nk
        flash_attention_kernel(q, k, k, idx, cnt + 2, block_q=32, block_k=32)
    with pytest.raises(ValidationError):   # one segment side only
        flash_attention_kernel(q, k, k, idx, cnt,
                                      torch.zeros((1, 64), dtype=torch.int32),
                                      block_q=32, block_k=32)
    with pytest.raises(ValidationError):   # no kernel for meta tensors
        flash_attention_kernel(q.to("meta"), k.to("meta"),
                                      k.to("meta"), idx.to("meta"),
                                      cnt.to("meta"), block_q=32, block_k=32)


@pytest.mark.parametrize("impl,causal,globals_,cross", [
    ("dense", True, 0, False), ("blockwise", True, 1, False),
    ("dense", False, 0, True), ("blockwise", False, 0, True),
    ("blockwise", False, 0, False)])
def test_attention_layer_equals_jax(impl, causal, globals_, cross,
                                    monkeypatch):
    """The whole sub-layer (projections, rope, core, output) at 64
    positions, past the 32-blocks of a reduced config: ``attn_impl``
    "dense" takes the dense path at every length (the flash call site is
    never reached), "blockwise" the flash call site, with
    ``num_global_blocks``; cross-attention takes K/V from a 96-position
    encoder output through ``make_cross_kv``."""
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(
        "smollm-360m")), attn_impl=impl)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m")),
                              attn_impl=impl)
    rng = np.random.default_rng(len(impl) + 2 * causal + globals_)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {name: (rng.standard_normal(shape) / np.sqrt(shape[0]))
              .astype(np.float32) for name, shape in (
                  ("wq", (d, h, hd)), ("wk", (d, kv, hd)),
                  ("wv", (d, kv, hd)), ("wo", (h, hd, d)))}
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    enc = rng.standard_normal((2, 96, d)).astype(np.float32)
    positions = np.broadcast_to(np.arange(64), (2, 64))
    jparams = {name: jnp.asarray(a) for name, a in params.items()}
    tparams = {name: torch.from_numpy(a) for name, a in params.items()}
    kw = dict(causal=causal, num_global_blocks=globals_)
    if cross:
        jkw = dict(kv_override=jax_make_cross_kv(jparams, jnp.asarray(enc),
                                                 jcfg, Sharder()))
        tkw = dict(kv_override=make_cross_kv(tparams, _t(enc), cfg))
        assert tkw["kv_override"][0].shape == (2, kv, 96, hd)
    else:
        jkw = dict(positions=jnp.asarray(positions))
        tkw = dict(positions=torch.from_numpy(positions.copy()))
    calls = []
    real = tref.ref_flash_attention
    monkeypatch.setattr(tref, "ref_flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want, _ = jax_attention_layer(jparams, jnp.asarray(x), jcfg, Sharder(),
                                  **kw, **jkw)
    got, cache = attention_layer(tparams, _t(x), cfg, **kw, **tkw)
    assert cache is None and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(calls) == (impl == "blockwise")
