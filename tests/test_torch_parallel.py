"""Model-side parallelism of the port (``repro_torch.parallel``, the
sharded ``Model``) against the JAX package on the CPU.

* **Spec tables** (in this process): for all 10 archs, every parameter
  and cache leaf's resolved spec on meshes 16 × 16, 2 × 16 × 16 and 2 × 4
  equals the JAX ``make_sharder(cfg, AbstractMesh(...)).spec(axes,
  shape)`` entry for entry; ``rules_for_config`` and ``select_moe_mode``
  agree; the MoE einsum path's activation specs of three MoE archs under
  the JAX layout sweep's variants, and the refusal of a spec that maps
  one mesh axis twice.
* **Quantization** (in this process): ``quantize_int8`` /
  ``dequantize_int8`` bit for bit.
* **Layers** (a gloo world of 8 CPU ranks, mesh data 2 × model 4,
  ``tests/_torch_parallel_worker.py``), against the JAX ``shard_map``
  bodies on an Auto mesh of 8 host devices (one subprocess, built like
  ``repro.launch.mesh.make_host_mesh``; a bare ``jax.make_mesh`` makes
  Explicit axes): the MoE modes ``ep`` / ``cap`` / ``ffn`` / ``gspmd`` and
  their gradients, the einsum path's cut of the expert work (experts,
  capacity slots or expert FFN over model: each rank's flops and
  collectives), the ``b % bs`` fall-back and the dispatch groups'
  shrink; ring and halo attention; ``compressed_psum``.
* **Models** (a gloo world of 4 ranks, mesh data 2 × model 2): reduced
  smollm-360m, granite-moe-3b-a800m (``ep``), gemma2-2b, mamba2-2.7b,
  seamless-m4t-medium and two head counts that the divisibility fallback
  cuts differently, against the JAX ``Model(cfg, Sharder())`` on one
  device in this process: ``forward``, ``prefill`` and 4 ``decode_step``s,
  ``loss`` and every gradient leaf.

The same numpy inputs, made from seeds, go to both packages.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding
from jax.sharding import PartitionSpec as JaxP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import Model as JaxModel
from repro.models import moe as jax_moe
from repro.models.api import ParamDef as JaxParamDef
from repro.models.transformer import model_defs as jax_model_defs
from repro.parallel import compression as jax_compression
from repro.parallel.sharding import make_sharder as jax_make_sharder
from repro.parallel.sharding import rules_for_config as jax_rules
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.errors import ValidationError
from repro_torch.models import Model
from repro_torch.models import moe
from repro_torch.models.api import iter_leaves
from repro_torch.models.transformer import model_defs
from repro_torch.parallel import compression
from repro_torch.parallel.sharding import (MeshShape, PartitionSpec, Sharder,
                                           make_sharder, rules_for_config)
from repro_torch.train.loop import value_and_grad
from _torch_model_parity import numpy_params
from _torch_parallel_worker import (CAPSHARD, DECODE_STEPS, EINSUM_CASES,
                                    FLOAT64_TWINS, MODEL_CASES, model_config,
                                    moe_base, run_world)

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
CACHE_ROWS, CACHE_LEN = 32, 4096
MOE_TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_moe_sharded.py
MOE_GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
# bf16 MoE modes against the JAX ones: bf16 units (2^-8) of the largest
# output (two bf16 evaluations differ by the roundings of their partial
# sums and products; 1.1-2.2 units measured)
MOE_BF16_ULPS = 4
CP_TOL = dict(rtol=2e-5, atol=2e-5)           # tests/test_context_parallel.py
# whole models: each output and gradient leaf within this share of its
# largest magnitude (float32: the all-reduces and the split products sum
# in another order than one device does)
MODEL_REL = 1e-5
# reduced mamba2-2.7b's gradients: the port on one device already lies
# 2.7e-5 of the largest |g| from the JAX package (its float32 SSD sums);
# there the sharded run is held to test_torch_train.py's GRAD_TOL of the
# JAX one, and its float64 twin to 1e-5 of the port's single-device run in
# float64 (the Mamba heads' split sums in another order than one device:
# in float32 the sharded gradients lie 1.3e-5 from one device's, which
# itself lies 2.2e-5 from float64, the sharded run 1.9e-5)
FLOAT32_SSD_GRAD_REL = 1e-4
ROWS, SEQ = 4, 64
CP_CASES = {"window 16": {"window": 16}, "window 33": {"window": 33},
            "window 64": {"window": 64}, "ring": {},
            "ring softcap 20": {"softcap": 20.0}}
COMP_N = 1000


# --------------------------------------------------------------------------
# Spec tables
# --------------------------------------------------------------------------

def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxParamDef))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): d
            for path, d in flat}


def _cache_leaves(model, init):
    """{path: (axes, shape)} of every cache leaf."""
    axes = model.cache_spec_axes()
    out = {}
    for name, spec in axes.items():
        for field, ax, arr in zip(spec._fields, spec, init[name]):
            out[f"{name}/{field}"] = (tuple(ax), tuple(arr.shape))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tables_equal_jax(arch, mesh):
    sizes, names = MESHES[mesh]
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    sharder = make_sharder(cfg, MeshShape(sizes, names))
    jsharder = jax_make_sharder(jcfg, AbstractMesh(sizes, names))
    mine = dict(iter_leaves(model_defs(cfg)))
    theirs = _jax_leaves(jax_model_defs(jcfg))
    assert mine.keys() == theirs.keys()
    for path, d in mine.items():
        jd = theirs[path]
        assert (d.shape, d.axes) == (jd.shape, jd.axes), path
        got = sharder.spec(d.axes, d.shape)
        assert isinstance(got, PartitionSpec)
        assert tuple(got) == tuple(jsharder.spec(jd.axes, jd.shape)), path
        assert tuple(sharder.spec(d.axes)) == tuple(jsharder.spec(jd.axes))
    jm = JaxModel(jcfg, jsharder)
    jcache = _cache_leaves(jm, jax.eval_shape(
        lambda: jm.init_cache(CACHE_ROWS, CACHE_LEN)))
    model = Model(cfg, device="meta")
    cache = _cache_leaves(model, model.init_cache(CACHE_ROWS, CACHE_LEN))
    assert cache.keys() == jcache.keys()
    for path, (axes, shape) in cache.items():
        assert (axes, shape) == jcache[path], path
        assert tuple(sharder.spec(axes, shape)) \
            == tuple(jsharder.spec(axes, shape)), path


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["none"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_moe_mode_equal_jax(arch, mesh):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    overrides = (("heads", None), ("vocab", ["data", "model"]))
    for c, jc in ((cfg, jcfg),
                  (dataclasses.replace(cfg, sharding_overrides=overrides),
                   dataclasses.replace(jcfg, sharding_overrides=overrides))):
        if mesh == "none":
            assert rules_for_config(c, None) == jax_rules(jc, None)
            continue
        sizes, names = MESHES[mesh]
        assert rules_for_config(c, MeshShape(sizes, names)) \
            == jax_rules(jc, AbstractMesh(sizes, names))
    if not cfg.num_experts:
        return
    for impl in moe.MODES:
        c = dataclasses.replace(cfg, moe_impl=impl)
        jc = dataclasses.replace(jcfg, moe_impl=impl)
        for cap in (8, 24, 512, 2560):
            if mesh == "none":
                assert moe.select_moe_mode(c, None, cap) \
                    == jax_moe.select_moe_mode(jc, None, cap)
                continue
            sizes, names = MESHES[mesh]
            assert moe.select_moe_mode(c, MeshShape(sizes, names), cap) \
                == jax_moe.select_moe_mode(jc, AbstractMesh(sizes, names),
                                           cap), (impl, cap)


# the MoE layer's variants in the JAX layout sweep (benchmarks/
# hillclimb.py): the rules as they are, the einsum path, the capacity
# slots over model (``v_capshard``, which maps model twice where the rules
# put the experts on it), and the einsum path with CAPSHARD
MOE_VARIANTS = {
    "baseline": {},
    "gspmd": {"moe_impl": "gspmd"},
    "capshard": {"sharding_overrides": (("expert_ffn", None),
                                        ("moe_cap", "model"))},
    "gspmd capshard": {"moe_impl": "gspmd", "sharding_overrides": CAPSHARD},
}
MOE_ARCHS = ("granite-moe-3b-a800m", "grok-1-314b", "jamba-1.5-large-398b")


def _moe_constraints(cfg, rows: int):
    """(axes, shape) of each tensor that the JAX einsum path constrains,
    for ``rows`` dispatch groups of CACHE_LEN tokens."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    cap = moe._capacity(CACHE_LEN, cfg)
    return [(("batch", "experts", "moe_cap", None), (rows, e, cap, d)),
            (("batch", "experts", "moe_cap", "expert_ffn"),
             (rows, e, cap, f)),
            (moe.WORK_AXES, (rows, e, cap, f)),
            (("batch", None, None), (rows, CACHE_LEN, d))]


@pytest.mark.parametrize("variant", sorted(MOE_VARIANTS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_constraint_specs_equal_jax(arch, mesh, variant):
    """The MoE activations' specs and block shapes equal the JAX
    ``make_sharder(cfg, AbstractMesh).spec`` and ``NamedSharding``'s shard
    shape; a spec that JAX refuses (one mesh axis on two dimensions)
    raises :class:`ValidationError` in the port's ``named``,
    ``constrain`` and ``cut``."""
    sizes, names = MESHES[mesh]
    fields = MOE_VARIANTS[variant]
    cfg = dataclasses.replace(get_config(arch), **fields)
    jcfg = dataclasses.replace(jax_get_config(arch), **fields)
    sharder = make_sharder(cfg, MeshShape(sizes, names))
    jmesh = AbstractMesh(sizes, names)
    jsharder = jax_make_sharder(jcfg, jmesh)
    refused = 0
    for rows in (CACHE_ROWS, 1):
        for axes, shape in _moe_constraints(cfg, rows):
            spec = sharder.spec(axes, shape)
            assert tuple(spec) == tuple(jsharder.spec(axes, shape)), axes
            try:
                jnamed = jsharder.named(axes, shape)
            except Exception as exc:     # not a ValueError in JAX
                assert type(exc).__name__ == "DuplicateSpecError", exc
                for call in (lambda: sharder.named(axes, shape),
                             lambda: sharder.constrain(
                                 torch.empty(shape, device="meta"), axes),
                             lambda: sharder.cut(axes, shape)):
                    with pytest.raises(ValidationError, match="more than one"):
                        call()
                refused += 1
                continue
            assert sharder.named(axes, shape).spec == spec
            assert sharder.block_shape(axes, shape) \
                == tuple(jnamed.shard_shape(shape)), axes
    # v_capshard maps model twice where the rules put the experts on it
    assert bool(refused) == (variant == "capshard"
                             and cfg.num_experts % sizes[-1] == 0)


def test_a_mesh_axis_mapped_twice_is_refused_as_in_jax():
    """``named`` / ``constrain`` of a spec that names one mesh axis on two
    dimensions: JAX's ``NamedSharding`` raises ``DuplicateSpecError``, the
    port :class:`ValidationError`; the same axes once each pass."""
    sizes, names = (2, 4), ("data", "model")
    rules = {"batch": "data", "experts": "model", "moe_cap": "model",
             "expert_ffn": None}
    sharder = Sharder(MeshShape(sizes, names), dict(rules))
    axes = ("batch", "experts", "moe_cap", "expert_ffn")
    shape = (4, 8, 16, 8)
    spec = sharder.spec(axes, shape)
    assert tuple(spec) == ("data", "model", "model", None)
    with pytest.raises(Exception, match="duplicate") as exc:
        JaxNamedSharding(AbstractMesh(sizes, names), JaxP(*spec))
    assert exc.type.__name__ == "DuplicateSpecError"
    with pytest.raises(ValidationError, match=r"\['model'\]"):
        sharder.named(axes, shape)
    with pytest.raises(ValidationError, match="more than one"):
        sharder.constrain(torch.zeros(shape), axes)
    with pytest.raises(ValidationError, match="more than one"):
        sharder.constrain(torch.zeros((4, 8)), ("experts", "moe_cap"))
    ok = Sharder(MeshShape(sizes, names), dict(rules, moe_cap=None))
    assert ok.named(axes, shape).spec == PartitionSpec("data", "model",
                                                       None, None)
    t = torch.zeros(shape)
    assert ok.constrain(t, axes) is t


def test_sharder_without_a_mesh_is_inert():
    cfg = get_config("granite-moe-3b-a800m")
    sharder = make_sharder(cfg, None)
    assert sharder.spec(("embed", "heads")) == PartitionSpec() == ()
    assert sharder.named(("heads",)) is None
    assert sharder.replicated() is None
    t = torch.zeros(3, 4)
    assert sharder.constrain(t, ("batch",)) is t
    assert sharder.local(t, ("batch", "vocab")) is t


def test_constrain_checks_the_rank():
    sharder = make_sharder(get_config("smollm-360m"),
                           MeshShape((2, 4), ("data", "model")))
    t = torch.zeros(3, 4)
    assert sharder.constrain(t, ("batch", None)) is t
    with pytest.raises(ValueError, match="rank-2"):
        sharder.constrain(t, ("batch",))


# --------------------------------------------------------------------------
# Quantization, bit for bit
# --------------------------------------------------------------------------

def _quant_inputs():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    ties = (np.arange(-600, 600) / 254.0).astype(np.float32)  # .5 ties
    zeros = np.zeros(700, np.float32)
    zeros[300] = 1e-3
    return {"normal n=1000": x, "ties": ties, "zero blocks": zeros,
            "one value": np.float32([2.5]),
            "huge": (rng.standard_normal(512) * 1e30).astype(np.float32)}


@pytest.mark.parametrize("name", sorted(_quant_inputs()))
def test_quantize_int8_is_jax_bit_for_bit(name):
    x = _quant_inputs()[name]
    q, scale = compression.quantize_int8(torch.from_numpy(x))
    jq, jscale = jax_compression.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))
    back = compression.dequantize_int8(q, scale, len(x))
    np.testing.assert_array_equal(
        back.numpy().view(np.uint32),
        np.asarray(jax_compression.dequantize_int8(jq, jscale, len(x)))
        .view(np.uint32))


# --------------------------------------------------------------------------
# The JAX references on an Auto mesh of 8 host devices, and the port's
# worlds
# --------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import AxisType, make_mesh, shard_map
    from repro.configs import get_config, reduce_config
    from repro.models import moe as moe_lib
    from repro.parallel import compression
    from repro.parallel.context_parallel import (cp_specs,
                                                 halo_window_attention,
                                                 ring_attention)
    from repro.parallel.sharding import Sharder, make_sharder

    assert len(jax.devices()) == 8
    mesh = make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
    a = dict(np.load(sys.argv[1], allow_pickle=True))
    out = {}
    base = dataclasses.replace(
        reduce_config(get_config("granite-moe-3b-a800m")), d_model=32,
        d_ff=64, num_experts=4, num_experts_per_token=2,
        moe_capacity_factor=8.0)
    params = {k: jnp.asarray(a["moe_" + k])
              for k in ("router", "w_gate", "w_up", "w_down")}
    x = jnp.asarray(a["moe_x"])

    def moe(tag, cfg, x, sharder, p=params):
        def loss(p):
            o, aux = moe_lib.moe_layer(p, x, cfg, sharder)
            return jnp.sum(o ** 2) + aux["moe_aux_loss"], (o, aux)
        fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        if sharder.mesh is None:
            (_, (o, aux)), g = fn(p)
        else:
            with mesh:
                (_, (o, aux)), g = fn(p)
        out[tag + "/out"] = o
        for k, v in g.items():
            out[tag + "/grad/" + k] = v
        for k, v in aux.items():
            out[tag + "/aux/" + k] = v

    for impl in ("ep", "cap", "ffn", "gspmd"):
        cfg = dataclasses.replace(base, moe_impl=impl)
        moe("moe " + impl, cfg, x, make_sharder(cfg, mesh))
    moe("einsum", base, x, Sharder())

    def forward(tag, cfg, sharder):
        fn = jax.jit(lambda p: moe_lib.moe_layer(
            p, x.astype(jnp.bfloat16), cfg, sharder)[0].astype(jnp.float32))
        if sharder.mesh is None:
            out[tag] = fn(params)
        else:
            with mesh:
                out[tag] = fn(params)
    for impl in ("ep", "cap", "ffn", "gspmd"):
        cfg = dataclasses.replace(base, moe_impl=impl, dtype=jnp.bfloat16)
        forward("moe bf16 " + impl, cfg, make_sharder(cfg, mesh))
    forward("einsum bf16", dataclasses.replace(base, dtype=jnp.bfloat16),
            Sharder())
    cfg = dataclasses.replace(base, moe_impl="ep")
    moe("moe batch 1", cfg, x[:1], make_sharder(cfg, mesh))
    cfg = dataclasses.replace(base, moe_impl="ep", moe_group_rows=4,
                              moe_capacity_factor=1.0)
    moe("moe group shrink", cfg, x, make_sharder(cfg, mesh))
    # the einsum path on the mesh: the capacity slots over model, and 6
    # experts (which do not divide model 4: expert_ffn over model)
    capshard = (("experts", None), ("expert_ffn", None),
                ("moe_cap", "model"))
    cfg = dataclasses.replace(base, moe_impl="gspmd",
                              sharding_overrides=capshard)
    moe("moe gspmd capshard", cfg, x, make_sharder(cfg, mesh))
    forward("moe bf16 gspmd capshard",
            dataclasses.replace(cfg, dtype=jnp.bfloat16),
            make_sharder(cfg, mesh))
    params6 = {k: jnp.asarray(a["moe6_" + k])
               for k in ("router", "w_gate", "w_up", "w_down")}
    cfg = dataclasses.replace(base, moe_impl="gspmd", num_experts=6)
    moe("moe gspmd e6", cfg, x, make_sharder(cfg, mesh), params6)
    moe("einsum e6", dataclasses.replace(base, num_experts=6), x, Sharder(),
        params6)

    spec = cp_specs(mesh)
    q, k, v = (jnp.asarray(a[n]) for n in ("cp_q", "cp_k", "cp_v"))
    for name, kw in a["cp_cases"].item().items():
        if kw.get("window"):
            body = lambda q, k, v, kw=kw: halo_window_attention(
                q, k, v, axis_name="model", **kw)
        else:
            body = lambda q, k, v, kw=kw: ring_attention(
                q, k, v, axis_name="model", **kw)
        out["cp " + name] = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
            check_vma=False))(q, k, v)

    def comp(g, e):
        o, err = compression.compressed_psum(g[0, 0], "model", e[0, 0])
        tree = {"a": g[0, 0].reshape(4, -1), "b": {"c": g[0, 0, :300]}}
        to, te = compression.compressed_psum_tree(
            tree, "model", compression.init_errors(tree))
        return (o[None, None], err[None, None], to["a"][None, None],
                to["b"]["c"][None, None])
    # eager: under jit XLA turns the division by 127 into a product with
    # its reciprocal (a scale one ulp off the function as written)
    dm = P("data", "model")
    res = shard_map(comp, mesh=mesh, in_specs=(dm, dm),
                    out_specs=(dm,) * 4, check_vma=False)(
        jnp.asarray(a["comp_g"]), jnp.asarray(a["comp_err"]))
    for name, r in zip(("mean", "new_error", "tree a", "tree c"), res):
        out["compression/" + name] = r
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _moe_params(rng, e: int):
    cfg = moe_base(reduce_config, get_config)
    d, f = cfg.d_model, cfg.d_ff
    params = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
              "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    return {k: v.astype(np.float32) for k, v in params.items()}


def _moe_inputs():
    """(params of 4 experts, x, params of 6 experts)."""
    rng = np.random.default_rng(27)
    cfg = moe_base(reduce_config, get_config)
    params = _moe_params(rng, cfg.num_experts)
    x = rng.standard_normal((4, 64, cfg.d_model)).astype(np.float32)
    return params, x, _moe_params(np.random.default_rng(30), 6)


def _cp_inputs():
    rng = np.random.default_rng(28)
    b, h, kvh, s, hd = 2, 4, 2, 256, 16          # GQA 4/2
    return {"cp_q": rng.standard_normal((b, h, s, hd)).astype(np.float32),
            "cp_k": rng.standard_normal((b, kvh, s, hd)).astype(np.float32),
            "cp_v": rng.standard_normal((b, kvh, s, hd)).astype(np.float32)}


def _comp_inputs():
    rng = np.random.default_rng(29)
    return {"comp_g": (rng.standard_normal((2, 4, COMP_N)) * 0.01)
            .astype(np.float32),
            "comp_err": (rng.standard_normal((2, 4, COMP_N)) * 1e-4)
            .astype(np.float32)}


def model_batch(cfg, seed: int):
    """tokens, labels (some -1), packed-document segments and positions;
    frames for an encoder-decoder model."""
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, 3, (ROWS, SEQ)), axis=1).astype(np.int32)
    idx = np.arange(SEQ)
    starts = np.maximum.accumulate(
        np.where(np.diff(seg, axis=1, prepend=-1) != 0, idx, 0), axis=1)
    labels = rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)
    labels[rng.random((ROWS, SEQ)) < 0.1] = -1
    out = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ))
           .astype(np.int32),
           "segments": seg, "positions": (idx - starts).astype(np.int32),
           "labels": labels}
    if cfg.is_encoder_decoder:
        out["frame_embeds"] = rng.standard_normal(
            (ROWS, SEQ, cfg.d_model)).astype(np.float32)
    return out


def _model_spec():
    spec = {"params": {}, "batches": {}, "decode_tokens": {}}
    for i, name in enumerate(MODEL_CASES):
        cfg = model_config(name, reduce_config, get_config)
        spec["params"][name] = numpy_params(cfg, seed=40 + i)
        spec["batches"][name] = model_batch(cfg, seed=60 + i)
        spec["decode_tokens"][name] = np.random.default_rng(80 + i).integers(
            0, cfg.vocab_size, (ROWS, DECODE_STEPS)).astype(np.int32)
    return spec


def _spawn(world: int, job: str, spec: dict, tmp: pathlib.Path) -> list:
    out = tmp / f"{job}{world}"
    out.mkdir()
    mp.start_processes(run_world, args=(world, str(out / "init"), job, spec,
                                        str(out)),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(layers: [8 ranks' results], model: [4 ranks' results], the JAX
    references of the layers)."""
    tmp = tmp_path_factory.mktemp("parallel")
    params, x, params6 = _moe_inputs()
    layer_spec = {"moe_params": params, "moe_x": x, "moe6_params": params6,
                  **_cp_inputs(), "cp_cases": CP_CASES, **_comp_inputs()}
    np.savez(tmp / "ref_in.npz",
             **{f"moe_{k}": v for k, v in params.items()}, moe_x=x,
             **{f"moe6_{k}": v for k, v in params6.items()},
             **_cp_inputs(), **_comp_inputs(),
             cp_cases=np.array(CP_CASES, dtype=object))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    reference = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "ref_in.npz"),
         str(tmp / "ref_out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        layers = _spawn(8, "layers", layer_spec, tmp)
        model = _spawn(4, "model", _model_spec(), tmp)
        stdout, stderr = reference.communicate(timeout=600)
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.communicate()
    assert reference.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return layers, model, dict(np.load(tmp / "ref_out.npz"))


# --------------------------------------------------------------------------
# MoE modes, context parallelism, compression (world of 8)
# --------------------------------------------------------------------------

def _same_on_every_rank(ranks, key):
    for res in ranks[1:]:
        assert torch.equal(res[key]["out"], ranks[0][key]["out"]), key


@pytest.mark.parametrize("impl", ["ep", "cap", "ffn", "gspmd",
                                  "gspmd capshard", "gspmd e6"])
def test_moe_mode_equals_jax(runs, impl):
    """Each mode on the mesh against the JAX one on the Auto mesh and the
    JAX einsum path on one device (of 6 experts for ``gspmd e6``)."""
    layers, _, ref = runs
    key = f"moe {impl}"
    one = "einsum e6" if impl == "gspmd e6" else "einsum"
    got = layers[0][key]
    _same_on_every_rank(layers, key)
    np.testing.assert_allclose(got["out"].numpy(), ref[f"{key}/out"],
                               **MOE_TOL)
    np.testing.assert_allclose(got["out"].numpy(), ref[f"{one}/out"],
                               **MOE_TOL)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), ref[f"{key}/grad/{name}"],
                                   **MOE_GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), ref[f"{one}/grad/{name}"],
                                   **MOE_GRAD_TOL, err_msg=name)
    for name, v in got["aux"].items():
        np.testing.assert_allclose(v, ref[f"{key}/aux/{name}"], **MOE_TOL)


@pytest.mark.parametrize("impl", ["ep", "cap", "ffn", "gspmd",
                                  "gspmd capshard"])
def test_moe_mode_bf16_equals_jax(runs, impl):
    """In bf16 (the full-size compute dtype; the reductions in bf16 in
    both packages) each mode lies within MOE_BF16_ULPS bf16 units of the
    largest output from the JAX mode, and no further from the port's
    einsum path on one device (no mesh) than the JAX mode lies from the
    JAX einsum path, plus one unit: ``ffn``'s partial products, rounded
    to bf16 before their sum, add as much error in the port as in the
    reference."""
    layers, _, ref = runs
    key = f"moe bf16 {impl}"
    _same_on_every_rank(layers, key)
    got = layers[0][key]["out"].float().numpy()
    one = layers[0]["einsum bf16"]["out"].float().numpy()
    unit = 2.0 ** -8 * np.abs(ref["einsum bf16"]).max()
    assert np.abs(got - ref[key]).max() <= MOE_BF16_ULPS * unit
    assert np.abs(got - one).max() \
        <= np.abs(ref[key] - ref["einsum bf16"]).max() + unit


@pytest.mark.parametrize("key", ["moe batch 1", "moe group shrink"])
def test_moe_fallback_and_group_shrink_equal_jax(runs, key):
    """A batch of 1 row takes the einsum path (each model rank its
    experts, every data rank the same row); dispatch groups of 4 rows
    shrink to 2 so that they split over data 2 (with drops at capacity
    factor 1, which depend on the groups)."""
    layers, _, ref = runs
    got = layers[0][key]
    _same_on_every_rank(layers, key)
    np.testing.assert_allclose(got["out"].numpy(), ref[f"{key}/out"],
                               **MOE_TOL)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), ref[f"{key}/grad/{name}"],
                                   **MOE_GRAD_TOL, err_msg=name)
    for name, v in got["aux"].items():
        np.testing.assert_allclose(v, ref[f"{key}/aux/{name}"], **MOE_TOL)
    if key == "moe group shrink":
        assert got["aux"]["moe_drop_fraction"] > 0


# each EINSUM_CASES case's split of the expert work on data 2 x model 4
# (the grouped batch rows' split times the experts / moe_cap /
# expert_ffn split), and the all-gathers of its moe_layer call: the
# router's alone, where the rules split the experts (32 x 1 float32 a
# rank); the expert weights are never gathered
EINSUM_SPLIT = {"moe gspmd": 2 * 4, "moe gspmd capshard": 2 * 4,
                "moe gspmd e6": 2 * 4, "moe batch 1": 1 * 4}
EINSUM_GATHER_BYTES = {"moe gspmd": [32 * 1 * 4], "moe gspmd capshard": [],
                       "moe gspmd e6": [], "moe batch 1": [32 * 1 * 4]}


def _bmm_flops(flops: dict) -> int:
    return sum(n for op, n in flops.items() if op.split(".")[-1] == "bmm")


@pytest.mark.parametrize("key", sorted(EINSUM_CASES))
def test_moe_einsum_path_computes_this_ranks_block(runs, key):
    """On the mesh, each rank's expert products (FlopCounterMode's bmm
    flops of its moe_layer call) are the one-device einsum path's on the
    same inputs over the split's size, as the JAX constraints cut them;
    no expert weight is all-gathered."""
    layers, _, _ = runs
    fields, rows = EINSUM_CASES[key]
    # one device: the einsum path, nothing cut
    cfg = dataclasses.replace(moe_base(reduce_config, get_config),
                              **dict(fields, moe_impl="gspmd",
                                     sharding_overrides=()))
    params, x, params6 = _moe_inputs()
    params = params6 if cfg.num_experts == 6 else params
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        moe.moe_layer({k: torch.from_numpy(v) for k, v in params.items()},
                      torch.from_numpy(x[:rows]), cfg)
    whole = _bmm_flops({str(op): n for op, n
                        in counter.get_flop_counts()["Global"].items()})
    assert whole > 0
    for res in layers:
        assert _bmm_flops(res[key]["flops"]) * EINSUM_SPLIT[key] == whole
        gathers = res[key]["traffic"].get("all-gather")
        got = [] if gathers is None else [gathers["operand_bytes"]]
        assert got == EINSUM_GATHER_BYTES[key]
        if gathers is not None:
            assert gathers["count"] == 1


@pytest.mark.parametrize("case", sorted(CP_CASES))
def test_context_parallel_equals_jax(runs, case):
    layers, _, ref = runs
    got = layers[0][f"cp {case}"]
    for res in layers[1:]:
        assert torch.equal(res[f"cp {case}"], got)
    np.testing.assert_allclose(got.numpy(), ref[f"cp {case}"], **CP_TOL)


def test_compressed_psum_equals_jax(runs):
    """Every model rank gets the same mean bit for bit; it equals the
    JAX one up to the order of the four additions (within 4 float32 ulps
    of the sum of |q|·scale over the ranks); ``new_error`` exactly."""
    layers, _, ref = runs
    inputs = _comp_inputs()
    eps = np.finfo(np.float32).eps
    for res in layers:
        c = res["compression"]
        d, m = c["coord"]
        peers = [r["compression"] for r in layers
                 if r["compression"]["coord"][0] == d]
        assert all(torch.equal(p["mean"], c["mean"]) for p in peers)
        mag = 0.0
        for mm in range(4):
            target = torch.from_numpy(inputs["comp_g"][d, mm]
                                      + inputs["comp_err"][d, mm])
            q, scale = compression.quantize_int8(target)
            mag = mag + (q.abs().float() * scale[:, None]).reshape(-1)[
                :COMP_N].numpy()
        want = ref["compression/mean"][d, m]
        assert (np.abs(c["mean"].numpy() - want) * 4
                <= 4 * eps * mag).all()
        np.testing.assert_array_equal(c["new_error"].numpy(),
                                      ref["compression/new_error"][d, m])
        np.testing.assert_allclose(c["tree_mean"]["a"].numpy(),
                                   ref["compression/tree a"][d, m],
                                   rtol=0, atol=4 * eps * mag.max())
        np.testing.assert_allclose(c["tree_mean"]["b"]["c"].numpy(),
                                   ref["compression/tree c"][d, m],
                                   rtol=0, atol=4 * eps * mag.max())
        exact = (inputs["comp_g"][d] + inputs["comp_err"][d]).mean(axis=0)
        assert np.abs(c["mean"].numpy() - exact).max() \
            <= np.abs(inputs["comp_g"][d] + inputs["comp_err"][d]).max() / 127


# --------------------------------------------------------------------------
# Whole models (world of 4, data 2 × model 2)
# --------------------------------------------------------------------------

_JAX_CACHE = {}


def _jax_model(name: str):
    """The JAX ``Model(cfg, Sharder())``'s forward, prefill + decode
    logits, loss and gradients on one device (computed once a case)."""
    if name in _JAX_CACHE:
        return _JAX_CACHE[name]
    i = list(MODEL_CASES).index(name)
    cfg = model_config(name, reduce_config, get_config)
    jcfg = model_config(name, jax_reduce_config, jax_get_config)
    jm = JaxModel(jcfg)
    jp = jax.tree.map(jnp.asarray, numpy_params(cfg, seed=40 + i))
    b = {k: jnp.asarray(v) for k, v in model_batch(cfg, seed=60 + i).items()}
    feed = np.random.default_rng(80 + i).integers(
        0, cfg.vocab_size, (ROWS, DECODE_STEPS)).astype(np.int32)
    out = {"forward": np.asarray(jax.jit(jm.forward)(jp, b)[0])}
    prompt = {k: v for k, v in b.items() if k in ("tokens", "frame_embeds")}
    cache, last = jax.jit(jm.prefill)(
        jp, prompt, jm.init_cache(ROWS, SEQ + DECODE_STEPS + 4))
    steps = [last]
    enc = jax.jit(jm._encode)(jp, prompt) if jcfg.is_encoder_decoder \
        else None
    decode = jax.jit(jm.decode_step)
    for t in range(DECODE_STEPS):
        cache, last = decode(jp, jnp.asarray(feed[:, t:t + 1]), cache,
                             jnp.int32(SEQ + t), enc)
        steps.append(last)
    out["decode"] = np.concatenate([np.asarray(s) for s in steps], axis=1)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, b)
    out["loss"] = float(loss)
    out["aux"] = {k: float(v) for k, v in aux.items()}
    out["grads"] = {p: np.asarray(g) for p, g in iter_leaves(grads)}
    out["vocab"] = cfg.vocab_size
    _JAX_CACHE[name] = out
    return out


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ranks_agree(model_runs, name, what):
    for res in model_runs[1:]:
        assert torch.equal(res[name][what], model_runs[0][name][what])


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_sharded_forward_equals_jax(runs, name):
    _, model_runs, _ = runs
    want = _jax_model(name)
    v = want["vocab"]
    got = model_runs[0][name]["forward"].numpy()
    _ranks_agree(model_runs, name, "forward")
    assert got.shape == want["forward"].shape
    assert _rel(got[..., :v], want["forward"][..., :v]) <= MODEL_REL
    assert (got[..., v:] == -1.0e30).all()


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_sharded_prefill_and_decode_equal_jax(runs, name):
    _, model_runs, _ = runs
    want = _jax_model(name)
    v = want["vocab"]
    got = model_runs[0][name]["decode"].numpy()
    _ranks_agree(model_runs, name, "decode")
    assert got.shape == (ROWS, DECODE_STEPS + 1, got.shape[-1])
    for t in range(DECODE_STEPS + 1):
        assert _rel(got[:, t, :v], want["decode"][:, t, :v]) <= MODEL_REL, t


def _port_grads(name: str, dtype=torch.float32):
    """The port's loss gradients on one device (no sharder)."""
    i = list(MODEL_CASES).index(name)
    cfg = dataclasses.replace(model_config(name, reduce_config, get_config),
                              dtype=dtype, param_dtype=dtype)
    params = model_params_from_arrays(numpy_params(cfg, seed=40 + i), cfg,
                                      device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in model_batch(cfg, seed=60 + i).items()}
    _, grads = value_and_grad(Model(cfg, device="cpu"), params, batch)
    return {p: g.numpy() for p, g in iter_leaves(grads)}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_sharded_loss_and_grads_equal_jax(runs, name):
    _, model_runs, _ = runs
    want = _jax_model(name)
    res = model_runs[0][name]
    for other in model_runs[1:]:
        assert other[name]["loss"] == res["loss"]
    np.testing.assert_allclose(res["loss"], want["loss"], rtol=MODEL_REL)
    for k, val in res["aux"].items():
        np.testing.assert_allclose(val, want["aux"][k], rtol=MODEL_REL,
                                   atol=1e-7)
    grads = dict(iter_leaves(res["grads"]))
    assert grads.keys() == want["grads"].keys()
    single = _port_grads(name)
    twin = name in FLOAT64_TWINS
    tol = FLOAT32_SSD_GRAD_REL if twin else MODEL_REL
    for path, g in grads.items():
        assert g.shape == want["grads"][path].shape, path
        if not twin:
            assert _rel(g.numpy(), single[path]) <= MODEL_REL, path
        assert _rel(g.numpy(), want["grads"][path]) <= tol, path
    if twin:
        key = f"{name} float64"
        for other in model_runs[1:]:
            assert other[key]["loss"] == model_runs[0][key]["loss"]
        single = _port_grads(name, torch.float64)
        grads = dict(iter_leaves(model_runs[0][key]["grads"]))
        assert grads.keys() == single.keys()
        for path, g in grads.items():
            assert g.dtype == torch.float64, path
            assert _rel(g.numpy(), single[path]) <= MODEL_REL, path


def test_head_layouts_of_the_cases():
    """The two head-count cases cut as their names say at model 2."""
    sharder = make_sharder(get_config("smollm-360m"),
                           MeshShape((2, 2), ("data", "model")))
    for name, want in (("smollm heads 3/1", (None, None)),
                       ("smollm heads 4/1", ("model", None))):
        cfg = model_config(name, reduce_config, get_config)
        got = tuple(sharder.spec(("heads", "kv_heads"),
                                 (cfg.num_heads, cfg.num_kv_heads)))
        assert got == want, name


def test_tree_named_shardings_and_param_specs():
    """``param_specs`` gives each leaf's logical axes, ``param_shapes``
    meta tensors of its global shape, and ``tree_named_shardings`` a
    Layout of the JAX spec for each leaf."""
    from repro_torch.models.api import param_shapes, param_specs
    from repro_torch.parallel.sharding import Layout, tree_named_shardings
    cfg = get_config("granite-moe-3b-a800m")
    mesh = MeshShape((2, 4), ("data", "model"))
    sharder = make_sharder(cfg, mesh)
    jsharder = jax_make_sharder(jax_get_config("granite-moe-3b-a800m"),
                                AbstractMesh((2, 4), ("data", "model")))
    defs = model_defs(cfg)
    specs, shapes = param_specs(defs), param_shapes(defs, torch.float32)
    layouts = tree_named_shardings(sharder, specs)
    for (path, d), (_, axes), (_, t), (_, lay) in zip(
            iter_leaves(defs), iter_leaves(specs), iter_leaves(shapes),
            iter_leaves(layouts)):
        assert axes == d.axes and t.device.type == "meta"
        assert tuple(t.shape) == d.shape and t.dtype == torch.float32
        assert isinstance(lay, Layout) and lay.mesh is mesh
        assert tuple(lay.spec) == tuple(jsharder.spec(d.axes)), path
    assert tree_named_shardings(make_sharder(cfg, None), specs)["embed"][
        "embedding"] is None
