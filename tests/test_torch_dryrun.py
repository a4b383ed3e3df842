"""The port's dry run: the ``sds_*`` specs of ``repro_torch.launch.steps``
against the JAX package's ``ShapeDtypeStruct`` trees on both production
meshes (the JAX side over ``AbstractMesh``es, as in
``tests/test_torch_parallel.py``), and ``launch.dryrun``'s cells and CLI
in a fake world, in a subprocess (the fake process group is the
process's default group)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as JSHAPES
from repro.configs import ShapeDef as JShapeDef
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.launch import steps as jsteps
from repro.models import Model as JaxModel
from repro.parallel.sharding import make_sharder as jmake_sharder
from repro.perf import analytic as janalytic
from repro.train.optimizer import AdamW as JAdamW
from repro.train.optimizer import cosine_schedule as jcosine
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import steps
from repro_torch.models import Model
from repro_torch.parallel.sharding import MeshShape, make_sharder
from repro_torch.train.optimizer import AdamW, cosine_schedule

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
DECODE = "decode_32k"
#: granite-moe-3b-a800m in each manual MoE mode: the cache specs must not
#: build a second, mesh-less ``Model`` (which refuses these modes)
MOE_MODES = ("ep", "cap", "ffn")
SDS_CASES = list(ARCH_IDS) + [f"granite-moe-3b-a800m:{m}" for m in MOE_MODES]


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix=""):
    if isinstance(tree, steps.ShardedSpec):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    else:                                  # a NamedTuple
        items = zip(tree._fields, tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SDS_CASES)
def test_sds_blocks_equal_jax_shard_shapes(arch, mesh):
    """Every params, opt, batch, cache, token, enc_out and scalar leaf's
    block is the JAX ``shard_shape``, FSDP and Mamba heads included; an
    ``arch:mode`` case sets ``moe_impl``."""
    sizes, names = MESHES[mesh]
    arch, _, mode = arch.partition(":")
    cfg, jcfg = get_config(arch), jget_config(arch)
    if mode:
        cfg = dataclasses.replace(cfg, moe_impl=mode)
        jcfg = dataclasses.replace(jcfg, moe_impl=mode)
    sharder = make_sharder(cfg, MeshShape(sizes, names))
    jsharder = jmake_sharder(jcfg, AbstractMesh(sizes, names))
    model = Model(cfg, sharder=sharder, device="meta")
    jmodel = JaxModel(jcfg, jsharder)
    shape = SHAPES[DECODE]
    b, s = shape.global_batch, shape.seq_len
    opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
    jopt = JAdamW(jcosine(3e-4, 100, 10_000))
    trees = {
        "params": (steps.sds_params(model, sharder),
                   jsteps.sds_params(jmodel, jsharder)),
        "opt": (steps.sds_opt_state(model, sharder, opt),
                jsteps.sds_opt_state(jmodel, jsharder, jopt)),
        "batch": (steps.sds_batch(cfg, SHAPES["train_4k"], sharder),
                  jsteps.sds_batch(jcfg, JSHAPES["train_4k"], jsharder)),
        "cache": (steps.sds_cache(model, sharder, b, s),
                  jsteps.sds_cache(jmodel, jsharder, b, s)),
        "token": (steps.sds_token(cfg, b, sharder),
                  jsteps.sds_token(jcfg, b, jsharder)),
        "enc_out": (steps.sds_enc_out(cfg, b, s, sharder),
                    jsteps.sds_enc_out(jcfg, b, s, jsharder)),
        "scalar": (steps.sds_scalar(sharder), jsteps.sds_scalar(jsharder)),
    }
    for kind, (mine, theirs) in trees.items():
        mine, theirs = _port_leaves(mine), _jax_leaves(theirs)
        assert mine.keys() == theirs.keys(), kind
        for path, leaf in mine.items():
            want = theirs[path]
            where = f"{kind}:{path}"
            assert leaf.shape == tuple(want.shape), where
            assert str(leaf.dtype).split(".")[-1] == want.dtype.name, where
            assert tuple(leaf.layout.spec) == tuple(want.sharding.spec), where
            assert leaf.block.device.type == "meta"
            assert tuple(leaf.block.shape) \
                == tuple(want.sharding.shard_shape(want.shape)), where


_CELLS = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config, reduce_config, ShapeDef
    from repro_torch.launch import dryrun
    out = {}
    for arch, kind in (("granite-moe-3b-a800m", "train"),
                       ("seamless-m4t-medium", "decode")):
        cfg = reduce_config(get_config(arch))
        shape = ShapeDef("reduced", 64, 8, kind)
        out[kind] = dryrun.run_cell(arch, "reduced", False, cfg=cfg,
                                    shape=shape,
                                    mesh=((2, 4), ("data", "model")))
    granite = reduce_config(get_config("granite-moe-3b-a800m"))
    for mode in ("ep", "cap", "ffn"):
        out[mode] = dryrun.run_cell(
            "granite-moe-3b-a800m", "reduced", False,
            cfg=dataclasses.replace(granite, moe_impl=mode),
            shape=ShapeDef("reduced", 64, 8, "decode"),
            mesh=((2, 2), ("data", "model")))
    rc = dryrun.main(["--arch", "smollm-360m", "--shape",
                      "decode_32k,long_500k", "--mesh", "single",
                      "--out", sys.argv[1]])
    out["rc"] = rc
    print(json.dumps(out))
""")


def test_run_cell_and_cli_in_a_fake_world(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _CELLS, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    keys = {"arch", "shape", "mesh", "devices", "kind", "params",
            "active_params", "analytic", "analytic_bytes",
            "model_flops_ref", "trace_s", "cost", "collectives",
            "args_bytes", "peak_live_bytes"}
    for kind, arch in (("train", "granite-moe-3b-a800m"),
                       ("decode", "seamless-m4t-medium")):
        rec = out[kind]
        assert keys <= rec.keys(), kind
        assert (rec["mesh"], rec["devices"], rec["kind"]) == ("2x4", 8, kind)
        jcfg = jreduce_config(jget_config(arch))
        jshape = JShapeDef("reduced", 64, 8, kind)
        assert rec["params"] == jcfg.param_count()
        assert rec["active_params"] == jcfg.active_param_count()
        assert rec["analytic"] == janalytic.flops_model(jcfg, jshape)
        assert rec["analytic_bytes"] == janalytic.bytes_model(jcfg, jshape)
        assert rec["model_flops_ref"] \
            == janalytic.model_flops_reference(jcfg, jshape)
        assert rec["cost"]["flops"] > 0 and rec["trace_s"] > 0
        assert rec["collectives"]["by_op"]["all-reduce"]["count"] > 0
        assert rec["args_bytes"]["total"] \
            == sum(v for k, v in rec["args_bytes"].items() if k != "total")
        assert rec["peak_live_bytes"] >= rec["args_bytes"]["params"]
    for mode in ("ep", "cap", "ffn"):       # the manual MoE modes' decode
        rec = out[mode]
        assert keys <= rec.keys(), mode
        assert (rec["mesh"], rec["devices"], rec["kind"]) == ("2x2", 4,
                                                              "decode")
        assert rec["args_bytes"]["cache"] > 0, mode
        assert rec["cost"]["flops"] > 0 and rec["trace_s"] > 0, mode
        assert rec["collectives"]["by_op"]["all-reduce"]["count"] > 0, mode
    assert out["train"]["args_bytes"]["moments"] > 0
    assert out["decode"]["args_bytes"]["cache"] > 0
    assert out["rc"] == 0
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["dryrun_single_smollm-360m_decode_32k.json",
                     "dryrun_single_smollm-360m_long_500k.json"]
    skip = json.loads((tmp_path / files[1]).read_text())
    assert skip["mesh"] == "16x16" and "skipped" in skip
    cell = json.loads((tmp_path / files[0]).read_text())
    assert cell["devices"] == 256 and cell["kind"] == "decode"
    assert cell["analytic"] == janalytic.flops_model(
        jget_config("smollm-360m"), JSHAPES["decode_32k"])
