"""The FSDP form of ``"embed": "data"`` and Mamba-2 tensor parallelism of
the port against the JAX package on the CPU, in a gloo world of 4 CPU
ranks (``tests/_torch_parallel_worker.py``'s job ``fsdp``, spawned once
for the module), on meshes data 2 × model 2 and pod 2 × data 2 × model 1.

* **Blocks**: every parameter, AdamW moment and cache block that a rank
  holds has the JAX ``NamedSharding.shard_shape`` on an ``AbstractMesh``
  of the same shape.
* **Train step** of reduced smollm-360m and reduced jamba-1.5-large-398b
  (attention, Mamba and MoE layers), two microbatches: the loss, the
  gradients and the moments (gathered) and the updated parameters equal
  one rank's and the JAX ``Model(cfg, Sharder())``'s on one device; every
  gradient leaf replicated over the model axis is the same bits on every
  model rank; the traffic holds the FSDP gather's all-gathers and
  reduce-scatters.
* **Checkpoints**: a world of 1's checkpoint restores into the FSDP
  layout bit for bit and, saved again from there, restores into a world
  of 1 bit for bit.
* **Mamba-2 tensor parallelism**: prefill and 2 decode steps of reduced
  mamba2-2.7b with its 16 heads split over model 2, and with 15 heads,
  which the divisibility fallback replicates, equal one rank's.

The same numpy inputs, made from seeds, go to both packages.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import Model as JaxModel
from repro.models.transformer import model_defs as jax_model_defs
from repro.parallel.sharding import make_sharder as jax_make_sharder
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.models import Model
from repro_torch.models.api import iter_leaves
from repro_torch.parallel.sharding import MeshShape, make_sharder
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import make_grad_accum_loss, make_train_step
from repro_torch.train.optimizer import AdamState
from _torch_model_parity import numpy_params, tokens
from _torch_parallel_worker import (FSDP_ARCHS, FSDP_LR, FSDP_MESHES,
                                    FSDP_MICROBATCHES, MAMBA_DECODE_STEPS,
                                    MAMBA_TP_CASES, fsdp_config,
                                    fsdp_optimizer, mamba_tp_config,
                                    run_world)
from test_torch_parallel import model_batch

jax.config.update("jax_platform_name", "cpu")

WORLD = 4
CACHE_LEN = 16
CKPT_STEP = 3
MAMBA_ROWS, MAMBA_SEQ = 4, 32
# each loss and logit, and smollm's gradient, moment and updated
# parameter leaves, within this share of its largest magnitude of one
# rank's and of the JAX package's (float32: the gathers are exact, the
# reduce-scatters and the split products sum in another order)
REL = 1e-5
# reduced jamba's gradients, moments and updated parameters: the config
# is ill-conditioned in float32 (Mamba group norms over 8 channels with
# rms down to ~4e-3, MoE top-2 of 4), so another summation order moves
# its gradients far more than smollm's.  At this batch one rank lies
# 1.7e-3 of a leaf's largest |g| from the JAX package; data 2 x model 2
# lies 1.7e-3 from one rank with the Mamba heads replicated (the layout
# before the head split) and 3.1e-3 with them split.  A reduction fault
# reads ~1: B's gradient left partial (no copy_to) moved leaves by
# 0.99-1.1 of their largest |g|
GRAD_REL = {"smollm-360m": REL, "jamba-1.5-large-398b": 1e-2}
# where one rank's first gradient is at noise level (0 < |g| < 1e3 ·
# AdamW's eps), its first update g / (|g| + eps) may move a parameter by
# up to 2 · lr (tests/test_torch_parallel_train.py)
NOISY_GRAD = 1e3 * 1e-8
SEEDS = {"smollm-360m": 300, "jamba-1.5-large-398b": 301}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_tree(tree):
    return {p: t.detach().numpy() for p, t in iter_leaves(tree)}


def _checkpoint_arrays(cfg):
    """The world of 1's state: parameters of ``numpy_params``, moments
    drawn from a seed."""
    rng = np.random.default_rng(310)
    params = numpy_params(cfg, seed=311)

    def moment(scale):
        return {k: moment_leaf(v, scale) for k, v in params.items()}

    def moment_leaf(v, scale):
        if isinstance(v, dict):
            return {k: moment_leaf(x, scale) for k, x in v.items()}
        return (np.abs(rng.standard_normal(v.shape)) * scale).astype(
            np.float32)
    return {"params": params, "m": moment(1e-3), "v": moment(1e-6)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree).clone()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    spec = {"dtype": torch.float32, "cache_len": CACHE_LEN,
            "params": {}, "batches": {}, "mamba_params": {},
            "mamba_tokens": {}, "ckpt_in": str(tmp / "in"),
            "ckpt_out": str(tmp / "out")}
    for arch in FSDP_ARCHS:
        cfg = fsdp_config(arch, reduce_config, get_config)
        spec["params"][arch] = numpy_params(cfg, seed=SEEDS[arch])
        spec["batches"][arch] = model_batch(cfg, seed=SEEDS[arch] + 10)
    for i, name in enumerate(MAMBA_TP_CASES):
        cfg = mamba_tp_config(name, reduce_config, get_config)
        spec["mamba_params"][name] = numpy_params(cfg, seed=320 + i)
        spec["mamba_tokens"][name] = tokens(cfg, MAMBA_ROWS, MAMBA_SEQ,
                                            seed=330 + i)
    cfg = fsdp_config("smollm-360m", reduce_config, get_config)
    arrays = _checkpoint_arrays(cfg)
    spec["ckpt_arrays"] = arrays
    ckpt.save_checkpoint(
        tmp / "in", CKPT_STEP,
        {"params": _to_torch(arrays["params"]),
         "opt_state": AdamState(torch.tensor(CKPT_STEP, dtype=torch.int32),
                                _to_torch(arrays["m"]),
                                _to_torch(arrays["v"]))},
        {"step": CKPT_STEP})
    out = tmp / "world"
    out.mkdir()
    mp.start_processes(run_world, args=(WORLD, str(out / "init"), "fsdp",
                                        spec, str(out)),
                       nprocs=WORLD, join=True, start_method="spawn")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"ranks": ranks, "spec": spec, "tmp": tmp}


# --------------------------------------------------------------------------
# The references on one device
# --------------------------------------------------------------------------

_ONE = {}


def _one_rank(arch: str) -> dict:
    """The port's train step on one device: loss, gradients, moments and
    updated parameters."""
    if arch in _ONE:
        return _ONE[arch]
    cfg = fsdp_config(arch, reduce_config, get_config)
    model = Model(cfg, device="cpu")
    params = model_params_from_arrays(numpy_params(cfg, seed=SEEDS[arch]),
                                      cfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in model_batch(cfg, seed=SEEDS[arch] + 10).items()}
    (loss, _), grads = make_grad_accum_loss(model, FSDP_MICROBATCHES)(
        params, batch)
    opt = fsdp_optimizer(torch.float32)
    params, state, metrics = make_train_step(model, opt, FSDP_MICROBATCHES)(
        params, opt.init(params), batch)
    _ONE[arch] = {"loss": float(loss), "grads": _np_tree(grads),
                  "params": _np_tree(params), "m": _np_tree(state.m),
                  "grad_norm": float(metrics["grad_norm"])}
    return _ONE[arch]


_JAX = {}


def _jax_grads(arch: str) -> dict:
    """The JAX ``Model(cfg, Sharder())``'s loss and gradients on one
    device, averaged over the microbatches as the port's loop does."""
    if arch in _JAX:
        return _JAX[arch]
    cfg = fsdp_config(arch, reduce_config, get_config)
    jm = JaxModel(fsdp_config(arch, jax_reduce_config, jax_get_config))
    jp = jax.tree.map(jnp.asarray, numpy_params(cfg, seed=SEEDS[arch]))
    batch = model_batch(cfg, seed=SEEDS[arch] + 10)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))
    rows = batch["tokens"].shape[0] // FSDP_MICROBATCHES
    losses, grads = [], []
    for i in range(FSDP_MICROBATCHES):
        loss, g = fn(jp, {k: jnp.asarray(v[i * rows:(i + 1) * rows])
                          for k, v in batch.items()})
        losses.append(float(loss))
        grads.append({p: np.asarray(x, np.float64)
                      for p, x in iter_leaves(g)})
    _JAX[arch] = {"loss": float(np.mean(losses)),
                  "grads": {p: sum(g[p] for g in grads) / len(grads)
                            for p in grads[0]}}
    return _JAX[arch]


def _jax_shard_shapes(arch: str, mesh_name: str) -> dict:
    """{kind: {path: shard shape}} of the JAX parameters (and moments, laid
    out as they are) and caches on an AbstractMesh."""
    sizes, names = FSDP_MESHES[mesh_name]
    jcfg = fsdp_config(arch, jax_reduce_config, jax_get_config)
    mesh = AbstractMesh(sizes, names)
    sharder = jax_make_sharder(jcfg, mesh)
    params = {}
    flat = jax.tree_util.tree_flatten_with_path(
        jax_model_defs(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    for path, d in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        params[key] = NamedSharding(mesh, sharder.spec(d.axes, d.shape)) \
            .shard_shape(d.shape)
    jm = JaxModel(jcfg, sharder)
    init = jax.eval_shape(lambda: jm.init_cache(4, CACHE_LEN))
    cache = {}
    for name, axes in jm.cache_spec_axes().items():
        for field, ax, arr in zip(axes._fields, axes, init[name]):
            cache[f"{name}/{field}"] = NamedSharding(
                mesh, sharder.spec(ax, arr.shape)).shard_shape(arr.shape)
    return {"params": params, "opt": params, "cache": cache}


CASES = [(m, a) for m in FSDP_MESHES for a in FSDP_ARCHS]


# --------------------------------------------------------------------------
# Blocks, train step, replicated gradients, traffic
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,arch", CASES)
def test_blocks_equal_jax_shard_shapes(runs, mesh, arch):
    want = _jax_shard_shapes(arch, mesh)
    sizes, names = FSDP_MESHES[mesh]
    sharder = make_sharder(fsdp_config(arch, reduce_config, get_config),
                           MeshShape(sizes, names))
    defs = dict(iter_leaves(Model(fsdp_config(arch, reduce_config,
                                              get_config),
                                  device="meta").defs()))
    for rank in runs["ranks"]:
        blocks = rank[f"{mesh}/{arch}"]["blocks"]
        for kind in ("params", "opt", "cache"):
            assert blocks[kind].keys() == want[kind].keys(), kind
            for path, shape in blocks[kind].items():
                assert shape == tuple(want[kind][path]), (kind, path)
        for path, d in defs.items():
            assert sharder.block_shape(d.axes, d.shape) \
                == blocks["params"][path], path
    # the embedding's d_model is cut over data: the FSDP layout is on
    assert blocks["params"]["embed/embedding"][1] \
        == fsdp_config(arch, reduce_config, get_config).d_model // 2


@pytest.mark.parametrize("mesh,arch", CASES)
def test_fsdp_train_step_equals_one_rank_and_jax(runs, mesh, arch):
    key = f"{mesh}/{arch}"
    got = runs["ranks"][0][key]
    for rank in runs["ranks"][1:]:
        assert rank[key]["loss"] == got["loss"]
        assert rank[key]["grad_norm"] == got["grad_norm"]
    one, ref = _one_rank(arch), _jax_grads(arch)
    assert _rel(got["loss"], one["loss"]) <= REL
    assert _rel(got["loss"], ref["loss"]) <= REL
    tol = GRAD_REL[arch]
    assert _rel(got["grad_norm"], one["grad_norm"]) <= tol
    grads = _np_tree(got["grads"])
    assert grads.keys() == one["grads"].keys() == ref["grads"].keys()
    for path, g in grads.items():
        assert _rel(g, one["grads"][path]) <= tol, path
        assert _rel(g, ref["grads"][path]) <= tol, path
    for path, m in _np_tree(got["m"]).items():
        assert _rel(m, one["m"][path]) <= tol, path
    for path, p in _np_tree(got["params"]).items():
        # an entry whose gradient is within the two runs' difference of 0
        # may take the other sign in AdamW's first update
        want, g1 = one["params"][path], np.abs(one["grads"][path])
        diff = np.abs(grads[path] - one["grads"][path]).max()
        noisy = (g1 < max(NOISY_GRAD, diff)) & (g1 > 0)
        assert noisy.sum() <= 0.05 * max((g1 > 0).sum(), 1), path
        assert np.abs(p - want)[~noisy].max(initial=0.0) \
            <= tol * np.abs(want).max(), path
        assert (np.abs(p - want)[noisy] <= 2 * FSDP_LR).all(), path


@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_replicated_gradients_are_the_same_bits_on_model_ranks(runs, arch):
    """Leaves replicated over the model axis (norm scales, the Mamba
    ``w_bcdt`` / ``conv_B`` / ``conv_C``, leaves the fallback replicates)
    carry the same gradient bits on every model rank of a data rank."""
    key = f"data 2 x model 2/{arch}"
    by_data = {}
    for rank in runs["ranks"]:
        by_data.setdefault(rank[key]["coord"]["data"], []).append(rank[key])
    assert all(len(group) == 2 for group in by_data.values())
    paths = runs["ranks"][0][key]["replicated"].keys()
    assert "final_norm/scale" in paths
    if arch.startswith("jamba"):
        assert "blocks/layer0/mixer/w_bcdt" in paths
    for first, second in by_data.values():
        for path in paths:
            a, b = first["replicated"][path], second["replicated"][path]
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), path


@pytest.mark.parametrize("mesh", list(FSDP_MESHES))
def test_traffic_names_the_fsdp_collectives(runs, mesh):
    """The FSDP gather's forward all-gathers and backward reduce-scatters
    are recorded by kind (the dry run's record); on pod 2 × data 2 the
    microbatch of 2 rows splits over pod alone, so the gathers' backward
    sums over no axis and the pod sum is left to ``data_parallel_sum``."""
    traffic = runs["ranks"][0][f"{mesh}/smollm-360m"]["traffic"]
    assert traffic["all-gather"]["count"] > 0
    if mesh.startswith("pod"):
        assert "reduce-scatter" not in traffic
    else:
        assert traffic["reduce-scatter"]["count"] > 0


# --------------------------------------------------------------------------
# Checkpoints across world sizes
# --------------------------------------------------------------------------

def test_checkpoint_crosses_world_sizes_bitwise(runs):
    got = runs["ranks"]
    assert all(r["checkpoint"]["restored_bitwise"] for r in got)
    assert all(r["checkpoint"]["step"] == CKPT_STEP for r in got)
    tmp = runs["tmp"]
    one, fsdp = (ckpt.latest_checkpoint(tmp / d) for d in ("in", "out"))
    assert ckpt.checkpoint_step(fsdp) == CKPT_STEP
    meta = [json.loads((p / "meta.json").read_text()) for p in (one,
                                                                      fsdp)]
    assert [{k: m[k] for k in ("paths", "shapes", "dtypes")} for m in meta] \
        == [{k: meta[0][k] for k in ("paths", "shapes", "dtypes")}] * 2
    with np.load(one / "arrays.npz") as a, np.load(fsdp / "arrays.npz") as b:
        for i, path in enumerate(meta[0]["paths"]):
            np.testing.assert_array_equal(
                a[f"a{i}"].reshape(-1).view(np.uint8),
                b[f"a{i}"].reshape(-1).view(np.uint8), err_msg=path)
    # the FSDP world's checkpoint restores into a world of 1 bit for bit
    arrays = runs["spec"]["ckpt_arrays"]
    template = {"params": _to_torch(arrays["params"]),
                "opt_state": AdamState(torch.tensor(0, dtype=torch.int32),
                                       _to_torch(arrays["m"]),
                                       _to_torch(arrays["v"]))}
    restored, meta = ckpt.restore_checkpoint(fsdp, template)
    assert meta["step"] == CKPT_STEP
    for name, tree in (("params", restored["params"]),
                       ("m", restored["opt_state"].m),
                       ("v", restored["opt_state"].v)):
        want = dict(iter_leaves(arrays[name]))
        for path, t in iter_leaves(tree):
            np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                          want[path].view(np.uint32),
                                          err_msg=f"{name}/{path}")


# --------------------------------------------------------------------------
# Mamba-2 tensor parallelism
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MAMBA_TP_CASES))
def test_mamba_tensor_parallel_prefill_and_decode_equal_one_rank(runs, name):
    i = list(MAMBA_TP_CASES).index(name)
    cfg = mamba_tp_config(name, reduce_config, get_config)
    got = runs["ranks"][0][f"mamba {name}"]
    for rank in runs["ranks"][1:]:
        assert torch.equal(rank[f"mamba {name}"]["logits"], got["logits"])
    # 16 heads split over model 2; 15 replicated by the fallback
    assert got["heads_split"] == (2 if cfg.mamba_heads % 2 == 0 else 1)
    model = Model(cfg, device="cpu")
    params = model_params_from_arrays(numpy_params(cfg, seed=320 + i), cfg,
                                      device="cpu")
    toks = torch.from_numpy(tokens(cfg, MAMBA_ROWS, MAMBA_SEQ,
                                   seed=330 + i))
    cache = model.init_cache(MAMBA_ROWS, MAMBA_SEQ + MAMBA_DECODE_STEPS)
    with torch.no_grad():
        cache, last = model.prefill(params, {"tokens": toks}, cache)
        steps = [last]
        for t in range(MAMBA_DECODE_STEPS):
            # the sharded run's greedy tokens (teacher-forced)
            feed = got["logits"][:, t, :cfg.vocab_size].argmax(-1)[:, None]
            cache, last = model.decode_step(params, feed, cache,
                                            MAMBA_SEQ + t)
            steps.append(last)
    want = torch.cat(steps, dim=1)
    v = cfg.vocab_size
    assert got["logits"].shape == want.shape
    for t in range(MAMBA_DECODE_STEPS + 1):
        assert _rel(got["logits"][:, t, :v], want[:, t, :v]) <= REL, t
        # the greedy tokens the decode fed are one rank's too
        assert torch.equal(got["logits"][:, t, :v].argmax(-1),
                           want[:, t, :v].argmax(-1)), t
    for layer, state in cache.items():
        for field, leaf in zip(state._fields, state):
            path = f"{layer}/{field}"
            assert got["cache"][path].shape == leaf.shape, path
            assert _rel(got["cache"][path], leaf) <= REL, path
