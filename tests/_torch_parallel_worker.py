"""The rank side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_train.py``: one gloo world of CPU ranks runs
every case of a job on a ("data", "model") mesh, and each rank saves what
it got (outputs gathered whole, gradients summed over the data group and
gathered).  Imports torch and the port only (the spawned ranks never load
JAX).

Jobs: ``layers`` (a world of 8, mesh 2 × 4: the MoE modes and the einsum
path's work split, context parallelism, the compressed reduction), ``model`` (a world of 4, mesh
2 × 2: whole reduced models), ``train`` (a world of 4: the training loop
restored from a checkpoint, the two launchers), ``fsdp`` (a world of 4,
meshes data 2 × model 2 and pod 2 × data 2 × model 1: the FSDP layout's
blocks, train step and checkpoints, Mamba-2 tensor parallelism).
"""
from __future__ import annotations

import dataclasses
import pathlib

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.collectives import record_traffic
from repro_torch.launch.mesh import _mesh, make_elastic_mesh
from repro_torch.models import Model
from repro_torch.models import moe as moe_lib
from repro_torch.models.api import iter_leaves, param_shapes, param_specs
from repro_torch.parallel import compression
from repro_torch.parallel import context_parallel as cp
from repro_torch.parallel.sharding import (gather_params, make_sharder,
                                           shard_params)
from repro_torch.train.loop import (TrainLoop, TrainLoopConfig, TrainState,
                                    data_parallel_sum, make_grad_accum_loss,
                                    make_train_step, value_and_grad)
from repro_torch.train.optimizer import AdamW, constant_schedule, tree_map

GRANITE = "granite-moe-3b-a800m"
# whole reduced models: (arch, config fields replaced)
MODEL_CASES = {
    "smollm-360m": ("smollm-360m", {}),
    "granite-moe-3b-a800m": (GRANITE, {}),
    "gemma2-2b": ("gemma2-2b", {}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}),
    # 3 q heads on 1 KV head: both replicated by the fallback at model 2
    "smollm heads 3/1": ("smollm-360m", {"num_heads": 3, "num_kv_heads": 1}),
    # 4 q heads split, 1 KV head replicated: the GQA group cut
    "smollm heads 4/1": ("smollm-360m", {"num_heads": 4, "num_kv_heads": 1}),
}
DECODE_STEPS = 4
# the cases whose sharded run is also held to one device in float64: the
# Mamba layers' head split sums in another order than one device does, and
# reduced mamba2-2.7b's float32 gradients lie 2.2e-5 of their largest |g|
# from float64 on one device already
FLOAT64_TWINS = ("mamba2-2.7b",)


def moe_base(pkg_reduce, pkg_get):
    """The MoE layer config of ``tests/test_moe_sharded.py`` (no drops)."""
    return dataclasses.replace(
        pkg_reduce(pkg_get(GRANITE)), d_model=32, d_ff=64, num_experts=4,
        num_experts_per_token=2, moe_capacity_factor=8.0)


# the capacity-slot split of the JAX layout sweep (``v_capshard`` of
# benchmarks/hillclimb.py) with the experts replicated, so that no mesh
# axis is mapped twice where E divides the model axis
CAPSHARD = (("experts", None), ("expert_ffn", None), ("moe_cap", "model"))
# the einsum path's cases on the mesh 2 x 4 whose work split is measured:
# (config fields replaced on moe_base, the rows of x taken)
EINSUM_CASES = {
    "moe gspmd": ({"moe_impl": "gspmd"}, 4),
    "moe gspmd capshard": ({"moe_impl": "gspmd",
                            "sharding_overrides": CAPSHARD}, 4),
    # 6 experts do not divide model 4: expert_ffn goes over model
    "moe gspmd e6": ({"moe_impl": "gspmd", "num_experts": 6}, 4),
    # one row does not split over data 2: ep falls back to the einsum path
    "moe batch 1": ({"moe_impl": "ep"}, 1),
}


def model_config(name: str, pkg_reduce, pkg_get):
    arch, fields = MODEL_CASES[name]
    return dataclasses.replace(pkg_reduce(pkg_get(arch)), **fields)


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(a).clone(), tree)


# -- job "layers" -------------------------------------------------------------

def _moe_case(mesh, cfg, params_np, x_np, grads: bool = True):
    """One moe_layer call on the FSDP-gathered blocks, as a model's block
    makes it: (out whole, aux, grads of sum(out²) + aux loss summed over
    the data group and gathered, and of the moe_layer call this rank's
    collectives by kind and its flops by op); x in ``cfg.dtype``; without
    ``grads`` the whole output alone.  With no mesh, one device's run."""
    from torch.utils.flop_counter import FlopCounterMode

    sharder = make_sharder(cfg, mesh)
    defs = moe_lib.moe_defs(cfg)
    specs = param_specs(defs)
    params = tree_map(lambda t: t.requires_grad_(grads),
                      shard_params(_tensors(params_np), sharder, specs))
    x = torch.from_numpy(x_np).to(cfg.dtype)
    rows = x.shape[0]
    gathered = sharder.fsdp_gather(params, defs, rows)
    counter = FlopCounterMode(display=False)
    with record_traffic() as traffic, counter:
        out, aux = moe_lib.moe_layer(gathered,
                                     sharder.local(x, ("batch", None, None)),
                                     cfg, sharder, batch=rows)
    if not grads:
        return {"out": sharder.gather(out.detach(), ("batch", None, None),
                                      x.shape)}
    loss = out.square().sum() + aux["moe_aux_loss"]
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[n]
                                                        for n in names])))
    grads = {n: _sum(g, sharder.grad_sum_groups(defs[n].axes, defs[n].shape,
                                                rows))
             for n, g in grads.items()}
    grads = gather_params(grads, sharder, specs, param_shapes(defs,
                                                              torch.float32))
    whole = sharder.gather(out.detach(), ("batch", None, None), x.shape)
    return {"out": whole, "grads": grads,
            "aux": {k: float(v) for k, v in aux.items()},
            "traffic": {k: dict(v) for k, v in traffic.items()},
            "flops": {str(op): int(n) for op, n
                      in counter.get_flop_counts()["Global"].items()}}


def _sum(t, groups):
    """``t`` summed over ``groups``."""
    t = t.clone()
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _layers(spec) -> dict:
    mesh = make_elastic_mesh(model_parallel=4, device="cpu")
    out = {}
    base = moe_base(reduce_config, get_config)
    for impl in ("ep", "cap", "ffn", "gspmd"):
        out[f"moe {impl}"] = _moe_case(
            mesh, dataclasses.replace(base, moe_impl=impl), spec["moe_params"],
            spec["moe_x"])
    # the compute dtype of the full-size configs: the reductions in bf16
    for impl in ("ep", "cap", "ffn", "gspmd"):
        out[f"moe bf16 {impl}"] = _moe_case(
            mesh, dataclasses.replace(base, moe_impl=impl,
                                      dtype=torch.bfloat16),
            spec["moe_params"], spec["moe_x"], grads=False)
    out["einsum bf16"] = _moe_case(
        None, dataclasses.replace(base, dtype=torch.bfloat16),
        spec["moe_params"], spec["moe_x"], grads=False)
    out["moe bf16 gspmd capshard"] = _moe_case(
        mesh, dataclasses.replace(base, dtype=torch.bfloat16,
                                  **EINSUM_CASES["moe gspmd capshard"][0]),
        spec["moe_params"], spec["moe_x"], grads=False)
    # the einsum path's work split as the JAX constraints resolve ("moe
    # gspmd" above: the experts over model)
    for key, (fields, rows) in EINSUM_CASES.items():
        if key == "moe gspmd":
            continue
        cfg = dataclasses.replace(base, **fields)
        params = spec["moe6_params" if cfg.num_experts == 6 else "moe_params"]
        out[key] = _moe_case(mesh, cfg, params, spec["moe_x"][:rows])
    # dispatch groups of 4 rows shrink to 2 (so that they split over data
    # 2); capacity factor 1.0: drops, which depend on the groups
    out["moe group shrink"] = _moe_case(
        mesh, dataclasses.replace(base, moe_impl="ep", moe_group_rows=4,
                                  moe_capacity_factor=1.0),
        spec["moe_params"], spec["moe_x"])

    # context parallelism: batch over data, sequence over model
    sharder = make_sharder(base, mesh)
    group = mesh.get_group("model")
    axes = ("batch", None, "seq_shard", None)
    q, k, v = (torch.from_numpy(spec[n]) for n in ("cp_q", "cp_k", "cp_v"))
    ql, kl, vl = (sharder.local(t, axes) for t in (q, k, v))
    for name, kwargs in spec["cp_cases"].items():
        if kwargs.get("window"):
            o = cp.halo_window_attention(ql, kl, vl, group=group, **kwargs)
        else:
            o = cp.ring_attention(ql, kl, vl, group=group, **kwargs)
        out[f"cp {name}"] = sharder.gather(o, axes, q.shape)

    # compressed all-reduce over the model axis
    d, m = sharder.coordinate("data"), sharder.coordinate("model")
    g = torch.from_numpy(spec["comp_g"][d, m])
    e = torch.from_numpy(spec["comp_err"][d, m])
    mean, new_err = compression.compressed_psum(g, group, e)
    tree_mean, tree_err = compression.compressed_psum_tree(
        {"a": g.reshape(4, -1), "b": {"c": g[:300]}}, group,
        compression.init_errors({"a": g.reshape(4, -1), "b": {"c": g[:300]}}))
    out["compression"] = {"coord": (d, m), "mean": mean, "new_error": new_err,
                          "tree_mean": tree_mean, "tree_err": tree_err}
    return out


# -- job "model" ----------------------------------------------------------------

def _model_case(mesh, name, spec, dtype=None) -> dict:
    cfg = model_config(name, reduce_config, get_config)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    sharder = make_sharder(cfg, mesh)
    model = Model(cfg, sharder=sharder, device="cpu")
    whole = model_params_from_arrays(spec["params"][name], cfg, device="cpu")
    params = shard_params(whole, sharder, model.specs())
    del whole
    b = spec["batches"][name]
    batch = {k: torch.from_numpy(a) for k, a in b.items()}
    rows, seq = batch["tokens"].shape
    res = {}
    with torch.no_grad():
        logits = model.forward(params, batch)
        res["forward"] = sharder.gather(
            logits, ("batch", None, "vocab"),
            (rows, logits.shape[1], cfg.padded_vocab))
        prompt = {k: t for k, t in batch.items()
                  if k in ("tokens", "frame_embeds")}
        cache = model.init_cache(rows, seq + DECODE_STEPS + 4)
        cache, last = model.prefill(params, prompt, cache)
        steps = [last]
        enc = model._encode(params, prompt) if cfg.is_encoder_decoder \
            else None
        feed = torch.from_numpy(spec["decode_tokens"][name])
        for t in range(DECODE_STEPS):
            cache, last = model.decode_step(params, feed[:, t:t + 1], cache,
                                            seq + t, enc)
            steps.append(last)
        res["decode"] = torch.cat(steps, dim=1)
    (loss, aux), grads = value_and_grad(model, params, batch)
    res["loss"] = float(loss)
    res["aux"] = {k: float(v) for k, v in aux.items()}
    grads = data_parallel_sum(grads, model, rows)
    res["grads"] = gather_params(grads, sharder, model.specs(),
                                 param_shapes(model.defs(), cfg.param_dtype))
    return res


def _model(spec) -> dict:
    mesh = make_elastic_mesh(model_parallel=2, device="cpu")
    out = {name: _model_case(mesh, name, spec) for name in MODEL_CASES}
    for name in FLOAT64_TWINS:
        out[f"{name} float64"] = _model_case(mesh, name, spec, torch.float64)
    return out


# -- job "train" ----------------------------------------------------------------

class Batches:
    """The same numpy batches to either package's loop."""

    def __init__(self, batches, convert):
        self.batches, self.convert = batches, convert

    def batch(self, step):
        return self.convert(self.batches[step])


def _train(spec) -> dict:
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    mesh = make_elastic_mesh(model_parallel=2, device="cpu")
    cfg = reduce_config(get_config("smollm-360m"))
    model = Model(cfg, sharder=make_sharder(cfg, mesh), device="cpu")
    loop = TrainLoop(
        model, AdamW(constant_schedule(1e-2), moment_dtype=torch.float32),
        Batches(spec["train_batches"],
                lambda b: {k: torch.from_numpy(a) for k, a in b.items()}),
        TrainLoopConfig(checkpoint_dir=spec["train_dir"], **spec["loop"]))
    final = loop.run(0)
    loop.close()
    out = {"losses": [h["loss"] for h in loop.history],
           "grad_norms": [h["grad_norm"] for h in loop.history],
           "step": final.step}
    launched = train_launcher.main(spec["train_argv"])
    out["launcher_losses"] = [h["loss"] for h in launched.history]
    results = serve_launcher.main(spec["serve_argv"])
    out["serve_tokens"] = {rid: r.tokens for rid, r in results.items()}
    return out


# -- job "fsdp" -----------------------------------------------------------------

FSDP_MESHES = {"data 2 x model 2": ((2, 2), ("data", "model")),
               "pod 2 x data 2 x model 1": ((2, 2, 1),
                                            ("pod", "data", "model"))}
# the train step's archs: attention alone, and attention, Mamba and MoE
FSDP_ARCHS = ("smollm-360m", "jamba-1.5-large-398b")
FSDP_LR = 1e-2
FSDP_MICROBATCHES = 2
# reduced mamba2-2.7b: 16 heads split over model 2, and 15 heads (d_model
# 60) that the divisibility fallback replicates
MAMBA_TP_CASES = {"heads 16": {}, "heads 15": {"d_model": 60}}
MAMBA_DECODE_STEPS = 2


def fsdp_config(arch: str, pkg_reduce, pkg_get, dtype=None):
    cfg = pkg_reduce(pkg_get(arch))
    return cfg if dtype is None else dataclasses.replace(
        cfg, dtype=dtype, param_dtype=dtype)


def mamba_tp_config(name: str, pkg_reduce, pkg_get):
    return dataclasses.replace(pkg_reduce(pkg_get("mamba2-2.7b")),
                               **MAMBA_TP_CASES[name])


def fsdp_optimizer(dtype):
    return AdamW(constant_schedule(FSDP_LR), moment_dtype=dtype)


def _shapes(tree) -> dict:
    return {p: tuple(t.shape) for p, t in iter_leaves(tree)}


def _cache_leaves(cache) -> dict:
    return {f"{name}/{field}": leaf for name, state in cache.items()
            for field, leaf in zip(state._fields, state)}


def _fsdp_step(mesh, arch: str, spec) -> dict:
    """One train step of ``FSDP_MICROBATCHES`` microbatches: this rank's
    block shapes, the loss, the gradients (summed and gathered), the local
    gradient blocks of the leaves replicated over the model axis, the
    traffic by kind, and the updated parameters and moments (gathered)."""
    dtype = spec["dtype"]
    cfg = fsdp_config(arch, reduce_config, get_config, dtype)
    sharder = make_sharder(cfg, mesh)
    model = Model(cfg, sharder=sharder, device="cpu")
    specs, defs = model.specs(), model.defs()
    params = shard_params(model_params_from_arrays(
        spec["params"][arch], cfg, device="cpu"), sharder, specs)
    opt = fsdp_optimizer(dtype)
    state = opt.init(params)
    batch = {k: torch.from_numpy(a) for k, a in spec["batches"][arch].items()}
    rows = batch["tokens"].shape[0]
    names = mesh.mesh_dim_names
    res = {"coord": {a: sharder.coordinate(a) for a in names},
           "blocks": {"params": _shapes(params), "opt": _shapes(state.m),
                      "cache": {p: tuple(t.shape) for p, t in _cache_leaves(
                          model.init_cache(rows, spec["cache_len"])).items()}}}
    with record_traffic() as traffic:
        (loss, _), grads = make_grad_accum_loss(model, FSDP_MICROBATCHES)(
            params, batch)
    res["traffic"] = {k: dict(v) for k, v in traffic.items()}
    grads = data_parallel_sum(grads, model, rows // FSDP_MICROBATCHES)
    res["loss"] = float(loss)
    leaf_defs = dict(iter_leaves(defs))
    res["replicated"] = {
        p: g.clone() for p, g in iter_leaves(grads)
        if not any("model" in s.axes for s in sharder.layout(
            leaf_defs[p].axes, leaf_defs[p].shape))}
    shapes = param_shapes(defs, dtype)
    res["grads"] = gather_params(grads, sharder, specs, shapes)
    params, state, metrics = make_train_step(model, opt, FSDP_MICROBATCHES)(
        params, state, batch)
    res["grad_norm"] = float(metrics["grad_norm"])
    res["params"] = gather_params(params, sharder, specs, shapes)
    res["m"] = gather_params(state.m, sharder, specs, shapes)
    return res


def _mamba_tp(mesh, name: str, spec) -> dict:
    """Prefill and ``MAMBA_DECODE_STEPS`` decode steps of a reduced
    mamba2-2.7b case: the logits a step and the gathered caches."""
    cfg = mamba_tp_config(name, reduce_config, get_config)
    sharder = make_sharder(cfg, mesh)
    model = Model(cfg, sharder=sharder, device="cpu")
    params = shard_params(model_params_from_arrays(
        spec["mamba_params"][name], cfg, device="cpu"), sharder, model.specs())
    toks = torch.from_numpy(spec["mamba_tokens"][name])
    rows, seq = toks.shape
    max_len = seq + MAMBA_DECODE_STEPS
    cache = model.init_cache(rows, max_len)
    with torch.no_grad():
        cache, last = model.prefill(params, {"tokens": toks}, cache)
        steps = [last]
        for t in range(MAMBA_DECODE_STEPS):
            cache, last = model.decode_step(
                params, last[..., :cfg.vocab_size].argmax(-1), cache, seq + t)
            steps.append(last)
    whole = _cache_leaves(Model(cfg, device="meta").init_cache(rows,
                                                               max_len))
    axes = _cache_leaves(model.cache_spec_axes())
    return {"logits": torch.cat(steps, dim=1),
            "heads_split": sharder.split("mamba_heads",
                                         cfg.mamba_heads).size,
            "cache": {p: sharder.gather(t, axes[p], whole[p].shape)
                      for p, t in _cache_leaves(cache).items()}}


def _fsdp_checkpoint(mesh, spec) -> dict:
    """A world of 1's checkpoint (written by the test) restored into the
    FSDP layout, each rank's blocks against ``shard_params`` of its arrays
    bit for bit, then saved again from the FSDP world (rank 0 writes the
    gathered arrays)."""
    dtype = spec["dtype"]
    cfg = fsdp_config("smollm-360m", reduce_config, get_config, dtype)
    sharder = make_sharder(cfg, mesh)
    model = Model(cfg, sharder=sharder, device="cpu")
    opt = fsdp_optimizer(dtype)
    params = model.init(torch.Generator().manual_seed(0))
    template = TrainState(params, opt.init(params), 0)
    loop = TrainLoop(model, opt, None, TrainLoopConfig(
        total_steps=0, checkpoint_dir=spec["ckpt_in"],
        async_checkpoint=False))
    state = loop._restore(template)
    loop.close()
    want = spec["ckpt_arrays"]
    same = True
    for tree, name in ((state.params, "params"), (state.opt_state.m, "m"),
                       (state.opt_state.v, "v")):
        expect = dict(iter_leaves(shard_params(_tensors(want[name]), sharder,
                                               model.specs())))
        same = same and all(torch.equal(a.view(torch.uint8),
                                        expect[p].view(torch.uint8))
                            for p, a in iter_leaves(tree))
    out = TrainLoop(model, opt, None, TrainLoopConfig(
        total_steps=0, checkpoint_dir=spec["ckpt_out"],
        async_checkpoint=False))
    out._save(state)
    out.close()
    return {"step": state.step, "restored_bitwise": bool(same)}


def _fsdp(spec) -> dict:
    out = {}
    for mesh_name, (sizes, names) in FSDP_MESHES.items():
        mesh = _mesh(range(4), sizes, names, "cpu")
        for arch in FSDP_ARCHS:
            out[f"{mesh_name}/{arch}"] = _fsdp_step(mesh, arch, spec)
    mesh = make_elastic_mesh(model_parallel=2, device="cpu")
    for name in MAMBA_TP_CASES:
        out[f"mamba {name}"] = _mamba_tp(mesh, name, spec)
    out["checkpoint"] = _fsdp_checkpoint(mesh, spec)
    return out


JOBS = {"layers": _layers, "model": _model, "train": _train, "fsdp": _fsdp}


def run_world(rank: int, world: int, init_file: str, job: str, spec: dict,
              out_dir: str) -> None:
    """One rank: join the gloo world, run the job's cases, save them."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        results = JOBS[job](spec)
        torch.save(results, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
