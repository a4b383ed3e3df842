"""The rank side of ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_train.py``: one gloo world of CPU ranks runs
every case of a job on a ("data", "model") mesh, and each rank saves what
it got (outputs gathered whole, gradients summed over the data group and
gathered).  Imports torch and the port only (the spawned ranks never load
JAX).

Jobs: ``layers`` (a world of 8, mesh 2 × 4: the MoE modes, context
parallelism, the compressed reduction), ``model`` (a world of 4, mesh
2 × 2: whole reduced models), ``train`` (a world of 4: the training loop
restored from a checkpoint, the two launchers).
"""
from __future__ import annotations

import dataclasses
import pathlib

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import Model
from repro_torch.models import moe as moe_lib
from repro_torch.models.api import param_shapes, param_specs
from repro_torch.parallel import compression
from repro_torch.parallel import context_parallel as cp
from repro_torch.parallel.sharding import (gather_params, make_sharder,
                                           shard_params)
from repro_torch.train.loop import (TrainLoop, TrainLoopConfig,
                                    data_parallel_sum, value_and_grad)
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


def moe_base(pkg_reduce, pkg_get):
    """The MoE layer config of ``tests/test_moe_sharded.py`` (no drops)."""
    return dataclasses.replace(
        pkg_reduce(pkg_get(GRANITE)), d_model=32, d_ff=64, num_experts=4,
        num_experts_per_token=2, moe_capacity_factor=8.0)


def model_config(name: str, pkg_reduce, pkg_get):
    arch, fields = MODEL_CASES[name]
    return dataclasses.replace(pkg_reduce(pkg_get(arch)), **fields)


def _tensors(tree):
    return tree_map(lambda a: torch.from_numpy(a).clone(), tree)


# -- job "layers" -------------------------------------------------------------

def _moe_case(mesh, cfg, params_np, x_np, grads: bool = True):
    """One moe_layer call: (out whole, aux, grads of sum(out²) + aux loss
    summed over the data group and gathered); x in ``cfg.dtype``; without
    ``grads`` the whole output alone."""
    sharder = make_sharder(cfg, mesh)
    defs = moe_lib.moe_defs(cfg)
    specs = param_specs(defs)
    params = tree_map(lambda t: t.requires_grad_(grads),
                      shard_params(_tensors(params_np), sharder, specs))
    x = torch.from_numpy(x_np).to(cfg.dtype)
    rows = x.shape[0]
    out, aux = moe_lib.moe_layer(params, sharder.local(x, ("batch", None,
                                                           None)),
                                 cfg, sharder, batch=rows)
    if not grads:
        return {"out": sharder.gather(out.detach(), ("batch", None, None),
                                      x.shape)}
    loss = out.square().sum() + aux["moe_aux_loss"]
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[n]
                                                        for n in names])))
    groups = sharder.groups(sharder.split("batch", rows).axes)
    grads = {n: _sum(g, groups) for n, g in grads.items()}
    grads = gather_params(grads, sharder, specs, param_shapes(defs,
                                                              torch.float32))
    whole = sharder.gather(out.detach(), ("batch", None, None), x.shape)
    return {"out": whole, "grads": grads,
            "aux": {k: float(v) for k, v in aux.items()}}


def _sum(t, groups):
    """``t`` summed over ``groups`` (the data group: each data rank holds
    its rows' share of the gradient)."""
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
    # a batch of 1 row does not split over data 2: ep falls back to the
    # einsum path, every rank computing the whole batch
    out["moe batch 1"] = _moe_case(
        mesh, dataclasses.replace(base, moe_impl="ep"), spec["moe_params"],
        spec["moe_x"][:1])
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

def _model_case(mesh, name, spec) -> dict:
    cfg = model_config(name, reduce_config, get_config)
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
                                 param_shapes(model.defs(), torch.float32))
    return res


def _model(spec) -> dict:
    mesh = make_elastic_mesh(model_parallel=2, device="cpu")
    return {name: _model_case(mesh, name, spec) for name in MODEL_CASES}


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


JOBS = {"layers": _layers, "model": _model, "train": _train}


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
