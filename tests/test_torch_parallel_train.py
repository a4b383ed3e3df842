"""Training under model-side parallelism, against the JAX package on the
CPU, in a gloo world of 4 CPU ranks (mesh data 2 × model 2,
``tests/_torch_parallel_worker.py``, spawned once for the module).

* The ``TrainLoop`` of a sharded reduced smollm-360m (``heads`` 6/2 and
  ``ffn`` split, the vocab split) resumes from a step-0 checkpoint that
  the JAX package wrote (each rank cuts its blocks from the gathered
  arrays) and runs 2 steps of 2 microbatches on the batches the JAX loop
  gets: losses, moments and the parameters of the step-2 checkpoint
  (gathered, written by rank 0) equal the JAX loop's (a parameter whose
  first gradient is at noise level, below 1e3 · AdamW's eps, within the
  2 · lr that AdamW's first update g / (|g| + eps) can move it).
* That checkpoint has the layout a world of 1 writes, restores in a world
  of 1 bit for bit and, saved again there, restores into the JAX package.
* ``launch.train --tp 2 --distributed --device cpu`` and ``launch.serve
  --tp 2`` run in the world of 4 and repeat a world of 1's losses and
  greedy tokens.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.train import checkpoint as jckpt
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.optimizer import AdamW as JaxAdamW
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.api import iter_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamW, constant_schedule
from _torch_model_parity import reduced_pair
from _torch_parallel_worker import Batches, run_world
from test_torch_parallel import model_batch

jax.config.update("jax_platform_name", "cpu")

STEPS = 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_torch_train.py
# the moments within this share of each leaf's largest |moment|
# (test_torch_train.py's GRAD_TOL): the second gradient is taken at
# parameters that the first update's noisy entries already moved
MOMENT_REL = 1e-4
LR = 1e-2
NOISY_GRAD = 1e3 * 1e-8    # 1e3 · AdamW's eps
LOOP = dict(total_steps=STEPS, checkpoint_every=STEPS, log_every=1,
            microbatches=2, async_checkpoint=False)


def _argv(tmp, name, tp):
    train = ["--arch", "smollm-360m", "--reduced", "--steps", str(STEPS),
             "--batch", "4", "--seq", "64", "--microbatches", "2",
             "--ckpt-every", "1", "--device", "cpu",
             "--ckpt-dir", str(tmp / name)]
    serve = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
             "--prompt-len", "64", "--max-len", "96", "--max-new", "4"]
    if tp:
        train += ["--tp", "2", "--distributed"]
        serve += ["--tp", "2"]
    return train, serve


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_train")
    cfg, _, _, jm, jp = reduced_pair("smollm-360m", seed=7)
    batches = [model_batch(cfg, seed=90 + i) for i in range(STEPS)]
    jopt = JaxAdamW(lambda s: jnp.asarray(LR, jnp.float32),
                    moment_dtype=jnp.float32)
    jckpt.save_checkpoint(tmp / "jax", 0,
                          {"params": jp, "opt_state": jopt.init(jp)},
                          {"step": 0})
    shutil.copytree(tmp / "jax", tmp / "port")
    jloop = JaxTrainLoop(jm, jopt, Batches(batches, lambda b: {
        k: jnp.asarray(v) for k, v in b.items()}),
        JaxTrainLoopConfig(checkpoint_dir=str(tmp / "jax"), **LOOP))
    jfinal = jloop.run(jax.random.PRNGKey(0))
    # the first step's gradient (two microbatches, averaged)
    first = [jax.grad(lambda p, b: jm.loss(p, b)[0])(
        jp, {k: jnp.asarray(v[i * 2:(i + 1) * 2])
             for k, v in batches[0].items()}) for i in range(2)]
    g1 = jax.tree.map(lambda a, b: (np.asarray(a) + np.asarray(b)) / 2,
                      *first)
    jax_run = {"losses": [h["loss"] for h in jloop.history],
               "params": {p: np.asarray(v)
                          for p, v in iter_leaves(jfinal.params)},
               "v": {p: np.asarray(v)
                     for p, v in iter_leaves(jfinal.opt_state.v)},
               "m": {p: np.asarray(v)
                     for p, v in iter_leaves(jfinal.opt_state.m)},
               "g1": dict(iter_leaves(g1))}

    train1, serve1 = _argv(tmp, "launch1", tp=False)
    loop1 = train_launcher.main(train1)
    single = {"losses": [h["loss"] for h in loop1.history],
              "tokens": {rid: r.tokens for rid, r in
                         serve_launcher.main(serve1).items()}}

    train4, serve4 = _argv(tmp, "launch4", tp=True)
    spec = {"train_batches": batches, "train_dir": str(tmp / "port"),
            "loop": LOOP, "train_argv": train4, "serve_argv": serve4}
    out = tmp / "world4"
    out.mkdir()
    mp.start_processes(run_world, args=(4, str(out / "init"), "train", spec,
                                        str(out)),
                       nprocs=4, join=True, start_method="spawn")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return {"tmp": tmp, "jax": jax_run, "single": single, "ranks": ranks,
            "cfg": cfg}


def test_sharded_train_loop_equals_jax(runs):
    ranks, want = runs["ranks"], runs["jax"]
    assert all(r["step"] == STEPS for r in ranks)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert r["grad_norms"] == ranks[0]["grad_norms"]
    assert len(ranks[0]["losses"]) == len(want["losses"]) == STEPS
    np.testing.assert_allclose(ranks[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    path = ckpt.latest_checkpoint(runs["tmp"] / "port")
    assert ckpt.checkpoint_step(path) == STEPS
    with np.load(path / "arrays.npz") as z:
        meta = json.loads((path / "meta.json").read_text())
        arrays = {p: z[f"a{i}"] for i, p in enumerate(meta["paths"])}
    for p, v in want["params"].items():
        got = arrays[f"params/{p}"]
        for moment in ("m", "v"):
            mine, theirs = arrays[f"opt_state/.{moment}/{p}"], want[moment][p]
            assert np.abs(mine - theirs).max() \
                <= MOMENT_REL * np.abs(theirs).max(), (moment, p)
        # where the first gradient is at noise level (0 < |g| < 1e3 ·
        # AdamW's eps) the first update g / (|g| + eps) is set by that
        # noise and may move a parameter by up to 2 · lr
        g1 = np.abs(want["g1"][p])
        noisy = (g1 < NOISY_GRAD) & (g1 > 0)
        assert noisy.sum() <= 0.05 * (g1 > 0).sum(), p
        np.testing.assert_allclose(got[~noisy], v[~noisy], **PARAM_TOL,
                                   err_msg=p)
        assert (np.abs(got - v)[noisy] <= 2 * LR + PARAM_TOL["atol"]).all()


def _layout(path):
    meta = json.loads((path / "meta.json").read_text())
    return meta["paths"], meta["shapes"], meta["dtypes"]


def test_checkpoint_round_trips_world_4_to_world_1_to_jax(runs):
    tmp, cfg = runs["tmp"], runs["cfg"]
    four = ckpt.latest_checkpoint(tmp / "launch4")
    one = ckpt.latest_checkpoint(tmp / "launch1")
    assert ckpt.checkpoint_step(four) == ckpt.checkpoint_step(one) == STEPS
    assert _layout(four) == _layout(one)
    # restore in a world of 1: the gathered arrays bit for bit
    _, model, params, _, _ = reduced_pair("smollm-360m", seed=7)
    opt = AdamW(constant_schedule(1e-2))         # the launcher's moments
    template = {"params": params, "opt_state": opt.init(params)}
    restored, meta = ckpt.restore_checkpoint(four, template)
    assert meta["step"] == STEPS
    with np.load(four / "arrays.npz") as z:
        saved = {p: z[f"a{i}"] for i, p in
                 enumerate(json.loads((four / "meta.json").read_text())
                           ["paths"])}
    host = ckpt.host_copy(restored)
    assert [p for p, _ in host] == list(saved)
    for p, (arr, _) in host:
        np.testing.assert_array_equal(arr.reshape(-1).view(np.uint8),
                                      saved[p].reshape(-1).view(np.uint8),
                                      err_msg=p)
    # saved again by the world of 1, restored by the JAX package
    ckpt.save_checkpoint(tmp / "again", STEPS, restored, {"step": STEPS})
    jtemplate = jax.tree.map(lambda t: jnp.zeros(t.shape, jnp.float32),
                             {"params": params})
    jrestored, _ = jckpt.restore_checkpoint(
        ckpt.latest_checkpoint(tmp / "again"),
        {"params": jtemplate["params"]})
    for p, t in iter_leaves(restored["params"]):
        got = dict(iter_leaves(jrestored["params"]))[p]
        np.testing.assert_array_equal(np.asarray(got), t.numpy(), err_msg=p)
    assert cfg.param_count() == sum(t.numel() for _, t in
                                    iter_leaves(restored["params"]))


def test_launchers_in_a_world_of_4_repeat_a_world_of_1(runs):
    ranks, single = runs["ranks"], runs["single"]
    for r in ranks:
        assert len(r["launcher_losses"]) == STEPS
        np.testing.assert_allclose(r["launcher_losses"], single["losses"],
                                   rtol=LOSS_RTOL)
        assert r["serve_tokens"] == single["tokens"]
    assert all(len(t) == 4 for t in single["tokens"].values())
