"""The training loop: microbatching, metrics, straggler monitoring,
checkpoint/restart and crash recovery.

The port of the JAX package's ``repro/train/loop.py``:

* **Checkpoint/restart** — full state (params, optimizer, step) through
  :class:`~repro_torch.train.checkpoint.CheckpointManager`; the data
  pipeline is stateless per step, so the step counter is the whole data
  cursor.  :meth:`TrainLoop.run` resumes from the latest checkpoint, and
  recovery is bitwise deterministic on a deterministic device.
* **Crash recovery** — a step that raises (a lost device, an injected
  fault) restores the latest checkpoint (or the initial state) and goes
  on; at most ``max_recoveries`` times.
* **Straggler monitoring** — per-step wall time; steps slower than
  ``mean + straggler_sigma · std`` of the earlier ones are logged.
* **Gradient accumulation** — the batch splits into microbatches whose
  gradients are summed in float32, in order, and averaged.

The step runs eagerly (no ``torch.compile``): the loss and its gradient
by autograd, then AdamW's update written into the parameters in place.

Under a mesh (a model with a sharder) every rank draws the same global
batch and the model keeps its rows; each rank's loss is the global
mean, so its gradient holds its own rows' share: after the microbatch
accumulation the gradients are summed over the batch's data group (every
leaf is replicated over the batch axes at run time), the global norm
all-reduces the squares of split leaves (:func:`~repro_torch.train.
optimizer.global_norm`), and checkpoints hold the gathered arrays, in the
JAX layout, written by rank 0; a restore cuts each rank's blocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.api import param_shapes
from repro_torch.models.transformer import Model
from repro_torch.parallel.collectives import all_reduce_sum
from repro_torch.parallel.sharding import gather_params, shard_params
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import (AdamState, AdamW, apply_updates,
                                         global_norm, tree_leaves, tree_map)


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 100
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    log_every: int = 10
    microbatches: int = 1
    straggler_sigma: float = 3.0
    max_recoveries: int = 3
    async_checkpoint: bool = True


class StragglerMonitor:
    """Step-time monitor; flags steps at or above mean + kσ."""

    def __init__(self, sigma: float, warmup: int = 5):
        self.sigma = sigma
        self.warmup = warmup
        self.times: List[float] = []
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        hist = self.times[:-1][-100:]
        mean = float(np.mean(hist))
        std = float(np.std(hist)) + 1.0e-9
        if dt > mean + self.sigma * std:
            self.flagged.append(step)
            return True
        return False


def value_and_grad(model: Model, params, batch):
    """((loss, aux), grads) of ``model.loss`` at ``params``; the
    gradients are a tree like ``params`` (float32 for float32 params).
    Autograd runs on detached views of the parameters, so the caller's
    tensors are neither marked nor changed."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, aux = model.loss(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return (loss.detach(), {k: a.detach() for k, a in aux.items()}), \
        tree_map(lambda _: next(it), leaves)


def make_grad_accum_loss(model: Model, microbatches: int):
    """``loss_and_grad(params, batch) -> ((loss, aux), grads)`` over
    ``microbatches`` equal slices of the batch's leading axis, in order:
    loss and gradients summed in float32 and averaged, aux from the last
    microbatch (the JAX package's ``lax.scan`` order)."""
    if microbatches == 1:
        return lambda params, batch: value_and_grad(model, params, batch)

    def loss_and_grad(params, batch):
        loss_sum = torch.zeros((), dtype=torch.float32)
        acc = None
        for i in range(microbatches):
            mb = {k: t[i * (t.shape[0] // microbatches):
                       (i + 1) * (t.shape[0] // microbatches)]
                  for k, t in batch.items()}
            (loss, aux), grads = value_and_grad(model, params, mb)
            loss_sum = loss_sum.to(loss.device) + loss
            grads = tree_map(lambda g: g.float(), grads)
            acc = grads if acc is None else tree_map(
                lambda a, g: a.add_(g), acc, grads)
        return (loss_sum / microbatches, aux), \
            tree_map(lambda g: g / microbatches, acc)

    return loss_and_grad


def data_parallel_sum(grads, model: Model, rows: int):
    """``grads`` summed over the data group that splits a (micro)batch of
    ``rows`` rows (``grads`` itself where the batch is not split)."""
    groups = model.sharder.groups(model.sharder.split("batch", rows).axes)
    if not groups:
        return grads
    return tree_map(lambda g: all_reduce_sum(g, groups), grads)


def make_train_step(model: Model, opt: AdamW, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and gradients over ``microbatches`` slices of the
    batch (:func:`make_grad_accum_loss`; under a mesh summed over the data
    group), then one AdamW update written into ``params`` and the moments
    in place; metrics ``loss``, ``ce``, ``moe_aux``, ``moe_z``,
    ``grad_norm`` and ``lr`` (0-d tensors)."""
    loss_and_grad = make_grad_accum_loss(model, microbatches)
    defs = model.defs()

    def train_step(params, opt_state, batch):
        (loss, aux), grads = loss_and_grad(params, batch)
        if model.sharder.mesh is not None:
            grads = data_parallel_sum(
                grads, model, batch["tokens"].shape[0] // microbatches)
        updates, opt_state, om = opt.update(
            grads, opt_state, params,
            global_norm(grads, model.sharder, defs))
        del grads
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **aux, **om}

    return train_step


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


class TrainLoop:
    def __init__(self, model: Model, opt: AdamW, data,
                 cfg: TrainLoopConfig, *,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 metrics_hook: Optional[Callable[[int, Dict], None]] = None):
        self.model = model
        self.opt = opt
        self.data = data
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.metrics_hook = metrics_hook
        self.monitor = StragglerMonitor(cfg.straggler_sigma)
        self.manager = ckpt_lib.CheckpointManager(
            cfg.checkpoint_dir, keep=cfg.keep_checkpoints,
            async_save=cfg.async_checkpoint)
        self.history: List[Dict] = []
        self.train_step = make_train_step(model, opt, cfg.microbatches)
        self.sharded = model.sharder.mesh is not None
        self.writer = not self.sharded or dist.get_rank() == 0

    # -- state ---------------------------------------------------------------
    def init_state(self, seed: int) -> TrainState:
        """Fresh parameters from a generator on the model's device seeded
        with ``seed``, fresh optimizer state, step 0."""
        gen = torch.Generator(self.model.device).manual_seed(seed)
        params = self.model.init(gen)
        return TrainState(params, self.opt.init(params), 0)

    def _global(self, tree, dtype):
        """The gathered arrays of a tree laid out like the parameters
        (collective under a mesh)."""
        if not self.sharded:
            return tree
        defs = self.model.defs()
        return gather_params(tree, self.model.sharder, self.model.specs(),
                             param_shapes(defs, dtype))

    def _save(self, state: TrainState):
        """Checkpoint the gathered state (rank 0 writes it)."""
        opt = state.opt_state
        tree = {"params": self._global(state.params,
                                       self.model.cfg.param_dtype),
                "opt_state": AdamState(opt.step,
                                       self._global(opt.m,
                                                    self.opt.moment_dtype),
                                       self._global(opt.v,
                                                    self.opt.moment_dtype))}
        if self.writer:
            self.manager.save(state.step, tree, metadata={"step": state.step})

    def _restore(self, template: TrainState) -> Optional[TrainState]:
        if not self.sharded:
            latest = self.manager.latest()
            if latest is None:
                return None
            restored, meta = ckpt_lib.restore_checkpoint(
                latest, {"params": template.params,
                         "opt_state": template.opt_state})
            return TrainState(restored["params"], restored["opt_state"],
                              int(meta["step"]))
        # every rank reads the gathered arrays once rank 0's writes are
        # done, and keeps its blocks
        self.manager.wait()
        dist.barrier()
        latest = ckpt_lib.latest_checkpoint(self.cfg.checkpoint_dir)
        if latest is None:
            return None
        defs = self.model.defs()
        opt = template.opt_state
        moments = param_shapes(defs, self.opt.moment_dtype)
        restored, meta = ckpt_lib.restore_checkpoint(
            latest, {"params": param_shapes(defs, self.model.cfg.param_dtype),
                     "opt_state": AdamState(opt.step, moments, moments)},
            device="cpu")
        dev, specs, sharder = self.model.device, self.model.specs(), \
            self.model.sharder

        def local(tree):
            return tree_map(lambda t: t.to(dev),
                            shard_params(tree, sharder, specs))
        ro = restored["opt_state"]
        return TrainState(local(restored["params"]),
                          AdamState(ro.step, local(ro.m), local(ro.v)),
                          int(meta["step"]))

    # -- main loop -----------------------------------------------------------
    def run(self, seed: int = 0, *, resume: bool = True) -> TrainState:
        state = self.init_state(seed)
        if resume:
            restored = self._restore(state)
            if restored is not None:
                state = restored
        recoveries = 0
        step = state.step
        while step < self.cfg.total_steps:
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                params, opt_state, metrics = self.train_step(
                    state.params, state.opt_state, batch)
                loss = float(metrics["loss"])      # waits for the step
            except Exception as e:                 # crash recovery path
                recoveries += 1
                if recoveries > self.cfg.max_recoveries:
                    raise
                fresh = self.init_state(seed)
                restored = self._restore(fresh)
                state = restored if restored is not None else fresh
                step = state.step
                self.history.append({"step": step, "event": "recovered",
                                     "error": str(e)})
                continue
            dt = time.perf_counter() - t0
            state = TrainState(params, opt_state, step + 1)
            straggle = self.monitor.observe(step, dt)
            if step % self.cfg.log_every == 0 or straggle:
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics.get("grad_norm", 0.0)),
                       "time_s": round(dt, 4), "straggler": straggle}
                self.history.append(rec)
                if self.metrics_hook:
                    self.metrics_hook(step, rec)
            step += 1
            if step % self.cfg.checkpoint_every == 0 \
                    or step == self.cfg.total_steps:
                self._save(state)
        self.manager.wait()
        return state

    def close(self):
        """Stop the checkpoint writer (after its last save)."""
        self.manager.close()
