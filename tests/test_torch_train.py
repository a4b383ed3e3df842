"""The port's training path against the JAX package's, on the CPU.

Reduced configs (float32, blocks of 32) in both packages hold the same
parameters (drawn with numpy, carried over with ``convert``; the JAX
``Model.init`` and ``make_batch`` fold Python's per-process salted string
hash into their keys, so nothing here is compared with stored numbers).
Batches are numpy: tokens, packed-document ``segments`` and
``positions``, ``labels`` with -1 entries, and the vision prefix or the
audio frames.  At 128 positions attention takes the blockwise route
(the plain flash version on the CPU) with segments.

Mamba layers: at 128 positions the JAX package's SSD gradient is NaN (its
chunk of 128 masks the intra-chunk decay after the exp, and exp(cs_l -
cs_m) above the diagonal overflows; the port masks before the exp), so
the reference runs with its chunk constant at 64 there, which computes
the same function.  Reduced jamba-1.5-large-398b is ill-conditioned in
float32 (its gradients sum long products with heavy cancellation): both
packages are held against a float64 run of the port instead of each
other.
"""
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as jax_mamba
from repro.models.attention import blockwise_attention as jax_blockwise
from repro.launch import steps as jsteps
from repro.train import checkpoint as jckpt
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import TrainLoopConfig as JaxTrainLoopConfig
from repro.train.loop import make_grad_accum_loss as jax_grad_accum_loss
from repro.train.optimizer import AdamW as JaxAdamW
from repro.train.optimizer import apply_updates as jax_apply_updates
from repro.train.optimizer import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import (SHAPES, ShapeDef, get_config, input_specs,
                                 make_batch, reduce_config, shape_applicable)
from repro_torch.convert import adam_state_from_arrays, model_params_from_arrays
from repro_torch.core.errors import CheckpointError, ValidationError
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels.flash_attention import FlashAttentionFunction
from repro_torch.kernels.flash_vjp import (blockwise_attention_twin,
                                           flash_attention_vjp)
from repro_torch.launch import train as train_launcher
from repro_torch.launch import steps
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models.api import iter_leaves
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import (StragglerMonitor, TrainLoop,
                                    TrainLoopConfig, make_grad_accum_loss,
                                    value_and_grad)
from repro_torch.train.optimizer import (AdamW, apply_updates,
                                         constant_schedule, cosine_schedule)
from _torch_model_parity import close, numpy_params, reduced_pair

ARCHS = ("smollm-360m", "gemma2-2b", "granite-moe-3b-a800m", "mamba2-2.7b",
         "jamba-1.5-large-398b", "phi-3-vision-4.2b", "seamless-m4t-medium")
SEQ = 128
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4        # of each leaf's max |g|
# reduced jamba against the float64 run: each package's float32 leaf
# within this share of the float64 leaf's max |g| (measured: port 1.1e-2,
# JAX 7.8e-3 at the worst leaf, the first layers' Mamba sums)
JAMBA_F64_TOL = 2e-2


def train_batch(cfg, b: int, s: int, seed: int):
    """A numpy training batch of ``s`` positions (vision: the prefix's
    included, its labels -1; audio: ``s`` frames too)."""
    rng = np.random.default_rng(seed)
    prefix = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    seg = np.sort(rng.integers(0, 4, (b, s)), axis=1).astype(np.int32)
    idx = np.arange(s)
    starts = np.maximum.accumulate(
        np.where(np.diff(seg, axis=1, prepend=-1) != 0, idx, 0), axis=1)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.1] = -1
    labels[:, :prefix] = -1
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (b, s - prefix)).astype(np.int32),
           "segments": seg, "positions": (idx - starts).astype(np.int32),
           "labels": labels}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rng.standard_normal(
            (b, prefix, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


def to_torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def port_grads(model, params, batch, dtype=torch.float32):
    (loss, aux), grads = value_and_grad(model, params, to_torch(batch, dtype))
    return float(loss), aux, {p: g.double().numpy()
                              for p, g in iter_leaves(grads)}


def jax_grads(jm, jp, batch):
    (loss, aux), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, to_jax(batch))
    return float(loss), aux, {p: np.asarray(g, np.float64)
                              for p, g in iter_leaves(grads)}


def leaf_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def float64_run(cfg, seed, batch, monkeypatch):
    """The port's loss and gradients in float64: parameters and inputs in
    float64, dense attention, and the port's ``.float()`` up-casts (to at
    least float32) left out for float64 tensors."""
    real = torch.Tensor.float
    monkeypatch.setattr(
        torch.Tensor, "float",
        lambda t, *a, **k: t if t.dtype == torch.float64 else real(t, *a, **k))
    cfg64 = dataclasses.replace(cfg, dtype=torch.float64,
                                param_dtype=torch.float64, attn_impl="dense")
    params = model_params_from_arrays(numpy_params(cfg, seed), cfg64,
                                      device="cpu")
    out = port_grads(Model(cfg64, device="cpu"), params, batch, torch.float64)
    monkeypatch.setattr(torch.Tensor, "float", real)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_jax(arch, monkeypatch):
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad`` of the JAX ``Model.loss``; every leaf gets a
    gradient (the encoder of seamless-m4t-medium included)."""
    cfg, model, params, jm, jp = reduced_pair(arch, seed=1)
    if any(spec.mixer == "mamba" for spec in cfg.pattern):
        monkeypatch.setattr(jax_mamba, "CHUNK", 64)
    batch = train_batch(cfg, 2, SEQ, seed=3)
    loss, aux, grads = port_grads(model, params, batch)
    jloss, jaux, jgrads = jax_grads(jm, jp, batch)
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    for key in ("ce", "moe_aux", "moe_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert grads.keys() == jgrads.keys()
    for path, g in grads.items():
        assert np.isfinite(g).all() and np.abs(g).max() > 0, path
    if arch != "jamba-1.5-large-398b":
        for path, g in grads.items():
            assert leaf_err(g, jgrads[path]) <= GRAD_TOL, path
        return
    _, _, g64 = float64_run(cfg, 1, batch, monkeypatch)
    for path, want in g64.items():
        assert leaf_err(grads[path], want) <= JAMBA_F64_TOL, ("port", path)
        assert leaf_err(jgrads[path], want) <= JAMBA_F64_TOL, ("jax", path)


@pytest.mark.parametrize("arch", ("smollm-360m", "seamless-m4t-medium"))
def test_remat_changes_nothing(arch, monkeypatch):
    """With ``remat`` each block runs again in the backward pass (the
    flash call twice a layer: the count the card run asserts); loss and
    gradients are bitwise the same."""
    cfg, _, params, _, _ = reduced_pair(arch, seed=2)
    batch = to_torch(train_batch(cfg, 2, SEQ, seed=4))
    calls = []
    real = ref_lib.ref_flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ref_lib, "ref_flash_attention", counting)
    out = {}
    for remat in (False, True):
        calls.clear()
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu")
        out[remat] = value_and_grad(model, params, batch)
        out[remat, "calls"] = len(calls)
    per_pass = cfg.num_layers + (cfg.num_encoder_layers + cfg.num_layers
                                 if cfg.is_encoder_decoder else 0)
    assert out[False, "calls"] == per_pass
    assert out[True, "calls"] == 2 * per_pass
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(iter_leaves(g0), iter_leaves(g1)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# the flash kernel under autograd: its backward is the VJP of the twin
# ---------------------------------------------------------------------------

# (B, H, Hkv, Sq, Skv, D, block, causal, window, softcap, segments)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 16, 32, True, None, None, True),
    (1, 6, 2, 128, 128, 32, 32, True, 48, 30.0, True),
    (2, 3, 1, 96, 96, 16, 32, True, None, None, False),
    (2, 4, 4, 128, 128, 16, 64, False, None, None, True),
    (1, 4, 2, 64, 128, 16, 32, False, None, None, False),   # cross
]


def _flash_inputs(b, h, hkv, sq, skv, d, seg, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    segs = None
    if seg:
        segs = np.sort(rng.integers(0, 3, (b, sq)), axis=1).astype(np.int32)
    return q, k, v, do, segs


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_equals_jax_blockwise_vjp(case):
    """The twin's output and :func:`flash_attention_vjp` against the JAX
    ``blockwise_attention`` and its ``jax.vjp`` (q right-aligned:
    ``q_offset = Skv - Sq``); ``FlashAttentionFunction`` on CPU tensors
    runs the plain version forward and the same VJP backward."""
    b, h, hkv, sq, skv, d, blk, causal, window, softcap, seg = case
    q, k, v, do, segs = _flash_inputs(b, h, hkv, sq, skv, d, seg)
    kw = dict(scale=d ** -0.5, causal=causal, window=window, softcap=softcap)
    jseg = None if segs is None else jnp.asarray(segs)

    def f(q, k, v):
        return jax_blockwise(q, k, v, block_q=blk, block_k=blk,
                             q_offset=skv - sq, q_segments=jseg,
                             kv_segments=jseg, **kw)

    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    index, count = ops._host_schedule(sq, skv, blk, blk, causal, window, 0)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tseg = None if segs is None else torch.from_numpy(segs)
    opts = dict(block_q=blk, block_k=blk, q_offset=skv - sq, **kw)
    out = blockwise_attention_twin(tq, tk, tv, index, count, tseg, tseg,
                                   **opts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)
    grads = flash_attention_vjp(tq, tk, tv, torch.from_numpy(do), index,
                                count, tseg, tseg, **opts)
    for got, jg in zip(grads, jgrads):
        assert leaf_err(got.numpy(), np.asarray(jg)) <= 1e-5
    fout = FlashAttentionFunction.apply(
        tq, tk, tv, index, count, tseg, tseg, kw["scale"], causal, window,
        softcap, blk, blk, skv - sq)
    plain = ref_lib.ref_flash_attention(
        tq.detach(), tk.detach(), tv.detach(), index, count, tseg, tseg,
        **opts)
    assert torch.equal(fout.detach(), plain)
    for got, want_g in zip(torch.autograd.grad(fout, (tq, tk, tv),
                                               torch.from_numpy(do)), grads):
        assert torch.equal(got, want_g)


def test_ops_flash_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On CPU tensors ``ops.flash_attention`` stays on the plain version,
    differentiable as it is, also when grad is required; the autograd
    Function is for CUDA tensors."""
    def refuse(*a):
        raise AssertionError("the Function ran on CPU tensors")

    monkeypatch.setattr(FlashAttentionFunction, "apply", refuse)
    q, k, v, do, _ = _flash_inputs(1, 2, 1, 64, 64, 16, False)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, scale=0.25, block_q=32, block_k=32)
    (dq,) = torch.autograd.grad(out, (tq,), torch.from_numpy(do))
    assert torch.isfinite(dq).all() and dq.abs().max() > 0


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"a": rng.standard_normal((3, 4, 2)).astype(np.float32),
                    "b": rng.standard_normal((7,)).astype(np.float32)}}


def _bf16_ulp(x):
    x = np.abs(np.asarray(x, np.float64))
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_adamw_equals_jax(moments):
    """Three AdamW steps (clipping active on the first, warm-up then
    cosine) on the same gradients: float32 moments keep the parameters
    within 1e-6 relative, bfloat16 moments stay within one bf16 unit."""
    sched = dict(peak_lr=1e-2, warmup_steps=1, total_steps=3)
    jopt = JaxAdamW(jax_cosine_schedule(**sched),
                    moment_dtype=getattr(jnp, moments))
    opt = AdamW(cosine_schedule(**sched), moment_dtype=getattr(torch, moments))
    jp = jax.tree.map(jnp.asarray, _tree(0))
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _tree(0))
    jstate, state = jopt.init(jp), opt.init(params)
    for step in range(3):
        g = _tree(10 + step)
        if step == 0:
            g = jax.tree.map(lambda a: 5 * a, g)      # global norm > 1
        jup, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax_apply_updates(jp, jup)
        up, state, m = opt.update(
            jax.tree.map(torch.from_numpy, g), state, params)
        params = apply_updates(params, up)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    assert int(state.step) == int(jstate.step) == 3
    for (path, p), (_, want) in zip(iter_leaves(params), iter_leaves(jp)):
        want = np.asarray(want)
        tol = 1e-6 if moments == "float32" else 1e-4
        assert leaf_err(p.numpy(), want) <= tol, path
    for tree, jtree in ((state.m, jstate.m), (state.v, jstate.v)):
        for (path, t), (_, want) in zip(iter_leaves(tree), iter_leaves(jtree)):
            want = np.asarray(want, np.float64)
            got = t.double().numpy()
            if moments == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
            else:
                assert (np.abs(got - want) <= _bf16_ulp(want)).all(), path


def test_grad_accumulation_equals_full_batch_and_jax():
    """Four microbatches equal one batch (up to the order of the sums) and
    the JAX ``make_grad_accum_loss`` with four.  Each microbatch's loss is
    its own mean, so the batch's labels are valid at the same count in
    every row (all but the last position) for the equality with one."""
    cfg, model, params, jm, jp = reduced_pair("smollm-360m", seed=5)
    batch = train_batch(cfg, 8, 64, seed=6)
    batch["labels"] = np.abs(batch["labels"])
    batch["labels"][:, -1] = -1
    (l1, _), g1 = make_grad_accum_loss(model, 1)(params, to_torch(batch))
    (l4, a4), g4 = make_grad_accum_loss(model, 4)(params, to_torch(batch))
    (jl4, ja4), jg4 = jax.jit(jax_grad_accum_loss(jm, 4))(jp, to_jax(batch))
    np.testing.assert_allclose(float(l4), float(l1), rtol=1e-5)
    np.testing.assert_allclose(float(l4), float(jl4), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(a4["ce"]), float(ja4["ce"]),
                               rtol=LOSS_RTOL)
    jgl = dict(iter_leaves(jg4))
    for (path, a), (_, b) in zip(iter_leaves(g4), iter_leaves(g1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-5)
        assert leaf_err(a.numpy(), np.asarray(jgl[path])) <= GRAD_TOL, path


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _states(moments, seed=0):
    """(JAX state, port state): params and AdamState of reduced smollm."""
    cfg = reduce_config(get_config("smollm-360m"))
    tree = numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                     .astype(np.float32), tree)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), tree)
    jdt = getattr(jnp, moments)
    jstate = {"params": jax.tree.map(jnp.asarray, tree),
              "opt_state": JaxAdamW(None).init(tree)._replace(
                  step=jnp.int32(7),
                  m=jax.tree.map(lambda a: jnp.asarray(a, jdt), m),
                  v=jax.tree.map(lambda a: jnp.asarray(a, jdt), v))}
    state = {"params": model_params_from_arrays(tree, cfg, device="cpu"),
             "opt_state": adam_state_from_arrays(
                 7, jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt),
                                                      np.float32), m),
                 jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt),
                                                   np.float32), v),
                 cfg, device="cpu", moment_dtype=getattr(torch, moments))}
    return jstate, state


def _same(port_state, jax_state):
    flat = dict(ckpt._flatten_with_paths(port_state))
    jflat = dict(zip(*jckpt._flatten_with_paths(jax_state)[:2]))
    assert flat.keys() == jflat.keys()
    for path, t in flat.items():
        want = np.asarray(jflat[path])
        got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype), path)


@pytest.mark.parametrize("moments", ("float32", "bfloat16"))
def test_checkpoint_jax_to_port(tmp_path, moments):
    """A checkpoint the JAX package writes restores into the port, bit
    for bit (bfloat16 moments too), and the port writes the same paths,
    dtypes and shapes."""
    jstate, state = _states(moments)
    jckpt.save_checkpoint(tmp_path / "jax", 7, jstate, {"step": 7})
    template = jax.tree_util.tree_map(torch.zeros_like, state)
    restored, meta = ckpt.restore_checkpoint(
        ckpt.latest_checkpoint(tmp_path / "jax"), template)
    assert meta["step"] == 7 and meta["metadata"] == {"step": 7}
    assert restored["opt_state"].m["embed"]["embedding"].dtype \
        == getattr(torch, moments)
    _same(restored, jstate)
    ckpt.save_checkpoint(tmp_path / "port", 7, state, {"step": 7})
    mine, theirs = (json.loads((d / "step_00000007" / "meta.json")
                               .read_text())
                    for d in (tmp_path / "port", tmp_path / "jax"))
    order = np.argsort(mine["paths"])
    jorder = np.argsort(theirs["paths"])
    for key in ("paths", "dtypes", "shapes"):
        assert [mine[key][i] for i in order] \
            == [theirs[key][i] for i in jorder], key


def test_checkpoint_port_to_jax(tmp_path):
    """A checkpoint the port writes restores into the JAX package (float32
    moments: the JAX package cannot cast the raw 2-byte arrays numpy holds
    for bfloat16 back, not even from its own files)."""
    jstate, state = _states("float32", seed=3)
    ckpt.save_checkpoint(tmp_path, 7, state, {"step": 7})
    restored, meta = jckpt.restore_checkpoint(
        jckpt.latest_checkpoint(tmp_path), jstate)
    assert meta["step"] == 7
    _same(state, restored)


def test_checkpoint_atomic_keep_n_and_shape_check(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "n": {"b": torch.arange(4, dtype=torch.int32)}}
    (tmp_path / "step_00000005.tmp").mkdir()     # a crash mid-write
    assert ckpt.latest_checkpoint(tmp_path) is None
    for s in range(6):
        ckpt.save_checkpoint(tmp_path, s, state)
    assert ckpt.checkpoint_step(ckpt.latest_checkpoint(tmp_path)) == 5
    ckpt.garbage_collect(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]      # step 5's save replaced it
    with pytest.raises(ValidationError):
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path),
                                {"a": torch.zeros(3, 3), "n": state["n"]})
    with pytest.raises(ValidationError):
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(tmp_path),
                                {"c": torch.zeros(2, 3)})


@pytest.mark.parametrize("async_save", (True, False))
def test_checkpoint_manager_copies_before_mutation(tmp_path, async_save):
    """``save`` copies the leaves to the host before it returns, so an in
    place update right after it (the next step) is not written; keep-N."""
    mgr = ckpt.CheckpointManager(tmp_path, keep=2, async_save=async_save)
    p = torch.zeros(256, 256)
    for s in range(4):
        mgr.save(s, {"p": p, "step": torch.tensor(s)})
        p.add_(1.0)
    mgr.wait()
    assert sorted(x.name for x in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    restored, _ = ckpt.restore_checkpoint(
        mgr.latest(), {"p": torch.empty(256, 256), "step": torch.tensor(0)})
    assert torch.equal(restored["p"], torch.full((256, 256), 3.0))
    mgr.close()


def test_checkpoint_manager_surfaces_a_failed_write(tmp_path):
    """A write that fails in the background raises ``CheckpointError`` (a
    ``RuntimeError``, as the JAX package's) at the next ``wait``."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    mgr = ckpt.CheckpointManager(blocker, keep=2, async_save=True)
    mgr.save(1, {"p": torch.zeros(3)})
    with pytest.raises(CheckpointError) as err:
        mgr.wait()
    assert isinstance(err.value, RuntimeError)
    mgr._errors.clear()
    mgr.close()


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

class _Batches:
    """The same numpy batches to either package's loop."""

    def __init__(self, batches, convert):
        self.batches, self.convert = batches, convert

    def batch(self, step):
        return self.convert(self.batches[step])


def test_train_loop_equals_jax(tmp_path):
    """Four steps (two microbatches each) of both loops from one step-0
    checkpoint that the JAX package wrote, fed the same batches."""
    cfg, model, _, jm, jp = reduced_pair("smollm-360m", seed=7)
    batches = [train_batch(cfg, 4, 64, seed=20 + i) for i in range(4)]
    jopt = JaxAdamW(lambda s: jnp.asarray(1e-2, jnp.float32),
                    moment_dtype=jnp.float32)
    jckpt.save_checkpoint(tmp_path / "jax", 0,
                          {"params": jp, "opt_state": jopt.init(jp)},
                          {"step": 0})
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    common = dict(total_steps=4, checkpoint_every=100, log_every=1,
                  microbatches=2, async_checkpoint=False)
    jloop = JaxTrainLoop(jm, jopt, _Batches(batches, to_jax),
                         JaxTrainLoopConfig(checkpoint_dir=str(
                             tmp_path / "jax"), **common))
    jfinal = jloop.run(jax.random.PRNGKey(0))
    loop = TrainLoop(model, AdamW(constant_schedule(1e-2),
                                  moment_dtype=torch.float32),
                     _Batches(batches, to_torch),
                     TrainLoopConfig(checkpoint_dir=str(tmp_path / "port"),
                                     **common))
    final = loop.run(0)
    loop.close()
    assert final.step == jfinal.step == 4
    losses = [h["loss"] for h in loop.history]
    jlosses = [h["loss"] for h in jloop.history]
    assert len(losses) == len(jlosses) == 4
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    jflat = dict(iter_leaves(jfinal.params))
    for path, p in iter_leaves(final.params):
        np.testing.assert_allclose(p.numpy(), np.asarray(jflat[path]),
                                   rtol=1e-4, atol=1e-4, err_msg=path)


def _tiny_loop(tmp_path, total_steps=8, ckpt_every=4, fault_hook=None):
    cfg = reduce_config(get_config("smollm-360m"))
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       global_batch=4), device="cpu")
    return TrainLoop(
        Model(cfg, device="cpu"),
        AdamW(constant_schedule(1e-2), moment_dtype=torch.float32), data,
        TrainLoopConfig(total_steps=total_steps, checkpoint_every=ckpt_every,
                        checkpoint_dir=str(tmp_path / "ckpt"), log_every=1,
                        async_checkpoint=False),
        fault_hook=fault_hook)


def _equal_params(a, b):
    for (path, x), (_, y) in zip(iter_leaves(a), iter_leaves(b)):
        assert torch.equal(x, y), path


def test_loss_decreases_on_learnable_task(tmp_path):
    loop = _tiny_loop(tmp_path, total_steps=30, ckpt_every=30)
    loop.run(0, resume=False)
    losses = [h["loss"] for h in loop.history]
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_resume_is_bitwise_deterministic(tmp_path):
    final_a = _tiny_loop(tmp_path / "a").run(0, resume=False)
    _tiny_loop(tmp_path / "b", total_steps=4).run(0, resume=False)
    final_b = _tiny_loop(tmp_path / "b").run(0, resume=True)
    assert final_a.step == final_b.step == 8
    _equal_params(final_a.params, final_b.params)


def test_crash_recovery_resumes_from_the_checkpoint(tmp_path):
    armed = [True]

    def fault(step):
        if step == 6 and armed[0]:
            armed[0] = False
            raise RuntimeError("injected node failure")

    loop = _tiny_loop(tmp_path, fault_hook=fault)
    final = loop.run(0, resume=False)
    assert final.step == 8
    events = [h for h in loop.history if h.get("event") == "recovered"]
    assert len(events) == 1 and events[0]["step"] == 4
    ref = _tiny_loop(tmp_path / "ref").run(0, resume=False)
    _equal_params(final.params, ref.params)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(sigma=3.0, warmup=3)
    for i in range(20):
        assert not mon.observe(i, 0.1 + 0.001 * (i % 3))
    assert mon.observe(20, 1.5)
    assert mon.flagged == [20]


def test_train_step_updates_in_place():
    cfg, model, params, _, _ = reduced_pair("granite-moe-3b-a800m", seed=8)
    opt = AdamW(constant_schedule(1e-3))
    state = opt.init(params)
    before = {p: t.clone() for p, t in iter_leaves(params)}
    out, state, metrics = make_train_step(model, opt)(
        params, state, to_torch(train_batch(cfg, 2, 64, seed=9)))
    assert out is params and int(state.step) == 1
    assert set(metrics) == {"loss", "ce", "moe_aux", "moe_z", "grad_norm",
                            "lr"}
    assert float(metrics["moe_aux"]) > 0
    assert all(not torch.equal(t, before[p]) for p, t in iter_leaves(params))
    assert state.m["embed"]["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["smollm-360m", "seamless-m4t-medium"])
def test_serving_steps_equal_jax(arch):
    """``make_prefill_step`` then two teacher-forced ``make_decode_step``
    calls (an encoder-decoder's fed its encoder output): the logits equal
    the JAX package's step builders'."""
    cfg, model, params, jm, jp = reduced_pair(arch, seed=10)
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 64)).astype(
        np.int32)}
    enc_dec = cfg.is_encoder_decoder
    if enc_dec:
        batch["frame_embeds"] = rng.standard_normal(
            (2, 64, cfg.d_model)).astype(np.float32)
    tb, jb = to_torch(batch), to_jax(batch)
    cache, log = steps.make_prefill_step(model)(params, tb,
                                                model.init_cache(2, 68))
    jcache, jlog = jax.jit(jsteps.make_prefill_step(jm))(
        jp, jb, jm.init_cache(2, 68))
    close(log, jlog, cfg.vocab_size)
    enc = (model._encode(params, tb),) if enc_dec else ()
    jenc = (jax.jit(jm._encode)(jp, jb),) if enc_dec else ()
    decode = steps.make_decode_step(model, enc_dec)
    jdecode = jax.jit(jsteps.make_decode_step(jm, enc_dec))
    for pos in (64, 65):
        cur = np.array(jnp.argmax(jlog[:, -1, :cfg.vocab_size], axis=-1),
                       np.int32)[:, None]
        cache, log = decode(params, torch.from_numpy(cur), cache, pos, *enc)
        jcache, jlog = jdecode(jp, jnp.asarray(cur), jcache, jnp.int32(pos),
                               *jenc)
        close(log, jlog, cfg.vocab_size)


# ---------------------------------------------------------------------------
# configs and the launcher
# ---------------------------------------------------------------------------

_DIGEST = """
import sys, zlib, torch
sys.path.insert(0, "src")
from repro_torch.configs import ShapeDef, get_config, make_batch, reduce_config
b = make_batch(torch.Generator().manual_seed(5),
               reduce_config(get_config("phi-3-vision-4.2b")),
               ShapeDef("t", 24, 3, "train"))
print(zlib.crc32(b"".join(b[k].numpy().tobytes() for k in sorted(b))))
"""


def test_make_batch_is_stable_across_processes():
    """Each input's seed is a crc32 of its name, not the salted hash()."""
    cfg = reduce_config(get_config("phi-3-vision-4.2b"))
    b = make_batch(torch.Generator().manual_seed(5), cfg,
                   ShapeDef("t", 24, 3, "train"))
    here = zlib.crc32(b"".join(b[k].numpy().tobytes() for k in sorted(b)))
    other = subprocess.run([sys.executable, "-c", _DIGEST], check=True,
                           capture_output=True, text=True,
                           cwd=pathlib.Path(__file__).resolve().parents[1],
                           env={**os.environ, "PYTHONHASHSEED": "random"})
    assert int(other.stdout) == here
    assert b["prefix_embeds"].shape == (3, cfg.num_prefix_tokens,
                                        cfg.d_model)
    assert b["tokens"].shape == (3, 24 - cfg.num_prefix_tokens)
    assert (b["labels"][:, :cfg.num_prefix_tokens] == -1).all()
    assert (b["labels"][:, cfg.num_prefix_tokens:] >= 0).all()
    specs = input_specs(get_config("seamless-m4t-medium"), SHAPES["train_4k"])
    assert all(t.device.type == "meta" for t in specs.values())
    assert specs["frame_embeds"].shape == (256, 4096, 1024)
    assert shape_applicable("smollm-360m", "long_500k")[0] is False
    assert shape_applicable("mamba2-2.7b", "long_500k") == (True, "")


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    loop = train_launcher.main([
        "--arch", "smollm-360m", "--reduced", "--steps", "3", "--batch", "4",
        "--seq", "64", "--microbatches", "2", "--ckpt-dir",
        str(tmp_path), "--ckpt-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "done at step 3" in out
    assert [h["step"] for h in loop.history] == [0, 1, 2]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
