"""The port's encoder-decoder and vision-prefix model paths against the JAX
package.

Reduced seamless-m4t-medium (2 encoder layers of bidirectional attention,
2 decoder layers with cross-attention, the audio ``frontend_proj``) and
phi-3-vision-4.2b (4 projected ``prefix_embeds`` before the text), from
``reduce_config`` (float32, blocks of 32), in both packages; parameters
drawn with numpy from a seed (``tests/_torch_model_parity.py``) and carried
over with ``model_params_from_arrays``; tokens and embeddings drawn with
numpy from a seed.  A decoder of 64 positions takes the blockwise path (the
flash kernel's call site, its plain version on the CPU): the encoder's
self-attention non-causal at Sq == Skv, the cross-attention non-causal at
Sq = 64, Skv = 128 (or 64).  ``_encode``, ``forward``, ``prefill`` and four
teacher-forced ``decode_step``s with ``enc_out`` must agree with the JAX
model within 2e-4, the bound of ``tests/test_models_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_parity import (DECODE_STEPS, close, numpy_params,
                                 reduced_pair, same_caches, tokens)
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import Model as JaxModel
from repro.models.api import LayerSpec as JaxLayerSpec
from repro_torch.configs import (SHAPES, batch_shapes, get_config,
                                 reduce_config)
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.errors import ValidationError
from repro_torch.kernels import ref as tref
from repro_torch.models import LayerSpec, Model
from repro_torch.models.api import iter_leaves

jax.config.update("jax_platform_name", "cpu")

SEAMLESS, PHI3 = "seamless-m4t-medium", "phi-3-vision-4.2b"
FULL_PARAMS = {PHI3: 3_831_696_384, SEAMLESS: 716_503_040}


@pytest.fixture(scope="module")
def seamless():
    return reduced_pair(SEAMLESS, seed=1)


@pytest.fixture(scope="module")
def phi3():
    return reduced_pair(PHI3, seed=2)


def _embeds(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _batches(**arrays):
    """The same batch for the JAX model (jnp) and the port (torch)."""
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _seamless_batch(cfg, frames, text, seed):
    return _batches(tokens=tokens(cfg, 2, text, seed),
                    frame_embeds=_embeds(cfg, 2, frames, seed + 1))


def _phi3_batch(cfg, text, seed):
    return _batches(tokens=tokens(cfg, 2, text, seed),
                    prefix_embeds=_embeds(cfg, 2, cfg.num_prefix_tokens,
                                          seed + 1))


@pytest.mark.parametrize("arch", [SEAMLESS, PHI3])
def test_config_fields_and_param_count_match_jax(arch):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (reduce_config(get_config(arch)),
                       jax_reduce_config(jax_get_config(arch)))):
        for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "head_dim", "d_ff", "vocab_size", "is_encoder_decoder",
                      "num_encoder_layers", "frontend", "num_prefix_tokens",
                      "attn_impl", "attn_block_q", "attn_block_k",
                      "tie_embeddings", "rope_theta"):
            assert getattr(cfg, field) == getattr(jcfg, field), field
        assert [(s.mixer, s.mlp, s.cross_attn) for s in
                cfg.pattern + cfg.encoder_pattern] == \
            [(s.mixer, s.mlp, s.cross_attn) for s in
             jcfg.pattern + jcfg.encoder_pattern]
        assert cfg.param_count() == jcfg.param_count()
    assert get_config(arch).param_count() == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", [SEAMLESS, PHI3])
def test_params_carry_the_new_leaves_across(arch):
    """``model_params_from_arrays`` takes ``enc_blocks``,
    ``enc_final_norm``, ``frontend_proj`` and the ``cross`` /
    ``norm_cross`` sub-layers, at their shapes, and refuses a tree
    without one of them."""
    cfg = reduce_config(get_config(arch))
    tree = numpy_params(cfg, 3)
    params = model_params_from_arrays(tree, cfg, device="cpu")
    want = {"frontend_proj"} | ({"enc_blocks", "enc_final_norm", "cross",
                                 "norm_cross"} if arch == SEAMLESS else set())
    paths = dict(iter_leaves(params))
    assert want <= {part for path in paths for part in path.split("/")}
    for path, arr in iter_leaves(tree):
        assert torch.equal(paths[path], torch.from_numpy(arr))
    del tree["frontend_proj"]
    with pytest.raises(ValidationError):
        model_params_from_arrays(tree, cfg, device="cpu")


def test_encode_equals_jax(seamless):
    cfg, model, params, jm, jp = seamless
    jbatch, batch = _seamless_batch(cfg, 128, 64, seed=5)
    want = jax.jit(jm._encode)(jp, jbatch)
    got = model._encode(params, batch)
    assert got.shape == (2, 128, cfg.d_model)
    close(got, want)


@pytest.mark.parametrize("frames,text", [(128, 64), (64, 64), (48, 16)])
def test_seamless_forward_equals_jax(seamless, frames, text, monkeypatch):
    """At 64 decoder positions the cross-attention takes the blockwise
    path with Sq != Skv (128 frames) and Sq == Skv (64), both non-causal,
    and the encoder's 64 or 128 frames the blockwise path non-causal;
    48 frames (not a multiple of the block) and 16 tokens take the dense
    path everywhere."""
    cfg, model, params, jm, jp = seamless
    jbatch, batch = _seamless_batch(cfg, frames, text, seed=frames + text)
    calls = []
    real = tref.ref_flash_attention

    def spy(q, k, *args, **kw):
        calls.append((q.shape[2], k.shape[2], kw["causal"]))
        return real(q, k, *args, **kw)

    monkeypatch.setattr(tref, "ref_flash_attention", spy)
    want, want_aux = jax.jit(jm.forward)(jp, jbatch)
    got, aux = model.forward_with_aux(params, batch)
    assert got.shape == (2, text, cfg.padded_vocab)
    close(got, want, cfg.vocab_size)
    close(aux, want_aux)
    blk = cfg.attn_block_q

    def blockwise(n):
        return n > blk and n % blk == 0

    enc = cfg.num_encoder_layers if blockwise(frames) else 0
    dec = cfg.num_layers if blockwise(text) else 0
    cross = dec if frames % blk == 0 else 0
    assert sorted(calls) == sorted(
        [(frames, frames, False)] * enc + [(text, text, True)] * dec
        + [(text, frames, False)] * cross)


def test_seamless_prefill_and_decode_equal_jax(seamless):
    """``prefill`` (which encodes inside) then DECODE_STEPS teacher-forced
    ``decode_step``s fed ``_encode``'s output: logits and every cache leaf
    equal the JAX model's."""
    cfg, model, params, jm, jp = seamless
    text = 64
    jbatch, batch = _seamless_batch(cfg, 128, text, seed=9)
    max_len = text + DECODE_STEPS + 4
    jcache, jlog = jax.jit(jm.prefill)(jp, jbatch, jm.init_cache(2, max_len))
    cache, log = model.prefill(params, batch, model.init_cache(2, max_len))
    close(log, jlog, cfg.vocab_size)
    same_caches(cache, jcache)
    jenc = jax.jit(jm._encode)(jp, jbatch)
    enc = model._encode(params, batch)
    decode = jax.jit(jm.decode_step)
    for step in range(DECODE_STEPS):
        cur = np.array(jnp.argmax(jlog[:, -1, :cfg.vocab_size], axis=-1),
                       np.int32)[:, None]
        jcache, jlog = decode(jp, jnp.asarray(cur), jcache,
                              jnp.int32(text + step), jenc)
        cache, log = model.decode_step(params, torch.from_numpy(cur), cache,
                                       text + step, enc)
        close(log, jlog, cfg.vocab_size)
    same_caches(cache, jcache)


def test_decode_without_enc_out_raises(seamless):
    cfg, model, params, jm, jp = seamless
    cache = model.init_cache(1, 8)
    with pytest.raises(ValidationError, match="enc_out"):
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.int64),
                          cache, 0)
    with pytest.raises(ValidationError, match="frame_embeds"):
        model.forward(params, {"tokens": torch.zeros((1, 8),
                                                     dtype=torch.int64)})


@pytest.mark.parametrize("text", [60, 12])
def test_phi3_forward_equals_jax(phi3, text):
    """4 projected prefix embeddings before the text: 64 positions take
    the blockwise path (causal), 16 the dense one."""
    cfg, model, params, jm, jp = phi3
    jbatch, batch = _phi3_batch(cfg, text, seed=text)
    want, _ = jax.jit(jm.forward)(jp, jbatch)
    got = model.forward(params, batch)
    assert got.shape == (2, cfg.num_prefix_tokens + text, cfg.padded_vocab)
    close(got, want, cfg.vocab_size)


def test_phi3_prefill_and_decode_equal_jax(phi3):
    cfg, model, params, jm, jp = phi3
    jbatch, batch = _phi3_batch(cfg, 60, seed=21)
    seq = cfg.num_prefix_tokens + 60
    max_len = seq + DECODE_STEPS + 4
    jcache, jlog = jax.jit(jm.prefill)(jp, jbatch, jm.init_cache(2, max_len))
    cache, log = model.prefill(params, batch, model.init_cache(2, max_len))
    close(log, jlog, cfg.vocab_size)
    same_caches(cache, jcache)
    decode = jax.jit(jm.decode_step)
    for step in range(DECODE_STEPS):
        cur = np.array(jnp.argmax(jlog[:, -1, :cfg.vocab_size], axis=-1),
                       np.int32)[:, None]
        jcache, jlog = decode(jp, jnp.asarray(cur), jcache,
                              jnp.int32(seq + step))
        cache, log = model.decode_step(params, torch.from_numpy(cur), cache,
                                       seq + step)
        close(log, jlog, cfg.vocab_size)
    same_caches(cache, jcache)


def test_mamba_layer_with_cross_attention_equals_jax():
    """The JAX defs put cross-attention after any mixer, a Mamba one
    included: an encoder-decoder whose decoder layer is ``mamba`` +
    ``cross_attn``, forward and prefill + decode."""
    keep = dict(ssm_state=16, mamba_head_dim=8)
    jcfg = dataclasses.replace(
        jax_reduce_config(jax_get_config(SEAMLESS)),
        pattern=(JaxLayerSpec("mamba", "dense", cross_attn=True),), **keep)
    cfg = dataclasses.replace(
        reduce_config(get_config(SEAMLESS)),
        pattern=(LayerSpec("mamba", "dense", cross_attn=True),), **keep)
    tree = numpy_params(cfg, 4)
    params = model_params_from_arrays(tree, cfg, device="cpu")
    model, jm = Model(cfg, device="cpu"), JaxModel(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    assert cfg.param_count() == jcfg.param_count()
    jbatch, batch = _seamless_batch(cfg, 64, 64, seed=31)
    want, _ = jax.jit(jm.forward)(jp, jbatch)
    close(model.forward(params, batch), want, cfg.vocab_size)
    jcache, jlog = jax.jit(jm.prefill)(jp, jbatch, jm.init_cache(2, 70))
    cache, log = model.prefill(params, batch, model.init_cache(2, 70))
    close(log, jlog, cfg.vocab_size)
    cur = np.array(jnp.argmax(jlog[:, -1, :cfg.vocab_size], axis=-1),
                   np.int32)[:, None]
    jcache, jlog = jax.jit(jm.decode_step)(
        jp, jnp.asarray(cur), jcache, jnp.int32(64),
        jax.jit(jm._encode)(jp, jbatch))
    cache, log = model.decode_step(params, torch.from_numpy(cur), cache, 64,
                                   model._encode(params, batch))
    close(log, jlog, cfg.vocab_size)
    same_caches(cache, jcache)


@pytest.mark.parametrize("arch", [SEAMLESS, PHI3, "smollm-360m"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_batch_shapes_equal_jax(arch, shape):
    from repro.configs import SHAPES as JAX_SHAPES
    from repro.configs import batch_shapes as jax_batch_shapes

    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (reduce_config(get_config(arch)),
                       jax_reduce_config(jax_get_config(arch)))):
        got = batch_shapes(cfg, SHAPES[shape])
        want = jax_batch_shapes(jcfg, JAX_SHAPES[shape])
        assert list(got) == list(want)
        for name, (shp, dt) in got.items():
            assert shp == want[name][0], name
            assert str(dt).split(".")[-1] == jnp.dtype(want[name][1]).name
