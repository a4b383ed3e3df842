"""The port's dense model stack and serving engine against the JAX package.

Reduced smollm-360m, gemma2-2b, minitron-4b and mistral-nemo-12b
(``reduce_config``: float32, blocks of 32; gemma2 puts ``attn_local``, the
window, the attention softcap and the logit softcap on the path; the
other two untied embeddings), and a 2-layer reduced gemma2-2b that keeps
its head width of 256.  The JAX ``Model.init`` parameters are carried
over with ``model_params_from_arrays``; token batches are made with numpy
from a seed.  A 64-token prompt takes the blockwise attention path (the
flash kernel's call site; its plain version on the CPU), a 16-token prompt
the dense one.  ``forward`` logits, ``prefill`` logits and caches, and four
teacher-forced ``decode_step``s (fed the JAX run's tokens) must agree with
the JAX model within 2e-4, the bound of ``tests/test_models_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import Model as JaxModel
from repro.models.common import cross_entropy as jax_cross_entropy
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.errors import ValidationError
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import LayerSpec, Model
from repro_torch.models.common import cross_entropy
from repro_torch.serve.engine import Request, ServeEngine, generate_greedy

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_STEPS = 4


# reduced gemma2-2b that keeps its head width, 256, in 2 layers (one local,
# one global): the width the card's flash kernel takes since it gained D = 256
GEMMA_D256 = "gemma2-2b@head_dim=256"


def _reduced(arch):
    """(JAX config, port config), both reduced the same way."""
    if arch == GEMMA_D256:
        keep = dict(head_dim=256, num_layers=2)
        return (dataclasses.replace(
                    jax_reduce_config(jax_get_config("gemma2-2b")), **keep),
                dataclasses.replace(reduce_config(get_config("gemma2-2b")),
                                    **keep))
    return jax_reduce_config(jax_get_config(arch)), \
        reduce_config(get_config(arch))


# the dense archs; the MoE and Mamba archs have test_torch_moe.py and
# test_torch_mamba.py
DENSE_ARCHS = ("smollm-360m", "gemma2-2b", GEMMA_D256, "minitron-4b",
               "mistral-nemo-12b")


@pytest.fixture(scope="module", params=DENSE_ARCHS)
def pair(request):
    """(port cfg, port model, port params, jax model, jax params)."""
    jcfg, cfg = _reduced(request.param)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = model_params_from_arrays(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    return cfg, Model(cfg, device="cpu"), params, jm, jp


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got: torch.Tensor, want, vocab=None):
    got, want = got.numpy(), np.asarray(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, **TOL)


def test_config_and_param_count_match_jax(pair):
    cfg, model, params, jm, jp = pair
    jcfg = jm.cfg
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.padded_vocab == jcfg.padded_vocab
    assert cfg.num_blocks == jcfg.num_blocks
    full = get_config(cfg.name)
    jfull = jax_get_config(cfg.name)
    assert full.param_count() == jfull.param_count()
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "window", "attn_softcap",
                  "logit_softcap", "rope_theta", "attn_block_q",
                  "attn_block_k", "tie_embeddings", "norm_eps"):
        assert getattr(full, field) == getattr(jfull, field), field
        assert getattr(cfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("seq", [64, 16])
def test_forward_equals_jax(pair, seq):
    cfg, model, params, jm, jp = pair
    toks = _tokens(cfg, 2, seq, seed=seq)
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got = model.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, seq, cfg.padded_vocab)
    _close(got, want, cfg.vocab_size)
    assert float(got[..., cfg.vocab_size:].max()) <= -1e29


def test_forward_with_segments_equals_jax(pair):
    cfg, model, params, jm, jp = pair
    toks = _tokens(cfg, 2, 64, seed=5)
    seg = np.sort(np.random.default_rng(6).integers(0, 3, (2, 64)),
                  axis=1).astype(np.int32)
    want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks),
                                       "segments": jnp.asarray(seg)})
    got = model.forward(params, {"tokens": torch.from_numpy(toks),
                                 "segments": torch.from_numpy(seg)})
    _close(got, want, cfg.vocab_size)


@pytest.mark.parametrize("seq", [64, 16])
def test_prefill_and_decode_equal_jax(pair, seq):
    cfg, model, params, jm, jp = pair
    toks = _tokens(cfg, 2, seq, seed=100 + seq)
    max_len = seq + DECODE_STEPS + 4
    jcache, jlog = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                       jm.init_cache(2, max_len))
    cache, log = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(2, max_len))
    assert log.shape == (2, 1, cfg.padded_vocab)
    _close(log, jlog, cfg.vocab_size)

    def same_cache():
        assert cache.keys() == jcache.keys()
        for name in cache:
            _close(cache[name].k, jcache[name].k)
            _close(cache[name].v, jcache[name].v)
            np.testing.assert_array_equal(cache[name].length.numpy(),
                                          np.asarray(jcache[name].length))

    same_cache()
    decode = jax.jit(jm.decode_step)
    for step in range(DECODE_STEPS):
        # teacher forcing: both models get the JAX run's greedy token
        cur = np.array(jnp.argmax(jlog[:, -1, :cfg.vocab_size], axis=-1),
                         np.int32)[:, None]
        jcache, jlog = decode(jp, jnp.asarray(cur), jcache,
                              jnp.int32(seq + step))
        cache, log = model.decode_step(params, torch.from_numpy(cur), cache,
                                       seq + step)
        _close(log, jlog, cfg.vocab_size)
    same_cache()


def test_prefill_runs_the_blockwise_path_only_when_it_should(pair,
                                                             monkeypatch):
    cfg, model, params, jm, jp = pair
    calls = []
    real = tref.ref_flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tref, "ref_flash_attention", spy)
    for seq, want in ((16, 0), (32, 0), (48, 0), (64, cfg.num_layers)):
        calls.clear()
        model.prefill(params, {"tokens": torch.from_numpy(
            _tokens(cfg, 1, seq, seed=seq))}, model.init_cache(1, seq + 1))
        assert len(calls) == want, (seq, calls)


def _mixed_queue(cfg, seed=11):
    rng = np.random.default_rng(seed)
    lengths = [16, 24, 16, 64, 16, 24, 64, 16]
    budgets = [3, 5, 2, 4, 6, 1, 3, 2]
    return [(rid, rng.integers(1, cfg.vocab_size, n).tolist(), b)
            for rid, (n, b) in enumerate(zip(lengths, budgets))]


def _waves(engine, monkeypatch):
    waves = []
    real = engine._run_wave

    def record(wave):
        waves.append([r.rid for r in wave])
        return real(wave)

    monkeypatch.setattr(engine, "_run_wave", record)
    return waves


def test_serve_engine_equals_jax(pair, monkeypatch):
    cfg, model, params, jm, jp = pair
    queue = _mixed_queue(cfg)
    jeng = JaxServeEngine(jm, jp, num_slots=3, max_len=80)
    eng = ServeEngine(model, params, num_slots=3, max_len=80, device="cpu")
    jwaves, waves = _waves(jeng, monkeypatch), _waves(eng, monkeypatch)
    for rid, prompt, budget in queue:
        jeng.submit(JaxRequest(rid, prompt, budget))
        eng.submit(Request(rid, prompt, budget))
    want, got = jeng.run(), eng.run()
    assert waves == jwaves
    assert list(got) == list(want)          # results in the same order
    for rid, res in got.items():
        assert res.prompt_len == want[rid].prompt_len
        assert len(res.tokens) == queue[rid][2]
        assert res.tokens == want[rid].tokens, rid


def test_serve_engine_eos_and_limits(pair):
    cfg, model, params, jm, jp = pair
    prompt = _tokens(cfg, 1, 16, seed=3)[0].tolist()
    first = generate_greedy(model, params, prompt, 6, max_len=32)
    assert len(first) == 6 and all(0 <= t < cfg.vocab_size for t in first)
    eng = ServeEngine(model, params, num_slots=2, max_len=32, device="cpu")
    eng.submit(Request(0, prompt, 6, eos_id=first[1]))
    assert eng.run()[0].tokens == first[:first.index(first[1]) + 1]
    with pytest.raises(ValidationError):
        eng.submit(Request(1, prompt, 17))
    with pytest.raises(ValidationError):
        ServeEngine(model, params, num_slots=1, max_len=32, device="meta")


def test_init_params_distributions():
    cfg = reduce_config(get_config("smollm-360m"))
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(params["embed"]["embedding"],
                       again["embed"]["embedding"])
    wq = params["blocks"]["layer0"]["mixer"]["wq"]
    assert wq.shape == (cfg.num_blocks, cfg.d_model, cfg.num_heads,
                        cfg.head_dim)
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    emb = params["embed"]["embedding"]
    assert abs(float(emb.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert not params["final_norm"]["scale"].any()
    n = sum(t.numel() for t in jax.tree.leaves(params))
    assert n == cfg.param_count()


def test_unported_paths_raise():
    """What the port still refuses: unknown mixers and MLPs, token-only
    serving of a model with a frontend or an encoder
    (engine and launcher, before any weight is made), and a
    cross-attention layer run without an encoder output.  All ten archs
    are registered."""
    cfg = reduce_config(get_config("smollm-360m"))
    for bad in (dataclasses.replace(cfg, pattern=(LayerSpec("rnn", "dense"),)),
                dataclasses.replace(cfg, pattern=(LayerSpec("attn", "glu"),))):
        with pytest.raises(ValidationError):
            Model(bad, device="cpu")
    for arch in ("phi-3-vision-4.2b", "seamless-m4t-medium"):
        small = reduce_config(get_config(arch))
        model = Model(small, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        with pytest.raises(ValidationError, match="token prompts"):
            ServeEngine(model, params, num_slots=1, max_len=32, device="cpu")
        with pytest.raises(ValidationError, match="token prompts"):
            serve_launcher.main(["--arch", arch, "--reduced", "--device",
                                 "cpu"])
    cross = dataclasses.replace(cfg, pattern=(LayerSpec("attn", "dense",
                                                        True),))
    model = Model(cross, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValidationError, match="enc_out"):
        model.forward(params, {"tokens": torch.zeros((1, 8),
                                                     dtype=torch.int64)})
    assert len(ARCH_IDS) == 10


def test_params_from_arrays_rejects_a_wrong_tree(pair):
    cfg, model, params, jm, jp = pair
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"]["embedding"] = tree["embed"]["embedding"][:, :-1]
    with pytest.raises(ValidationError):
        model_params_from_arrays(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    del tree["final_norm"]
    with pytest.raises(ValidationError):
        model_params_from_arrays(tree, cfg, device="cpu")


def test_cross_entropy_equals_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 8, 40)).astype(np.float32) * 3
    labels = rng.integers(-1, 40, (2, 8)).astype(np.int32)
    mask = (rng.random((2, 8)) > 0.3).astype(np.int32)
    for m in (None, mask):
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_serve_launcher_on_the_cpu(capsys):
    serve_launcher.main(["--arch", "smollm-360m", "--reduced", "--device",
                         "cpu", "--requests", "3", "--slots", "2",
                         "--prompt-len", "64", "--max-new", "2",
                         "--max-len", "80"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out
    assert "flash kernel launches 0" in out     # plain versions on the CPU
