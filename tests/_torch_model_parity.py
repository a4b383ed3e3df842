"""Whole-model parity of the port against the JAX package, shared by
``test_torch_moe.py`` and ``test_torch_mamba.py``.

A reduced config (``reduce_config``: float32, blocks of 32, 4 experts
top-2 at capacity factor 8, Mamba state 16 and head width 8) is built in
both packages.  Its parameters are drawn with numpy from a seed, with the
initializer's distributions (the JAX ``Model.init`` folds Python's
per-process string hash into its keys, so its draws change from run to
run), handed to the JAX model as arrays and carried over to the port with
``model_params_from_arrays``; token batches are made with numpy from a
seed.  ``forward`` logits and MoE aux, ``prefill`` logits and caches, four
teacher-forced ``decode_step``s (fed the JAX run's tokens) and a
``ServeEngine`` run must agree with the JAX model within 2e-4, the bound
of ``tests/test_models_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import Model as JaxModel
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.models import Model
from repro_torch.models.api import iter_leaves
from repro_torch.models.transformer import model_defs
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_STEPS = 4


def numpy_params(cfg, seed: int):
    """A JAX-layout parameter tree of numpy float32 arrays for ``cfg``:
    norm scales and zero-initialized leaves 0, ``ones`` leaves 1, the rest
    normal with std 1/sqrt(fan-in) (the embedding's fan-in its width)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, d in iter_leaves(model_defs(cfg)):
        if d.init in ("zeros", "scale"):
            arr = np.zeros(d.shape, np.float32)
        elif d.init == "ones":
            arr = np.ones(d.shape, np.float32)
        else:
            fan_in = d.shape[-1] if d.init == "embed" else (
                d.scale_dim if d.scale_dim is not None else d.shape[0])
            arr = (rng.standard_normal(d.shape)
                   / np.sqrt(max(fan_in, 1))).astype(np.float32)
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def reduced_pair(arch: str, seed: int = 0):
    """(port cfg, port model, port params, JAX model, JAX params) of the
    reduced ``arch``, both holding the parameters of ``numpy_params``."""
    jcfg, cfg = jax_reduce_config(jax_get_config(arch)), \
        reduce_config(get_config(arch))
    tree = numpy_params(cfg, seed)
    params = model_params_from_arrays(tree, cfg, device="cpu")
    return (cfg, Model(cfg, device="cpu"), params, JaxModel(jcfg),
            jax.tree.map(jnp.asarray, tree))


def tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def close(got: torch.Tensor, want, vocab=None):
    got, want = got.numpy(), np.asarray(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, **TOL)


def check_forward(pair, seq):
    """Logits and the summed MoE [aux, z] losses equal the JAX forward's."""
    cfg, model, params, jm, jp = pair
    toks = tokens(cfg, 2, seq, seed=seq)
    want, want_aux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward_with_aux(params,
                                      {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, seq, cfg.padded_vocab)
    close(got, want, cfg.vocab_size)
    close(aux, want_aux)
    assert torch.equal(model.forward(params, {"tokens": torch.from_numpy(
        toks)}), got)


def same_caches(cache, jcache):
    """Every leaf of the port's stacked caches (KVCache: k, v, length;
    MambaState: h, conv_x, conv_B, conv_C) equals the JAX cache's."""
    assert cache.keys() == jcache.keys()
    for name in cache:
        assert type(cache[name]).__name__ == type(jcache[name]).__name__
        assert cache[name]._fields == jcache[name]._fields
        for got, want in zip(cache[name], jcache[name]):
            assert got.shape == np.asarray(want).shape
            if got.dtype == torch.int32:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                close(got, want)


def check_prefill_and_decode(pair, seq):
    """``prefill`` then DECODE_STEPS teacher-forced ``decode_step``s: logits
    and every cache leaf equal the JAX model's."""
    cfg, model, params, jm, jp = pair
    toks = tokens(cfg, 2, seq, seed=100 + seq)
    max_len = seq + DECODE_STEPS + 4
    jcache, jlog = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                       jm.init_cache(2, max_len))
    cache, log = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                               model.init_cache(2, max_len))
    assert log.shape == (2, 1, cfg.padded_vocab)
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


def _waves(engine, monkeypatch):
    waves = []
    real = engine._run_wave

    def record(wave):
        waves.append([r.rid for r in wave])
        return real(wave)

    monkeypatch.setattr(engine, "_run_wave", record)
    return waves


def check_serve_engine(pair, monkeypatch):
    """A mixed-length queue through both engines: the same waves and the
    same greedy tokens, request by request."""
    cfg, model, params, jm, jp = pair
    rng = np.random.default_rng(11)
    queue = [(rid, rng.integers(1, cfg.vocab_size, n).tolist(), budget)
             for rid, (n, budget) in enumerate(zip(
                 [16, 24, 16, 64, 16, 24, 64], [3, 5, 2, 4, 6, 1, 3]))]
    jeng = JaxServeEngine(jm, jp, num_slots=3, max_len=80)
    eng = ServeEngine(model, params, num_slots=3, max_len=80, device="cpu")
    jwaves, waves = _waves(jeng, monkeypatch), _waves(eng, monkeypatch)
    for rid, prompt, budget in queue:
        jeng.submit(JaxRequest(rid, prompt, budget))
        eng.submit(Request(rid, prompt, budget))
    want, got = jeng.run(), eng.run()
    assert waves == jwaves
    assert list(got) == list(want)
    for rid, res in got.items():
        assert len(res.tokens) == queue[rid][2]
        assert res.tokens == want[rid].tokens, rid
