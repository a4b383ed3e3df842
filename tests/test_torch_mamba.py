"""The port's Mamba-2 (SSD) mixer against the JAX package
(``repro/models/mamba.py``).

* ``_causal_conv`` with and without a history.
* ``_ssd_chunked`` at s = 64 and 128 (one chunk) and 200 padded to 256
  (two chunks of 128, dt = 0 in the pad, so its decay is 1), from a
  nonzero state: outputs and final states within 2e-4.
* ``mamba_layer`` at reduced mamba2-2.7b: a parallel prefill at s = 64,
  128 and 200 (L = 128 and a pad of 56), stateless and from the zero
  state, then three decode steps from the prefill state: outputs and all
  four state leaves (h, conv_x, conv_B, conv_C) within 2e-4.
* Reduced mamba2-2.7b (attention-free) and jamba-1.5-large-398b (the
  8-layer hybrid block: attention at index 4, MoE on odd layers) whole:
  forward, prefill and decode, and the serve engine
  (``_torch_model_parity``); the stacked state cache's layout; mamba2 also
  with a 200-token prompt.

Inputs are made with numpy from a seed; the JAX reference runs on the CPU
with an inert ``Sharder()``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_parity import (TOL, check_forward, check_prefill_and_decode,
                                 check_serve_engine, reduced_pair)
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import mamba as jax_mamba
from repro.parallel.sharding import Sharder
from repro_torch.configs import get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.errors import ValidationError
from repro_torch.models import mamba

jax.config.update("jax_platform_name", "cpu")

MAMBA2 = "mamba2-2.7b"


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _configs():
    return (reduce_config(get_config(MAMBA2)),
            jax_reduce_config(jax_get_config(MAMBA2)))


@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_equals_jax(history):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 5)).astype(np.float32)
    w = rng.standard_normal((4, 3, 5)).astype(np.float32)
    hist = rng.standard_normal((2, 3, 3, 5)).astype(np.float32) \
        if history else None
    want, want_hist = jax_mamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if hist is None else jnp.asarray(hist))
    got, got_hist = mamba._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w),
        None if hist is None else torch.from_numpy(hist))
    _close(got, want)
    np.testing.assert_array_equal(got_hist.numpy(), np.asarray(want_hist))


def _ssd_inputs(s, seed, hm=4, p=8, n=16, b=2):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, hm, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, hm)))).astype(np.float32)
    a_log = rng.standard_normal(hm).astype(np.float32) * 0.5
    bm = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    cm = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    h0 = rng.standard_normal((b, hm, n, p)).astype(np.float32)
    return xh, dt, a_log, bm, cm, h0


@pytest.mark.parametrize("s", [64, 128, 200])
def test_ssd_chunked_equals_jax(s):
    xh, dt, a_log, bm, cm, h0 = _ssd_inputs(s, seed=s)
    pad = (-s) % min(mamba.CHUNK, s)
    if pad:     # as mamba_layer pads: zeros, so dt = 0 and decay 1 there
        xh, dt, bm, cm = (np.pad(t, [(0, 0), (0, pad)]
                                 + [(0, 0)] * (t.ndim - 2))
                          for t in (xh, dt, bm, cm))
    want_y, want_h = jax_mamba._ssd_chunked(*map(jnp.asarray, (
        xh, dt, a_log, bm, cm, h0)))
    got_y, got_h = mamba._ssd_chunked(*map(torch.from_numpy, (
        xh, dt, a_log, bm, cm, h0)))
    assert got_y.shape == want_y.shape and got_h.shape == want_h.shape
    _close(got_y, want_y)
    _close(got_h, want_h)


def _layer_params(cfg, seed):
    """Seeded mixer parameters with nonzero dt_bias and A_log (the model's
    initializer leaves them zero)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in mamba.mamba_defs(cfg).items():
        if d.init == "ones":
            out[name] = np.ones(d.shape, np.float32)
        else:
            fan_in = d.scale_dim or d.shape[0]
            out[name] = (rng.standard_normal(d.shape)
                         / np.sqrt(fan_in)).astype(np.float32)
    return out


def _states_close(got, want):
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape
        _close(g, w)


@pytest.mark.parametrize("s", [64, 128, 200])
def test_mamba_layer_prefill_and_decode_equal_jax(s):
    cfg, jcfg = _configs()
    params = _layer_params(cfg, seed=7)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)

    want, _ = jax_mamba.mamba_layer(jparams, jnp.asarray(x), jcfg, Sharder())
    got, none = mamba.mamba_layer(tparams, torch.from_numpy(x), cfg)
    assert none is None
    _close(got, want)

    jstate = jax_mamba.init_mamba_state(jcfg, 2)
    state = mamba.init_mamba_state(cfg, 2, device="cpu")
    want, jstate = jax_mamba.mamba_layer(jparams, jnp.asarray(x), jcfg,
                                         Sharder(), state=jstate)
    got, state = mamba.mamba_layer(tparams, torch.from_numpy(x), cfg,
                                   state=state)
    _close(got, want)
    _states_close(state, jstate)
    for step in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, jstate = jax_mamba.mamba_layer(jparams, jnp.asarray(xt), jcfg,
                                             Sharder(), state=jstate)
        got, state = mamba.mamba_layer(tparams, torch.from_numpy(xt), cfg,
                                       state=state)
        _close(got, want)
    _states_close(state, jstate)


@pytest.fixture(scope="module", params=[MAMBA2, "jamba-1.5-large-398b"])
def pair(request):
    return reduced_pair(request.param)


def test_state_cache_layout_equals_jax(pair):
    cfg, model, params, jm, jp = pair
    cache, jcache = model.init_cache(3, 40), jm.init_cache(3, 40)
    assert cache.keys() == jcache.keys()
    for name, spec in zip(cache, cfg.pattern):
        assert type(cache[name]).__name__ == type(jcache[name]).__name__
        for got, want in zip(cache[name], jcache[name]):
            assert tuple(got.shape) == np.asarray(want).shape
            if spec.mixer == "mamba":
                assert got.dtype == torch.float32 and not got.any()


def test_mamba_leaves_carry_over(pair):
    cfg, model, params, jm, jp = pair
    i = [s.mixer for s in cfg.pattern].index("mamba")
    mixer = params["blocks"][f"layer{i}"]["mixer"]
    hm, p = cfg.mamba_heads, cfg.mamba_head_dim
    assert mixer["w_out"].shape == (cfg.num_blocks, hm, p, cfg.d_model)
    assert mixer["conv_x"].shape == (cfg.num_blocks, cfg.mamba_conv, hm, p)
    tree = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(
        mixer["conv_x"].numpy(), tree["blocks"][f"layer{i}"]["mixer"]["conv_x"])
    tree["blocks"][f"layer{i}"]["mixer"]["w_out"] = \
        tree["blocks"][f"layer{i}"]["mixer"]["w_out"][:, :, :-1]
    with pytest.raises(ValidationError):
        model_params_from_arrays(tree, cfg, device="cpu")


@pytest.mark.parametrize("seq", [64, 16])
def test_mamba_model_forward_equals_jax(pair, seq):
    check_forward(pair, seq)


def test_mamba_model_prefill_and_decode_equal_jax(pair):
    check_prefill_and_decode(pair, 64)


def test_padded_prompt_through_the_whole_model_equals_jax():
    """A 200-token prompt (L = 128, a pad of 56) through reduced mamba2-2.7b
    whole: forward, prefill and decode.  (Reduced jamba is left out here:
    its seven Mamba layers normalize groups of 8 channels whose rms falls
    to ~4e-3, which amplifies float32 rounding; at 200 tokens the JAX
    model's own logits lie up to 7e-4 from a float64 evaluation.)"""
    pair = reduced_pair(MAMBA2)
    check_forward(pair, 200)
    check_prefill_and_decode(pair, 200)


def test_mamba_model_serve_engine_equals_jax(pair, monkeypatch):
    check_serve_engine(pair, monkeypatch)


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_launcher

    serve_launcher.main(["--arch", MAMBA2, "--reduced", "--device", "cpu",
                         "--requests", "3", "--slots", "2", "--prompt-len",
                         "200", "--max-new", "2", "--max-len", "240"])
    out = capsys.readouterr().out
    assert "3 requests, 6 tokens" in out
    assert "flash kernel launches 0" in out
