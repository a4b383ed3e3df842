"""The port's MoE layer against the JAX package (``repro/models/moe.py``).

* ``sort_based_dispatch``: bins, kept and slots exactly equal to the JAX
  function's (vmapped over the rows) on seeded expert ids, with experts
  over capacity and an empty expert.
* ``moe_layer`` at reduced granite-moe-3b-a800m: output and the three aux
  values within 2e-4 of JAX's at capacity factor 0.25 (records dropped)
  and 8.0 (none dropped); a router with duplicated columns (tied logits)
  gives JAX's choices, the lower expert index first.
* Reduced granite-moe-3b-a800m and grok-1-314b (attention softcap 30)
  whole: forward, prefill and decode, and the serve engine
  (``_torch_model_parity``).
* ``param_count`` and ``active_param_count`` of every registered arch
  at full size equal JAX's (analytic: nothing is allocated).

Inputs are made with numpy from a seed; the JAX reference runs on the CPU
with an inert ``Sharder()``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_model_parity import (TOL, check_forward, check_prefill_and_decode,
                                 check_serve_engine, reduced_pair)
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_config as jax_reduce_config
from repro.models import moe as jax_moe
from repro.parallel.sharding import Sharder
from repro_torch.configs import ARCH_IDS, get_config, reduce_config
from repro_torch.convert import model_params_from_arrays
from repro_torch.core.errors import ValidationError
from repro_torch.models import Model, moe

jax.config.update("jax_platform_name", "cpu")

GRANITE = "granite-moe-3b-a800m"


def _dispatch_ids(seed, rows, records, experts):
    """Seeded expert ids: expert 0 takes a third of each row (over any
    small capacity), the last expert none."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, experts - 1, (rows, records))
    ids[rng.random((rows, records)) < 1 / 3] = 0
    return ids.astype(np.int32)


@pytest.mark.parametrize("capacity", [8, 16, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_based_dispatch_equals_jax(seed, capacity):
    experts = 6
    ids = _dispatch_ids(seed, 3, 96, experts)
    want = jax.vmap(lambda i: jax_moe.sort_based_dispatch(
        i, capacity, experts))(jnp.asarray(ids))
    got = moe.sort_based_dispatch(torch.from_numpy(ids), capacity, experts)
    for g, w, name in zip(got, want, ("bins", "kept", "slot")):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    bins, kept, _ = got
    assert not bool((bins[:, experts - 1] >= 0).any())   # the empty expert
    if capacity < 32:
        assert not bool(kept.all())                       # over capacity


@pytest.mark.parametrize("tokens", [1, 4, 64, 8192])
def test_capacity_equals_jax(tokens):
    for arch in (GRANITE, "grok-1-314b", "jamba-1.5-large-398b"):
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (reduce_config(get_config(arch)),
                           jax_reduce_config(jax_get_config(arch)))):
            assert moe._capacity(tokens, cfg) == jax_moe._capacity(tokens,
                                                                   jcfg)


def _layer_inputs(cfg, seed, tie=False):
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = {
        "router": rng.standard_normal((d, e)).astype(np.float32) / 8,
        "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
        "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
        "w_down": rng.standard_normal((e, f, d)).astype(np.float32)
        / np.sqrt(f),
    }
    if tie:     # experts 0 and 1, 2 and 3 get equal router logits
        params["router"][:, 1] = params["router"][:, 0]
        params["router"][:, 3] = params["router"][:, 2]
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    return params, x


def _both_layers(capacity_factor, tie=False, seed=3):
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config(GRANITE)),
                               moe_capacity_factor=capacity_factor)
    cfg = dataclasses.replace(reduce_config(get_config(GRANITE)),
                              moe_capacity_factor=capacity_factor)
    params, x = _layer_inputs(cfg, seed, tie)
    want = jax_moe.moe_layer(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jcfg, Sharder())
    got = moe.moe_layer({k: torch.from_numpy(v) for k, v in params.items()},
                        torch.from_numpy(x), cfg)
    return got, want


@pytest.mark.parametrize("capacity_factor", [0.25, 8.0])
def test_moe_layer_equals_jax(capacity_factor):
    (out, aux), (jout, jaux) = _both_layers(capacity_factor)
    assert out.shape == jout.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert aux.keys() == jaux.keys()
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   **TOL)
    dropped = float(aux["moe_drop_fraction"])
    assert (dropped > 0.5) if capacity_factor < 1 else (dropped == 0.0)


def test_moe_ties_take_the_lower_expert_first_as_jax():
    cfg = reduce_config(get_config(GRANITE))
    params, x = _layer_inputs(cfg, 5, tie=True)
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x),
                        jnp.asarray(params["router"]))
    probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    assert (probs[..., 0] == probs[..., 1]).all()        # every token tied
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs),
                                        cfg.num_experts_per_token)
    vals, idx = moe.top_k(torch.from_numpy(probs.copy()),
                          cfg.num_experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))
    assert (idx[..., 0] < idx[..., 1]).all()             # ties: lower first
    (out, aux), (jout, jaux) = _both_layers(8.0, tie=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   **TOL)


@pytest.mark.parametrize("mode", ["ep", "cap", "ffn", "bogus"])
def test_mesh_modes_raise(mode):
    """Without a mesh: an explicit mesh mode is what ``select_moe_mode``
    returns (the JAX rule), and a Model without a sharder refuses it; an
    unknown mode raises from both.  ``auto`` and ``gspmd`` take the
    einsum path."""
    cfg = dataclasses.replace(reduce_config(get_config(GRANITE)),
                              moe_impl=mode)
    if mode == "bogus":
        with pytest.raises(ValidationError):
            moe.select_moe_mode(cfg)
    else:
        assert moe.select_moe_mode(cfg, None, 8) == mode
    with pytest.raises(ValidationError):
        Model(cfg, device="cpu")
    for ok in ("auto", "gspmd"):
        assert moe.select_moe_mode(dataclasses.replace(cfg, moe_impl=ok)) \
            == "gspmd"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_jax_at_full_size(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for field in ("num_experts", "num_experts_per_token",
                  "moe_capacity_factor", "moe_group_rows", "moe_impl",
                  "ssm_state", "mamba_head_dim", "mamba_expand",
                  "mamba_conv", "d_inner", "mamba_heads"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert [dataclasses.astuple(s) for s in cfg.pattern] \
        == [dataclasses.astuple(s) for s in jcfg.pattern]


@pytest.fixture(scope="module", params=[GRANITE, "grok-1-314b"])
def pair(request):
    return reduced_pair(request.param)


def test_expert_leaves_carry_over(pair):
    cfg, model, params, jm, jp = pair
    w = params["blocks"]["layer0"]["mlp"]["w_gate"]
    assert w.shape == (cfg.num_blocks, cfg.num_experts, cfg.d_model,
                       cfg.d_ff)
    tree = jax.tree.map(np.asarray, jp)
    np.testing.assert_array_equal(
        w.numpy(), tree["blocks"]["layer0"]["mlp"]["w_gate"])
    tree["blocks"]["layer0"]["mlp"]["w_down"] = \
        tree["blocks"]["layer0"]["mlp"]["w_down"][:, :-1]
    with pytest.raises(ValidationError):
        model_params_from_arrays(tree, cfg, device="cpu")


@pytest.mark.parametrize("seq", [64, 16])
def test_moe_model_forward_equals_jax(pair, seq):
    check_forward(pair, seq)


def test_moe_model_prefill_and_decode_equal_jax(pair):
    check_prefill_and_decode(pair, 64)


def test_moe_model_serve_engine_equals_jax(pair, monkeypatch):
    check_serve_engine(pair, monkeypatch)


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_launcher

    serve_launcher.main(["--arch", GRANITE, "--reduced", "--device", "cpu",
                         "--requests", "3", "--slots", "2", "--prompt-len",
                         "64", "--max-new", "2", "--max-len", "80"])
    out = capsys.readouterr().out
    cfg = reduce_config(get_config(GRANITE))
    assert f"{cfg.active_param_count() / 1e6:.1f}M active" in out
    assert cfg.active_param_count() < cfg.param_count()
    assert "3 requests, 6 tokens" in out
    assert "flash kernel launches 0" in out     # plain versions on the CPU
