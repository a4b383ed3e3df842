"""granite-4.0-h-small's hybrid Mamba-2 / attention MoE stage in the port
against the benchmark's plain float32 reference
(``gpubench/reference/hybrid_decoder.py``), on the CPU at a test size: d
64, a period of 10 layers with attention at index 5, 8 experts top-2 with
a shared expert of width 32, 4 Mamba heads of 32, state 16, float32,
weights drawn from a seed in the reference's layout (wq and wk scaled so
that the scores spread by a few units, as the benchmark draws them) and
handed to the port as views (the benchmark's ``port_params``).

* Prefill: the last logits, every Mamba layer's final state and conv
  history, the attention layer's K/V and its output before ``Wo``.
* Prefill then 4 decode steps through the hybrid cache (drop-free
  capacity), against the reference's full forward over prompt and
  generated tokens: logits.
* The reference's SSD (the quadratic dual form in blocks of queries)
  against the recurrence step by step.
* Five controls each measurably off: fp8 products (the reference's), the
  per-head gated norm, no shared expert, rope applied, the score scale
  head_dim**-0.5.
* The new ``ModelConfig`` fields at their defaults: reduced
  granite-moe-3b's and mamba2-2.7b's parameter trees and their prefill
  and decode logits are bit-equal to those with each field set to the
  value that names the arithmetic before it (the embedding scale √d, the
  score scale head_dim**-0.5, rope on, no shared expert, no conv bias,
  the per-head gated norm).
* The spans a hybrid prefill records, and the registry's port-only arch.
"""
import dataclasses
import pathlib
import sys

import pytest
import torch

from repro_torch.configs import (ARCH_IDS, PORT_ONLY_ARCH_IDS, get_config,
                                 reduce_config)
from repro_torch.models import attention
from repro_torch.models.api import iter_leaves
from repro_torch.models.transformer import Model
from repro_torch.perf import spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from gpubench.lib import hybrid  # noqa: E402
from gpubench.reference import hybrid_decoder as ref  # noqa: E402

ARCH = "granite-4.0-h-small"
TOL = 2e-4          # float32 port against the float32 reference
OFF = 1e-2          # what a control must at least move


def _config(**kw):
    return dataclasses.replace(
        get_config(ARCH), num_layers=10, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=515, num_experts=8,
        num_experts_per_token=2, moe_shared_ff=32, ssm_state=16,
        mamba_head_dim=32, dtype=torch.float32, attn_block_q=32,
        attn_block_k=32, vocab_pad_multiple=64, **kw)


def _spec(cfg):
    return {
        "layer_types": ["mamba" if s.mixer == "mamba" else "attention"
                        for s in cfg.pattern],
        "d": cfg.d_model, "heads": cfg.num_heads,
        "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
        "experts": cfg.num_experts, "top_k": cfg.num_experts_per_token,
        "ffn": cfg.d_ff, "shared_ffn": cfg.moe_shared_ff,
        "mamba_heads": cfg.mamba_heads, "mamba_head_dim": cfg.mamba_head_dim,
        "d_state": cfg.ssm_state, "conv": cfg.mamba_conv,
        "vocab": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "logits_scaling": cfg.logits_scaling,
        "capacity_factor": cfg.moe_capacity_factor,
        "group_rows": cfg.moe_group_rows,
    }


def _weights(spec, padded_vocab, seed=5):
    """The reference's weights: the products normal with std 1/sqrt(their
    leading size), wq and wk times the benchmark's ``qk_gain``, norms,
    biases and D - 1 with std 0.1; exp(A_log) uniform in [1, 16], dt_bias
    in [-5, -1]."""
    g = torch.Generator().manual_seed(seed)
    gain = hybrid.qk_gain(spec)

    def draw(name, shape):
        t = torch.randn(shape, generator=g)
        if name == "A_log":
            return torch.rand(shape, generator=g).mul(15).add(1).log()
        if name == "dt_bias":
            return torch.rand(shape, generator=g).mul(-4).add(-1)
        if name == "D_skip":
            return 1 + 0.1 * t
        if len(shape) == 1 or name.endswith("_bias") or name == "norm_scale":
            return 0.1 * t
        return t / shape[0] ** 0.5 * (gain if name in ("wq", "wk") else 1)

    w = {"embedding": draw("embedding", (padded_vocab, spec["d"])),
         "final_norm": draw("final_norm", (spec["d"],)), "layers": []}
    for kind in spec["layer_types"]:
        names = dict(ref.COMMON, **(ref.MAMBA if kind == "mamba"
                                    else ref.ATTENTION))
        w["layers"].append({n: draw(n, tuple(ref.size(spec, e) for e in s))
                            for n, s in names.items()})
    return w


def _setup(**kw):
    cfg = _config(**kw)
    spec = _spec(cfg)
    w = _weights(spec, cfg.padded_vocab)
    model = Model(cfg, device="cpu")
    return cfg, spec, w, model, hybrid.port_params(w, model)


def _tokens(rows, seq, seed):
    return torch.randint(0, 515, (rows, seq),
                         generator=torch.Generator().manual_seed(seed))


def _rel(want, got):
    return float((got - want).norm() / want.norm())


def _errors(model, params, w, spec, tokens, monkeypatch, quant=None):
    """The port's prefill against the reference: the largest relative
    error of the last logits, of every Mamba layer's state and conv
    history, of the attention layers' K and V, and of their output before
    ``Wo``."""
    rows, seq = tokens.shape
    outs, real = [], attention._output

    def tap(o, wo, dt):
        outs.append(o)
        return real(o, wo, dt)

    with monkeypatch.context() as m:
        m.setattr(attention, "_output", tap)
        cache, logits = model.prefill(params, {"tokens": tokens},
                                      model.init_cache(rows, seq + 1))
    err = {"state": 0.0, "conv": 0.0, "kv": 0.0, "attn": 0.0}
    attn_layers = [i for i, t in enumerate(spec["layer_types"])
                   if t == "attention"]
    assert len(outs) == len(attn_layers)
    outs = dict(zip(attn_layers, outs))

    def on_attn(li, row, o):
        err["attn"] = max(err["attn"],
                          _rel(o, outs[li][row].transpose(0, 1)))

    def on_state(li, row, state, history):
        ms = cache[f"layer{li}"]
        err["state"] = max(err["state"], _rel(state, ms.h[0, row]))
        err["conv"] = max(err["conv"], max(
            _rel(want, got[0, row]) for want, got in zip(history, ms[1:])))

    def on_kv(li, row, k, v):
        kv = cache[f"layer{li}"]
        err["kv"] = max(err["kv"], _rel(k, kv.k[0, row, :, :seq].transpose(
            0, 1)), _rel(v, kv.v[0, row, :, :seq].transpose(0, 1)))

    want = ref.forward(w, tokens, spec, quant=quant, on_state=on_state,
                       on_kv=on_kv, on_attn=on_attn)
    err["logits"] = _rel(want, logits[:, 0, :spec["vocab"]])
    return err


@pytest.mark.parametrize("rows,seq,factor", [(2, 64, 1.25), (3, 40, 1.25),
                                             (1, 200, 8.0)])
def test_prefill_equals_the_reference(rows, seq, factor, monkeypatch):
    """Capacity drops included at 1.25; seq 200 pads the SSD's last chunk
    (two chunks of 128); 64 and 200 take the flash path's plain version,
    40 the dense path."""
    _, spec, w, model, params = _setup(moe_capacity_factor=factor)
    err = _errors(model, params, w, spec, _tokens(rows, seq, rows),
                  monkeypatch)
    assert max(err.values()) < TOL, err


def test_prefill_then_decode_equals_the_full_forward():
    """Four greedy decode steps through the stacked cache (nine
    ``MambaState``s and one ``KVCache``), each step's logits against the
    reference's over the prompt and the tokens so far (drop-free
    capacity: a decode step's dispatch group is its own)."""
    cfg, spec, w, model, params = _setup(moe_capacity_factor=8.0)
    seqs = _tokens(2, 64, 9)
    cache, logits = model.prefill(params, {"tokens": seqs},
                                  model.init_cache(2, 70))
    for step in range(4):
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        seqs = torch.cat([seqs, nxt], dim=1)
        cache, logits = model.decode_step(params, nxt, cache, 64 + step)
        want = ref.forward(w, seqs, spec, last_only=False)[:, -1]
        assert _rel(want, logits[:, 0, :cfg.vocab_size]) < TOL, step


@pytest.mark.parametrize("seq,block", [(64, 16), (300, 64), (200, 1000)])
def test_the_reference_ssd_equals_the_recurrence(seq, block):
    g = torch.Generator().manual_seed(seq)
    x = torch.randn(seq, 4, 8, generator=g)
    dt = torch.rand(seq, 4, generator=g) * 0.5
    a = -torch.rand(4, generator=g) * 15 - 1
    bm, cm = torch.randn(seq, 16, generator=g), torch.randn(seq, 16,
                                                             generator=g)
    y1, s1 = ref.ssd_recurrent(x, dt, a, bm, cm)
    y2, s2 = ref.ssd(x, dt, a, bm, cm, block=block)
    assert _rel(y1, y2) < 1e-5 and _rel(s1, s2) < 1e-5


@pytest.mark.parametrize("control", ["fp8", "head_norm", "no_shared",
                                     "rope", "scale"])
def test_each_control_is_measurably_off(control, monkeypatch):
    """Each control moves the compared values by at least ``OFF`` where
    the program lies within ``TOL``: fp8 products (the reference's
    ``fp8_e4m3``), the per-head gated norm (``mamba_norm_groups`` 0), the
    routed experts alone (``moe_shared_ff`` 0), rope on q and k, the
    scores scaled by head_dim**-0.5; the attention controls move the
    attention layer's output."""
    fields = {"head_norm": {"mamba_norm_groups": 0},
              "no_shared": {"moe_shared_ff": 0},
              "rope": {"use_rope": True},
              "scale": {"attention_multiplier": None}}.get(control, {})
    _, spec, w, model, params = _setup()
    model.cfg = dataclasses.replace(model.cfg, **fields)
    err = _errors(model, params, w, spec, _tokens(2, 64, 3), monkeypatch,
                  quant=ref.fp8_e4m3 if control == "fp8" else None)
    assert max(err.values()) > OFF, err
    if control in ("rope", "scale"):
        assert err["attn"] > OFF, err


def test_norm_groups_of_one_head_are_the_per_head_norm():
    cfg, spec, w, model, params = _setup()
    tokens = _tokens(2, 64, 4)
    per_head = model.prefill(params, {"tokens": tokens},
                             model.init_cache(2, 65))[1]
    model.cfg = dataclasses.replace(cfg, mamba_norm_groups=cfg.mamba_heads)
    grouped = model.prefill(params, {"tokens": tokens},
                            model.init_cache(2, 65))[1]
    model.cfg = dataclasses.replace(cfg, mamba_norm_groups=0)
    heads = model.prefill(params, {"tokens": tokens},
                          model.init_cache(2, 65))[1]
    assert torch.equal(grouped, heads) and not torch.equal(per_head, heads)


# each new field at the value that names the arithmetic before it
EXPLICIT = {
    "embedding_multiplier": lambda cfg: cfg.d_model ** 0.5,
    "attention_multiplier": lambda cfg: cfg.head_dim ** -0.5,
    "residual_multiplier": lambda cfg: 1.0,
    "logits_scaling": lambda cfg: 1.0,
    "use_rope": lambda cfg: True,
    "moe_shared_ff": lambda cfg: 0,
    "mamba_conv_bias": lambda cfg: False,
    "mamba_norm_groups": lambda cfg: 0,
}


def _serve(model, params, tokens):
    """The logits of a prefill of ``tokens`` and two greedy decode steps."""
    rows, seq = tokens.shape
    cache, logits = model.prefill(params, {"tokens": tokens},
                                  model.init_cache(rows, seq + 2))
    out = [logits]
    for step in range(2):
        nxt = logits[:, -1].argmax(-1)[:, None]
        cache, logits = model.decode_step(params, nxt, cache, seq + step)
        out.append(logits)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-2.7b"])
def test_the_new_fields_at_their_defaults_change_no_operation(arch):
    cfg = reduce_config(get_config(arch))
    assert all(getattr(cfg, f) == v(cfg) or getattr(cfg, f) is None
               for f, v in EXPLICIT.items())
    model = Model(cfg, device="cpu")
    explicit = dataclasses.replace(cfg, **{f: v(cfg)
                                           for f, v in EXPLICIT.items()})
    assert [(p, d.shape) for p, d in iter_leaves(model.defs())] \
        == [(p, d.shape) for p, d in iter_leaves(Model(explicit).defs())]
    params = model.init(torch.Generator().manual_seed(0))
    tokens = _tokens(2, 64, 1)
    with torch.no_grad():
        base = _serve(model, params, tokens)
        model.cfg = explicit
        assert torch.equal(_serve(model, params, tokens), base)


def test_a_hybrid_prefill_records_its_spans_and_pad_counter():
    cfg, spec, w, model, params = _setup()
    spans.reset()
    spans.enable()
    try:
        model.prefill(params, {"tokens": _tokens(2, 200, 6)},
                      model.init_cache(2, 201))
        snap = spans.snapshot()
    finally:
        spans.disable()
        spans.reset()
    names = [r.name for r in snap.spans]
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern)
    for name in ("mamba.proj", "mamba.conv", "mamba.ssd", "mamba.scan",
                 "mamba.out"):
        assert names.count(name) == mamba, name
    assert names.count("moe.shared") == cfg.num_layers
    assert all(r.parent == "mamba.ssd" for r in snap.spans
               if r.name == "mamba.scan")
    pads = [c.value for c in snap.counts if c.name == "mamba.pad_tokens"]
    assert pads == [2 * (-200 % 128)] * mamba


def test_the_port_only_arch_is_registered_apart_from_the_jax_archs():
    assert ARCH in PORT_ONLY_ARCH_IDS and ARCH not in ARCH_IDS
    assert len(ARCH_IDS) == 10
    cfg = get_config(ARCH)
    assert cfg.num_layers == 40 and cfg.mamba_heads == 128
    assert [s.mixer for s in cfg.pattern].index("attn") == 5
    assert 32.0e9 < cfg.param_count() < 32.5e9
    small = reduce_config(cfg)
    model = Model(small, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    _, logits = model.prefill(params, {"tokens": _tokens(2, 40, 7)},
                              model.init_cache(2, 41))
    assert logits.shape == (2, 1, small.padded_vocab)
    assert torch.isfinite(logits[..., :small.vocab_size]).all()
