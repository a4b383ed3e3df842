"""Closed-loop prefill serving of a hybrid Mamba-2 / attention MoE model
(``granitemoehybrid``) through the port's ``ServeEngine``: one engine
wave fills a stacked cache that holds a float32 ``MambaState`` for each
Mamba-2 layer and a ``KVCache`` for each attention layer, side by side.

The closed loop, its window and its end-to-end metrics are
``serve_prefill``'s (``prefill_tokens_per_s``, ``ttft_p95_ms``), as is
the sample of the window's waves the check reads (:func:`_keep`): the last
position's logits of ``logit_waves`` waves, and of ``kv_waves`` of those
the whole cache the prefill filled and its attention outputs, here copied
into buffers of set-up.

The check.  Once the window closed, the sampled waves' prompts go through
the plain float32 reference (``reference/hybrid_decoder.py``) with the
same weights, and:

* ``logit_err``: the median over the rows of the ``logit_waves`` waves of
  the relative L2 distance of the last position's logits to the
  reference's;
* ``kv_err``: over the rows of the ``kv_waves`` waves, the largest row
  error of the attention layers' keys and values (the median over the
  row's tokens of a token's relative L2 distance over its KV heads; the
  larger of keys and values);
* ``attn_err``: over the same rows, the largest row error, measured as
  ``kv_err``'s over a token's 32 query heads, of the attention layers'
  output before ``Wo`` (the flash kernel's): its score scale, causal mask
  and softmax.  The weights give the scores a spread of a few units
  (``lib/hybrid.SCORE_STD``), so the softmax is not a mean of V;
* ``state_err``: over every Mamba-2 layer, the largest of the median over
  the same rows of a row's error: the relative L2 distance of its final
  SSM state, or of its conv history (the last K-1 inputs of x, B and C),
  to the reference's (the larger of the two): what a decode step resumes
  from.  The median, as ``kv_err``'s over a row's tokens: a final state
  weighs the last tokens most (a head's decay reaches e^-8 a token), and
  a routing choice flipped by rounding at one of them swings a row's
  state;
* ``state_worst_row``: the largest row's error of the first Mamba-2
  layer, which no routing choice precedes, so that rounding alone moves
  every row: a fault of one slot's state or conv history;
* ``token_gap_excess``: over the rows of the logit waves, the largest gap
  by which the served token's reference logit lies below the reference's
  best beyond twice the row's largest logit error.

Controls (:data:`CONTROLS`), each put in the program's place after
set-up and judged as the program is: ``fp8``, the reference with every
product's operands in float8 e4m3 serves the waves (``control_hook``,
what ``calibrate.py`` runs); ``head_norm``, the port with its gated norm
over each head's 64 channels (``mamba_norm_groups`` 0, the default of
the port's other Mamba configs); ``no_shared``, the port without the
shared expert; ``rope``, the port with rope on q and k at ``rope_theta``;
``scale``, the port scoring at ``head_dim**-0.5`` (the port's default)
in place of ``attention_multiplier``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import sys
from typing import Dict

import numpy as np

from gpubench.drivers.serve_prefill import (State, _logit_readings,
                                            _token_err, _wave, window)
from gpubench.gen.prompts import PromptStream
from gpubench.lib import hybrid
from gpubench.lib.common import seed_stream
from gpubench.reference import hybrid_decoder

READINGS = ("logit_err", "kv_err", "attn_err", "state_err",
            "state_worst_row", "token_gap_excess")


@contextlib.contextmanager
def _attention_tap(outs):
    """While it is open, each attention layer of the port appends its
    output before ``Wo`` ((B, H, S, D), the tensor the port computed) to
    ``outs``, in layer order."""
    from repro_torch.models import attention

    real = attention._output

    def tap(o, wo, dt):
        outs.append(o)
        return real(o, wo, dt)

    attention._output = tap
    try:
        yield
    finally:
        attention._output = real


def setup(ctx) -> State:
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ServeEngine

    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    if int(tr["slots"]) != int(tr["clients"]):
        raise ValueError("serve_prefill_hybrid runs one engine wave a "
                         "round: slots must equal clients")
    if int(tr["kv_waves"]) > int(tr["logit_waves"]):
        raise ValueError("kv_waves are a part of logit_waves")
    # the model first: a port without the hybrid's fields fails here,
    # before any weight is drawn
    model = Model(hybrid.model_config(cfg), device=ctx.device)
    weights = hybrid.make_weights(cfg, seed_stream(ctx.seed, "weights"),
                                  ctx.device, torch)
    params = hybrid.port_params(weights, model)
    engine = ServeEngine(model, params, num_slots=int(tr["slots"]),
                         max_len=int(tr["prompt_len"])
                         + int(tr["output_tokens"]), device=ctx.device)
    st = State(model=model, weights=weights, engine=engine, sample={},
               attn=[], tapped_all=True,
               waves_seen=0, capture=False, sync_prefill=False, next_rid=0,
               real_prefill=model.prefill,
               spec=hybrid_decoder.spec_of(cfg),
               rng=np.random.Generator(np.random.PCG64(
                   seed_stream(ctx.seed, "check"))))

    def prefill(params, batch, cache):
        st.attn = []
        tap = _attention_tap(st.attn) if st.capture \
            else contextlib.nullcontext()
        with ctx.spans.span("model.prefill"), tap:
            cache, logits = st.real_prefill(params, batch, cache)
            if st.sync_prefill:
                ctx.sync()
        if st.capture:
            _keep(st, tr, batch["tokens"], cache, st.attn, logits)
        st.attn = []
        return cache, logits

    model.prefill = prefill
    vocab = int(cfg["vocab_size"])
    warm = PromptStream(ctx.seed, "warmup", vocab, tr["prompt_len"])
    for _ in range(int(tr["warmup_waves"])):
        _wave(st, warm, ctx)
    # the buffers the window's sample is copied into, allocated now: the
    # engine's own cache and outputs are then freed at each wave's end and
    # taken again by the next, and the window calls no cudaMalloc
    mc, rows, s = model.cfg, int(tr["slots"]), int(tr["prompt_len"])
    out_shape = (rows, mc.num_heads, s, mc.head_dim)
    attn_layers = sum(spec.mixer == "attn" for spec in mc.pattern)
    st.free_logit = [
        (torch.empty((rows, s), dtype=torch.int64, device=ctx.device),
         torch.empty((rows, 1, mc.padded_vocab), dtype=torch.float32,
                     device=ctx.device))
        for _ in range(int(tr["logit_waves"]))]
    st.free_kv = [
        (model.init_cache(rows, engine.max_len),
         [torch.empty(out_shape, dtype=mc.dtype, device=ctx.device)
          for _ in range(attn_layers)])
        for _ in range(int(tr["kv_waves"]))]
    ctx.spans.items.clear()
    st.prompts = PromptStream(ctx.seed, "prompts", vocab, tr["prompt_len"])
    return st


def _copy_cache(dst, src) -> None:
    """Each tensor of each layer's cache ``src`` into ``dst``'s."""
    for name, layer in src.items():
        for d, t in zip(dst[name], layer):
            d.copy_(t)


def _keep(st: State, tr, tokens, cache, outs, logits) -> None:
    """``serve_prefill``'s uniform sample of the window's waves (priority
    sampling: each wave draws a key from the seed's stream; the
    ``logit_waves`` smallest keys keep their tokens and logits, the
    ``kv_waves`` smallest of those their caches and attention outputs
    too), copied into the buffers of set-up: a wave that leaves the
    sample, or a cache dropped from it, frees its buffers for the next."""
    key = float(st.rng.random())
    wi = st.waves_seen
    st.waves_seen += 1
    n_logit, n_kv = int(tr["logit_waves"]), int(tr["kv_waves"])
    keys = sorted(st.sample)
    rank = bisect.bisect(keys, key)
    if rank >= n_logit:
        return
    if len(keys) == n_logit:
        _, tok, kept, log = st.sample.pop(keys.pop())
        st.free_logit.append((tok, log))
        if kept is not None:
            st.free_kv.append(kept)
    kept = None
    if rank < n_kv:
        if len(keys) >= n_kv:
            st.free_kv.append(st.sample[keys[n_kv - 1]][2])
            st.sample[keys[n_kv - 1]][2] = None
        kept = st.free_kv.pop()
        st.tapped_all &= len(outs) == len(kept[1])
        _copy_cache(kept[0], cache)
        for d, o in zip(kept[1], outs):
            d.copy_(o)
    tok, log = st.free_logit.pop()
    tok.copy_(tokens)
    log.copy_(logits)
    st.sample[key] = [wi, tok, kept, log]


def _rel(ref, got) -> float:
    return float((got.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def check(st: State, rec: Dict, ctx) -> Dict[str, float]:
    torch = ctx.torch
    vocab = int(ctx.config["vocab_size"])
    bad = {k: float("inf") for k in READINGS}
    sample = sorted(st.sample.values(), key=lambda w: w[0])
    st.sample = {}
    attn_layers = [li for li, t in enumerate(st.spec["layer_types"])
                   if t == "attention"]
    del st.engine, st.model, st.real_prefill
    if ctx.on_card:
        torch.cuda.empty_cache()
    if not st.tapped_all or all(kept is None for _, _, kept, _ in sample):
        print("gpubench: no kept wave, or not one attention output a "
              "layer in each", file=sys.stderr)
        return bad
    kv_rows, attn_rows, state_rows = [], [], {}
    row_err, excess = [], []
    for wi, tokens, kept, logits in sample:
        served = [toks[0] if toks else -1 for toks in rec["served"][wi]]
        if not all(0 <= t < vocab for t in served):
            return bad
        on_kv = on_state = on_attn = None
        if kept is not None:
            cache, outs = kept
            outs = dict(zip(attn_layers, outs))
            s = tokens.shape[1]

            def on_kv(li, row, k, v, cache=cache, s=s):
                kv = cache[f"layer{li}"]
                kv_rows.append(max(
                    _token_err(k, kv.k[0, row, :, :s].float()
                               .transpose(0, 1)),
                    _token_err(v, kv.v[0, row, :, :s].float()
                               .transpose(0, 1))))

            def on_attn(li, row, o, outs=outs):
                attn_rows.append(_token_err(
                    o, outs[li][row].float().transpose(0, 1)))

            def on_state(li, row, state, history, cache=cache):
                ms = cache[f"layer{li}"]
                got = torch.cat([ms.conv_x[0, row].flatten(),
                                 ms.conv_B[0, row].flatten(),
                                 ms.conv_C[0, row].flatten()])
                want = torch.cat([t.flatten() for t in history])
                state_rows.setdefault(li, []).append(max(
                    _rel(state, ms.h[0, row]), _rel(want, got)))
        ref = hybrid_decoder.forward(st.weights, tokens, st.spec,
                                     on_kv=on_kv, on_state=on_state,
                                     on_attn=on_attn)
        e, x = _logit_readings(ref, logits[:, 0, :vocab].float(),
                               torch.tensor(served, device=ref.device))
        row_err += e
        excess += x
    if not kv_rows or not attn_rows or not state_rows:
        return bad
    for what, pick in (("median", np.median), ("largest", max)):
        print(f"gpubench: state error by Mamba layer, {what} row "
              + " ".join(f"{li}:{float(pick(v)):.5f}" for li, v
                         in sorted(state_rows.items())), file=sys.stderr)
    for what, rows in (("kv", kv_rows), ("attention output", attn_rows)):
        print(f"gpubench: {what} error over {len(rows)} rows: median / "
              f"max {float(np.median(rows)):.5f} / {max(rows):.5f}",
              file=sys.stderr)
    print(f"gpubench: logit_err over {len(row_err)} rows: min / median / "
          f"max {min(row_err):.5f} / {float(np.median(row_err)):.5f} / "
          f"{max(row_err):.5f}; token_gap_excess {max(excess)!r}",
          file=sys.stderr)
    return {"logit_err": float(np.median(row_err)),
            "kv_err": max(kv_rows),
            "attn_err": max(attn_rows),
            "state_err": max(float(np.median(v))
                             for v in state_rows.values()),
            "state_worst_row": max(state_rows[min(state_rows)]),
            "token_gap_excess": max(excess)}


def _fp8(driver, st: State) -> None:
    """The reference with every product's operands in float8 e4m3, the
    precision below the configuration's bfloat16, serves each wave: it
    fills the engine's caches and returns its logits as the prefill
    does."""
    import torch

    padded = st.model.cfg.padded_vocab

    def prefill(params, batch, cache):
        tokens = batch["tokens"]
        s = tokens.shape[1]

        def fill_kv(li, row, k, v):
            kv = cache[f"layer{li}"]
            kv.k[0, row, :, :s] = k.transpose(0, 1).to(kv.k.dtype)
            kv.v[0, row, :, :s] = v.transpose(0, 1).to(kv.v.dtype)

        def fill_state(li, row, state, history):
            ms = cache[f"layer{li}"]
            ms.h[0, row] = state
            for dst, src in zip(ms[1:], history):
                dst[0, row] = src

        outs = {}

        def fill_attn(li, row, o):
            outs.setdefault(li, torch.empty(
                (tokens.shape[0],) + o.transpose(0, 1).shape,
                device=o.device))[row] = o.transpose(0, 1)

        logits = hybrid_decoder.forward(st.weights, tokens, st.spec,
                                        on_kv=fill_kv, on_state=fill_state,
                                        on_attn=fill_attn,
                                        quant=hybrid_decoder.fp8_e4m3)
        st.attn.extend(outs[li] for li in sorted(outs))
        logits = torch.nn.functional.pad(logits, (0, padded
                                                  - logits.shape[1]))
        return cache, logits[:, None, :]

    st.real_prefill = prefill


def _port_with(**fields):
    """A control: the port serving with ``fields`` of its configuration
    changed (the engine's model reads its ``cfg`` at every call)."""
    def hook(driver, st: State) -> None:
        st.model.cfg = dataclasses.replace(st.model.cfg, **fields)
    return hook


CONTROLS = {
    "fp8": _fp8,
    "head_norm": _port_with(mamba_norm_groups=0),
    "no_shared": _port_with(moe_shared_ff=0),
    "rope": _port_with(use_rope=True),
    "scale": _port_with(attention_multiplier=None),
}
control_hook = _fp8
