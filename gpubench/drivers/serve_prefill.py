"""Closed-loop prefill serving through the port's ``ServeEngine``.

``clients`` clients each send a prompt of ``prompt_len`` token ids (drawn
from the seed) asking for ``output_tokens`` tokens, and send the next one
when the answer came back; with ``slots`` = ``clients`` every wave of the
engine takes one request of each client.  The window closes when the last
wave that started before ``--seconds`` ran out has come back: every
request counted was submitted and answered inside it.

End-to-end: ``prefill_tokens_per_s``, the prompt tokens of the requests
answered in the window over the window's seconds; ``ttft_p95_ms``, the
95th percentile of the time from a request's submission to its first
token, over all of them.

The check.  Around the timed ``Model.prefill`` the harness keeps what the
prefill returned for a uniform sample of the window's waves, drawn from
the seed: the last position's logits of ``logit_waves`` waves, and of
``kv_waves`` of those the KV cache it filled too.  Once the window
closed, those waves' prompts go through the plain float32 reference with
the same weights, and:

* for each row of the ``kv_waves`` waves and each layer, the median over
  the row's tokens of the relative L2 distance of a token's keys (after
  rope) and values, over its KV heads, to the reference's (the larger of
  the two); ``kv_err`` is the largest over all the layers of the median
  over the rows, ``kv_worst_row`` the largest over the rows and over the
  layers its limit names;
* ``logit_err``: the median over the rows of the ``logit_waves`` waves
  of the relative L2 distance of the last position's logits to the
  reference's;
* ``token_gap_excess``: over the same rows (every request of those
  waves), the largest gap by which the served token's reference logit
  lies below the reference's best beyond twice the row's largest logit
  error (0 for any token that is the argmax of logits that close to the
  reference's).

``control_hook`` puts the control in the program's place: the reference
with every product's operands in float8 e4m3 serves the waves.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np

from gpubench.gen.prompts import PromptStream
from gpubench.lib import decoder
from gpubench.lib.common import percentile, seed_stream
from gpubench.reference import moe_decoder


class State:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def setup(ctx) -> State:
    from repro_torch.models.transformer import Model
    from repro_torch.serve.engine import ServeEngine

    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    if int(tr["slots"]) != int(tr["clients"]):
        raise ValueError("serve_prefill runs one engine wave a round: "
                         "slots must equal clients")
    if int(tr["kv_waves"]) > int(tr["logit_waves"]):
        raise ValueError("kv_waves are a part of logit_waves")
    model = Model(decoder.model_config(cfg), device=ctx.device)
    weights = decoder.make_weights(cfg, seed_stream(ctx.seed, "weights"),
                                   ctx.device, torch)
    params = decoder.port_params(weights, model)
    engine = ServeEngine(model, params, num_slots=int(tr["slots"]),
                         max_len=int(tr["prompt_len"])
                         + int(tr["output_tokens"]), device=ctx.device)
    st = State(model=model, weights=weights, engine=engine, sample={},
               waves_seen=0, capture=False, sync_prefill=False, next_rid=0,
               real_prefill=model.prefill, spec=moe_decoder.spec_of(cfg),
               rng=np.random.Generator(np.random.PCG64(
                   seed_stream(ctx.seed, "check"))))

    def prefill(params, batch, cache):
        with ctx.spans.span("model.prefill"):
            cache, logits = st.real_prefill(params, batch, cache)
            if st.sync_prefill:
                ctx.sync()
        if st.capture:
            _keep(st, tr, batch["tokens"], cache, logits)
        return cache, logits

    model.prefill = prefill
    vocab = int(cfg["vocab_size"])
    warm = PromptStream(ctx.seed, "warmup", vocab, tr["prompt_len"])
    for _ in range(int(tr["warmup_waves"])):
        _wave(st, warm, ctx)
    ctx.spans.items.clear()
    st.prompts = PromptStream(ctx.seed, "prompts", vocab, tr["prompt_len"])
    return st


def _keep(st: State, tr, tokens, cache, logits) -> None:
    """A uniform sample of the window's waves (priority sampling): each
    wave draws a key from the seed's stream; the ``logit_waves`` smallest
    keys keep their tokens and logits, the ``kv_waves`` smallest of those
    their caches too (a cache dropped once is never needed again)."""
    key = float(st.rng.random())
    st.sample[key] = [st.waves_seen, tokens, cache, logits]
    st.waves_seen += 1
    keys = sorted(st.sample)
    for k in keys[int(tr["logit_waves"]):]:
        del st.sample[k]
    for k in keys[int(tr["kv_waves"]):int(tr["logit_waves"])]:
        st.sample[k][2] = None


def _wave(st: State, stream: PromptStream, ctx):
    """One round of the closed loop: every client submits, the engine runs
    the wave, every answer comes back.  Returns (submitted, answered,
    served tokens of each request, or None where none came)."""
    from repro_torch.serve.engine import Request

    tr = ctx.traffic
    rows = stream.batch(int(tr["clients"]))
    reqs = [Request(st.next_rid + i, rows[i], int(tr["output_tokens"]))
            for i in range(len(rows))]
    st.next_rid += len(reqs)
    t_sub = time.perf_counter()
    for r in reqs:
        st.engine.submit(r)
    with ctx.spans.span("engine.run"):
        results = st.engine.run()
    t_done = time.perf_counter()
    served = []
    for r in reqs:
        res = results.pop(r.rid, None)
        served.append(None if res is None else list(res.tokens))
    return t_sub, t_done, served


def window(st: State, ctx) -> Dict:
    tr = ctx.traffic
    st.sync_prefill = ctx.trace       # spans of the prefill's device work
    st.capture = True
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    waves: List = []
    while True:
        waves.append(_wave(st, st.prompts, ctx))
        if waves[-1][1] >= deadline:
            break
    st.capture = False
    window_s = waves[-1][1] - t0
    times = sorted(done - sub for sub, done, _ in waves)
    print("gpubench: wave ms min / median / p95 / max "
          + " / ".join(f"{1e3 * percentile(times, q):.1f}"
                       for q in (0, 50, 95, 100)), file=sys.stderr)
    want = int(tr["output_tokens"])
    ttft, tokens, failed, attempted = [], 0, 0, 0
    for t_sub, t_done, served in waves:
        for toks in served:
            attempted += 1
            if toks is None or len(toks) != want:
                failed += 1
                continue
            ttft.append(t_done - t_sub)
            tokens += int(tr["prompt_len"])
    return {
        "attempted": attempted, "failed": failed, "window_s": window_s,
        "end_to_end": {"prefill_tokens_per_s": tokens / window_s,
                       "ttft_p95_ms": percentile(ttft, 95) * 1e3},
        "waves": [(len(served), int(tr["prompt_len"]))
                  for _, _, served in waves],
        "served": [served for _, _, served in waves],
    }


def _token_err(ref: "torch.Tensor", got: "torch.Tensor") -> float:
    """Median over tokens of |got - ref| / |ref|, each token's (H_kv, D)
    slice taken whole."""
    num = (got - ref).flatten(1).norm(dim=1)
    den = ref.flatten(1).norm(dim=1).clamp(min=1e-30)
    return float((num / den).median())


class _KVJudge:
    """``on_kv`` of the reference: each layer's per-row error of another
    side's keys and values against the reference's."""

    def __init__(self, layers: int, other):
        self.other = other          # (layer, row) -> (k, v), (S, H_kv, D)
        self.rows = [[] for _ in range(layers)]

    def __call__(self, li, row, k, v):
        ok, ov = self.other(li, row)
        self.rows[li].append(max(_token_err(k, ok), _token_err(v, ov)))


def _logit_readings(ref, got, served):
    """Per row: the relative L2 distance of ``got`` to ``ref``, and the gap
    by which the served token's reference logit lies below the
    reference's best beyond twice the row's largest logit error."""
    err = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
    err_inf = (got - ref).abs().amax(dim=-1)
    gap = ref.max(dim=-1).values - ref.gather(1, served[:, None])[:, 0]
    return err.tolist(), (gap - 2.0 * err_inf).clamp(min=0.0).tolist()


def check(st: State, rec: Dict, ctx) -> Dict[str, float]:
    torch, cfg = ctx.torch, ctx.config
    vocab = int(cfg["vocab_size"])
    bad = {k: float("inf") for k in ("kv_err", "kv_worst_row",
                                     "logit_err", "token_gap_excess")}
    sample = sorted(st.sample.values(), key=lambda w: w[0])
    st.sample = {}
    del st.engine, st.model, st.real_prefill
    if ctx.on_card:
        torch.cuda.empty_cache()
    if not any(cache is not None for _, _, cache, _ in sample):
        return bad
    spec = st.spec
    kv_rows = [[] for _ in range(spec["layers"])]
    row_err, excess = [], []
    for wi, tokens, cache, logits in sample:
        served = [toks[0] if toks else -1 for toks in rec["served"][wi]]
        if not all(0 <= t < vocab for t in served):
            return bad
        judge = None
        if cache is not None:
            kv, s = cache["layer0"], tokens.shape[1]
            judge = _KVJudge(spec["layers"], lambda li, row, kv=kv, s=s: (
                kv.k[li, row, :, :s].float().transpose(0, 1),
                kv.v[li, row, :, :s].float().transpose(0, 1)))
        ref = moe_decoder.last_logits(st.weights, tokens, spec, on_kv=judge)
        if judge is not None:
            for li, errs in enumerate(judge.rows):
                kv_rows[li] += errs
        e, x = _logit_readings(ref, logits[:, 0, :vocab].float(),
                               torch.tensor(served, device=ref.device))
        row_err += e
        excess += x
    layer_max = [max(r) for r in kv_rows]
    layer_median = [float(np.median(r)) for r in kv_rows]
    print("gpubench: kv error by layer, median row "
          + " ".join(f"{e:.5f}" for e in layer_median), file=sys.stderr)
    print("gpubench: kv error by layer, largest row "
          + " ".join(f"{e:.5f}" for e in layer_max), file=sys.stderr)
    print(f"gpubench: logit_err over {len(row_err)} rows: min / median / "
          f"max {min(row_err):.5f} / {float(np.median(row_err)):.5f} / "
          f"{max(row_err):.5f}; token_gap_excess {max(excess)!r}",
          file=sys.stderr)
    worst_layers = ctx.limits["kv_worst_row"]["layers"]
    return {"kv_err": max(layer_median),
            "kv_worst_row": max(layer_max[li] for li in worst_layers
                                if li < len(layer_max)),
            "logit_err": float(np.median(row_err)),
            "token_gap_excess": max(excess)}


def control_hook(driver, st: State) -> None:
    """Put the control in the program's place (after set-up): the
    reference with every product's operands in float8 e4m3, the precision
    below the configuration's bfloat16, serves each wave.  It fills the
    engine's KV cache and returns its logits as the prefill does; the
    engine serves their argmax, and ``check`` judges it all as it judges
    the program."""
    import torch

    padded = st.model.cfg.padded_vocab

    def prefill(params, batch, cache):
        tokens = batch["tokens"]
        kv, s = cache["layer0"], tokens.shape[1]

        def fill(li, row, k, v):
            kv.k[li, row, :, :s] = k.transpose(0, 1).to(kv.k.dtype)
            kv.v[li, row, :, :s] = v.transpose(0, 1).to(kv.v.dtype)

        logits = moe_decoder.last_logits(st.weights, tokens, st.spec,
                                         on_kv=fill,
                                         quant=moe_decoder.fp8_e4m3)
        logits = torch.nn.functional.pad(logits, (0, padded
                                                  - logits.shape[1]))
        return cache, logits[:, None, :]

    st.real_prefill = prefill
