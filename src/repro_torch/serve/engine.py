"""Serving engine: slot-based wave batching over the model's prefill and
decode steps.

A pool of ``num_slots`` slots shares one stacked cache (KV caches for
attention layers, Mamba states for SSD layers; the engine never looks
inside).  Requests queue up; each wave admits up to ``num_slots`` requests
whose prompts all have the head request's length (length-bucketed: a
padded prefix would poison the KV cache, the attention window or the
Mamba state, so no cache needs padding logic), prefills them together, then
decodes one batched greedy token per step until every request of the wave
has its budget or its EOS.  The same scheduling as the JAX package's
``repro/serve/engine.py``; here the wave's cache is updated in place.

Each wave's phases are spans of :mod:`repro_torch.perf.spans`
(``serve.wave`` and within it ``serve.admit``, ``serve.upload``,
``serve.init_cache``, ``serve.prefill``, ``serve.sample``: the argmax and
its host sync, ``serve.decode``), recorded only under a profiler.

Prompts are token lists only, as in the JAX engine: a model with a
frontend (vision prefix, audio frames) or an encoder is refused (see
:func:`check_servable`); drive it through ``Model.prefill`` /
``decode_step``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.errors import ValidationError
from repro_torch.models.api import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.perf import spans


def check_servable(cfg: ModelConfig) -> None:
    """Raise :class:`ValidationError` for a config whose prefill needs more
    than tokens (a frontend's embeddings, an encoder's frames)."""
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        raise ValidationError(
            f"{cfg.name}: the engine serves token prompts only (frontend "
            f"{cfg.frontend!r}, encoder-decoder {cfg.is_encoder_decoder}); "
            "call Model.prefill / decode_step")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None


@dataclasses.dataclass
class Result:
    rid: int
    tokens: List[int]
    prompt_len: int


class ServeEngine:
    """Greedy serving of ``model`` with ``params`` on ``device`` (which
    must be the model's device)."""

    def __init__(self, model: Model, params, *, num_slots: int, max_len: int,
                 device="cuda"):
        if torch.device(device).type != model.device.type:
            raise ValidationError(f"engine on {device}, model on "
                                  f"{model.device}")
        check_servable(model.cfg)
        self.model = model
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.device = model.device
        self.queue: deque[Request] = deque()
        self.results: Dict[int, Result] = {}
        self._waves = 0

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValidationError("request exceeds engine max_len")
        self.queue.append(req)

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        vocab = self.model.cfg.vocab_size
        return logits[:, -1, :vocab].argmax(dim=-1)[:, None]

    def _run_wave(self, wave: List[Request]) -> None:
        lengths = {len(r.prompt) for r in wave}
        if len(lengths) != 1:
            raise ValidationError("waves are length-bucketed")
        pos = lengths.pop()
        with spans.span("serve.upload"):
            toks = torch.from_numpy(np.stack([np.asarray(r.prompt, np.int64)
                                              for r in wave])).to(self.device)
        with spans.span("serve.init_cache"):
            cache = self.model.init_cache(len(wave), self.max_len)
        with spans.span("serve.prefill"):
            cache, logits = self.model.prefill(self.params, {"tokens": toks},
                                               cache)
        outputs: List[List[int]] = [[] for _ in wave]
        done = [False] * len(wave)
        for _ in range(max(r.max_new_tokens for r in wave)):
            with spans.span("serve.sample"):
                cur = self._argmax(logits)
                served = cur[:, 0].tolist()
            for i, (r, t) in enumerate(zip(wave, served)):
                if done[i]:
                    continue
                outputs[i].append(t)
                if (r.eos_id is not None and t == r.eos_id) \
                        or len(outputs[i]) >= r.max_new_tokens:
                    done[i] = True
            if all(done) or pos + 1 >= self.max_len:
                break
            with spans.span("serve.decode"):
                cache, logits = self.model.decode_step(self.params, cur,
                                                       cache, pos)
            pos += 1
        for i, r in enumerate(wave):
            self.results[r.rid] = Result(r.rid, outputs[i], len(r.prompt))

    def run(self) -> Dict[int, Result]:
        """Drain the queue (length-bucketed wave batching).  Each wave is
        a ``serve.wave`` span with the wave's id and its requests'."""
        while self.queue:
            with spans.span("serve.wave", wave=self._waves) as wave_span:
                self._waves += 1
                with spans.span("serve.admit"):
                    head_len = len(self.queue[0].prompt)
                    wave, rest = [], deque()
                    while self.queue and len(wave) < self.num_slots:
                        r = self.queue.popleft()
                        if len(r.prompt) == head_len:
                            wave.append(r)
                        else:
                            rest.append(r)
                    rest.extend(self.queue)
                    self.queue = rest
                wave_span.tag(requests=[r.rid for r in wave])
                self._run_wave(wave)
        return self.results


def generate_greedy(model: Model, params, prompt: Sequence[int],
                    max_new_tokens: int, max_len: int) -> List[int]:
    """Single-sequence convenience wrapper (examples, tests)."""
    eng = ServeEngine(model, params, num_slots=1, max_len=max_len,
                      device=model.device)
    eng.submit(Request(0, list(prompt), max_new_tokens))
    return eng.run()[0].tokens
