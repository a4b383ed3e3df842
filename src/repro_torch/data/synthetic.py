"""Deterministic synthetic LM data with document packing, and the DDM
workload registry.

:class:`SyntheticLM` is stateless by construction: batch ``i`` is a pure
function of (seed, i), so resuming after a restart needs no data-loader
state beyond the step counter (the checkpoint's step is the data cursor).
The token process is a noisy affine bigram chain, x_{t+1} = (a x_t + c)
mod V with probability ``p_signal`` and uniform otherwise, restarted at
document boundaries: learnable, so training curves go down.  Packing
emits per-token document ids (``segments``, the input of the
interest-managed attention path) and per-document ``positions``.

A batch is drawn (:meth:`SyntheticLM.draws`, from a ``torch.Generator``
seeded by (seed, step)) and then composed (:func:`compose_batch`, pure).
The draws differ from the JAX package's ``jax.random`` streams by design;
the composition is the same function of the draws.

:func:`ddm_workload` is the axis the matching benchmarks and tests draw
from (uniform / clustered / tall-thin).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import (
    Extents,
    make_clustered_workload,
    make_tall_thin_workload,
    make_uniform_workload,
)

DDM_WORKLOADS = ("uniform", "clustered", "tall_thin")


def ddm_workload(name: str, n_sub: int, n_upd: int, *, alpha: float,
                 d: int = 1, length: float = 1.0e6,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Tuple[Extents, Extents]:
    """Named d-dim DDM region-set generator (one axis of the bench matrix).

    ``uniform`` and ``clustered`` follow the paper §5 (identical side αL/N,
    uniform or 16-hot-spot placement, d-cubes for d > 1); ``tall_thin`` is
    the adversarial shape whose dim 0 matches every pair (requires d ≥ 2 —
    see :func:`repro_torch.core.intervals.make_tall_thin_workload`).
    """
    kw = dict(alpha=alpha, length=length, d=d, generator=generator,
              device=device)
    if name == "uniform":
        return make_uniform_workload(n_sub, n_upd, **kw)
    if name == "clustered":
        return make_clustered_workload(n_sub, n_upd, **kw)
    if name == "tall_thin":
        return make_tall_thin_workload(n_sub, n_upd, **kw)
    raise ValidationError(f"unknown DDM workload {name!r} "
                          f"(choose from {DDM_WORKLOADS})")


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_signal: float = 0.9
    mean_doc_len: int = 512
    multiplier: int = 31
    increment: int = 17


def compose_batch(cfg: SyntheticConfig, first: torch.Tensor,
                  signal: torch.Tensor, noise: torch.Tensor,
                  bound: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The batch made from one step's draws: ``first`` (B, 1) int (the
    chain's seed token), ``signal`` (B, S) bool (follow the chain),
    ``noise`` (B, S) int (the token otherwise), ``bound`` (B, S) bool (a
    document starts here; position 0 is never one).

    Token t is ``noise[t]`` at a boundary or without signal, else
    (a x_{t-1} + c) mod V, with x_{-1} = ``first``.  Returns int32
    ``tokens``, ``segments`` (documents started so far), ``positions``
    (within the document) and ``labels`` (the next token; -1 at the last
    position and where the next token starts a document)."""
    b, s = noise.shape
    vocab = cfg.vocab_size
    # the chain as a scan of affine maps x -> A x + C (mod V): (a, c) where
    # the token follows the chain, (0, noise) where it is drawn afresh;
    # Hillis-Steele doubling composes every prefix in log2(S) steps
    follow = signal & ~bound
    mul = torch.where(follow, cfg.multiplier, 0).to(torch.int64)
    add = torch.where(follow, cfg.increment, noise.to(torch.int64))
    shift = 1
    while shift < s:
        prev_mul = torch.ones_like(mul)
        prev_add = torch.zeros_like(add)
        prev_mul[:, shift:] = mul[:, :-shift]
        prev_add[:, shift:] = add[:, :-shift]
        mul, add = (mul * prev_mul) % vocab, (mul * prev_add + add) % vocab
        shift *= 2
    tokens = ((mul * first.to(torch.int64) + add) % vocab).to(torch.int32)

    segments = torch.cumsum(bound, dim=1, dtype=torch.int32)
    idx = torch.arange(s, device=noise.device).expand(b, s)
    doc_start = torch.cummax(torch.where(bound, idx, 0), dim=1).values
    positions = (idx - doc_start).to(torch.int32)
    end = torch.ones((b, 1), dtype=torch.bool, device=noise.device)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)],
                       dim=1)
    labels = torch.where(torch.cat([bound[:, 1:], end], dim=1), -1, labels)
    return {"tokens": tokens, "labels": labels, "segments": segments,
            "positions": positions}


class SyntheticLM:
    """Deterministic packed-document LM batches on ``device``."""

    def __init__(self, cfg: SyntheticConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def draws(self, step: int) -> Tuple[torch.Tensor, ...]:
        """(first, signal, noise, bound) of step ``step`` for the global
        batch, drawn on the host from a generator seeded by (seed, step),
        so every device sees the same batch."""
        cfg = self.cfg
        b, s = cfg.global_batch, cfg.seq_len
        # the host generator (mt19937) keeps 32 bits of its seed
        gen = torch.Generator().manual_seed(
            (cfg.seed * 1_000_003 + step) % 2 ** 32)
        first = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen)
        signal = torch.rand((b, s), generator=gen) < cfg.p_signal
        noise = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        # boundaries with p = 1/mean_doc_len per position, none at 0
        bound = torch.rand((b, s), generator=gen) \
            < 1.0 / max(cfg.mean_doc_len, 2)
        bound[:, 0] = False
        return first, signal, noise, bound

    def batch(self, step: int, *, batch_size: Optional[int] = None,
              offset: int = 0) -> Dict[str, torch.Tensor]:
        """Batch ``step`` (optionally the rows [offset, offset + bs))."""
        b = batch_size or self.cfg.global_batch
        draws = [t.to(self.device) for t in self.draws(step)]
        out = compose_batch(self.cfg, *draws)
        return {k: v[offset:offset + b] for k, v in out.items()}

    def host_batch(self, step: int, host_id: int, num_hosts: int):
        """This host's slice of the global batch (per-host data loading)."""
        per = self.cfg.global_batch // num_hosts
        return self.batch(step, batch_size=per, offset=host_id * per)
