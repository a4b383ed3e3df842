"""Shared layers: RMSNorm, RoPE, embeddings, the cross-entropy loss.

Under a mesh the vocab dimension may be split over the model axis
(vocab parallelism): :func:`embed_tokens` looks up in this rank's rows of
the table and all-reduces, :func:`unembed` gives this rank's columns of
the logits, and :func:`cross_entropy` reduces the max, the sum of
exponentials and the gold logit over the vocab's group, so no
(B, S, V) tensor is ever gathered.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.parallel.collectives import (all_reduce_max, all_reduce_sum,
                                              copy_to, reduce_from)
from repro_torch.parallel.sharding import Sharder


def rmsnorm_defs(d: int):
    return {"scale": ParamDef((d,), (None,), "scale")}


def rmsnorm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale``; back in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, D); positions: (..., S) int.

    Split halves: the first D/2 channels pair with the last D/2 (not
    interleaved pairs), as in the JAX package.
    """
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq             # (..., S, half)
    angles = angles[..., None, :]                            # (..., S, 1, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_defs(cfg: ModelConfig):
    d = {"embedding": ParamDef((cfg.padded_vocab, cfg.d_model),
                               ("vocab", "embed"), "embed")}
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.padded_vocab),
                                ("embed", "vocab"), "normal",
                                scale_dim=cfg.d_model)
    return d


def vocab_shard(cfg: ModelConfig, sharder: Sharder):
    """(the vocab's process groups, this rank's first vocab index, its
    vocab block size): ((), 0, padded_vocab) when the vocab is whole."""
    s = sharder.split("vocab", cfg.padded_vocab)
    block = cfg.padded_vocab // s.size
    return sharder.groups(s.axes), s.index * block, block


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 sharder: Optional[Sharder] = None) -> torch.Tensor:
    groups, lo, block = vocab_shard(cfg, sharder or Sharder())
    if not groups:
        # gather, then cast: the same values as casting the table first
        return params["embedding"][tokens].to(cfg.dtype)
    local = tokens - lo
    mine = (local >= 0) & (local < block)
    x = params["embedding"][local.clamp(0, block - 1)].to(cfg.dtype)
    return reduce_from(torch.where(mine[..., None], x, 0.0), groups)


def unembed(params, x: torch.Tensor, cfg: ModelConfig,
            sharder: Optional[Sharder] = None) -> torch.Tensor:
    """Float32 logits over the *padded* vocab (this rank's block of it
    under vocab parallelism); padding columns at -1e30."""
    groups, lo, block = vocab_shard(cfg, sharder or Sharder())
    x = copy_to(x, groups)
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(cfg.dtype).T
    else:
        logits = x @ params["lm_head"].to(cfg.dtype)
    logits = logits.float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(lo, lo + block, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1.0e30)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, *,
                  vocab_groups: Sequence = (), vocab_offset: int = 0,
                  batch_groups: Sequence = ()) -> torch.Tensor:
    """Mean next-token CE (f32); labels < 0 are ignored.

    With ``vocab_groups`` the logits are this rank's vocab block starting
    at ``vocab_offset``; with ``batch_groups`` the rows are this rank's
    share of the batch, and the mean is over every rank's tokens (the sum
    of the NLL and the valid count all-reduced, never a mean of means).
    """
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    if vocab_groups:
        m = all_reduce_max(logits.amax(dim=-1), vocab_groups)
        sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                             vocab_groups)
        logz = m + torch.log(sumexp)
        local = labels.long() - vocab_offset
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)
                             [..., None])[..., 0]
        gold = reduce_from(torch.where(mine, gold, 0.0), vocab_groups)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (logz - gold) * valid
    if not batch_groups:
        return nll.sum() / valid.sum(dtype=torch.float32).clamp(min=1)
    count = all_reduce_sum(valid.sum(dtype=torch.float32), batch_groups)
    return reduce_from(nll.sum(), batch_groups) / count.clamp(min=1)
