"""Shared layers: RMSNorm, RoPE, embeddings, the cross-entropy loss."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import ModelConfig, ParamDef


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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    return params["embedding"][tokens].to(cfg.dtype)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Float32 logits over the *padded* vocab; padding columns at -1e30."""
    if cfg.tie_embeddings:
        logits = x @ params["embedding"].to(cfg.dtype).T
    else:
        logits = x @ params["lm_head"].to(cfg.dtype)
    logits = logits.float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1.0e30)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE (f32); labels < 0 are ignored."""
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum(dtype=torch.float32).clamp(min=1)
