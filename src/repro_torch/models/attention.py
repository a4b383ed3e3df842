"""GQA attention: the dense and the interest-managed blockwise paths, KV caches.

The *blockwise* path is the prefill workhorse.  The static per-query-block
KV schedule comes from interval matching over interest extents
(:func:`repro_torch.kernels.ops.build_block_structure`), and the block-sparse
flash kernel (:mod:`repro_torch.kernels.flash_attention`, CUDA) runs it on
the card; on CPU tensors the kernel's wrapper takes its plain version, which
replays the same online softmax.  In the JAX package this branch is a pure
JAX double ``lax.scan`` computing what its Pallas kernel computes; here it
*is* the kernel's call site.  Cross-attention (encoder-decoder models)
takes K/V from the encoder output (:func:`make_cross_kv`) through the same
call, non-causal, with Sq != Skv.

Decode reads the whole cache with a position mask, in plain torch, as the
JAX package does outside any kernel.  The caches are updated in place (the
JAX package returns new arrays and donates the old ones).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ops import flash_attention
from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.models.common import rope

NEG_INF = -1.0e30


def attn_defs(cfg: ModelConfig, cross: bool = False):
    """The projections of one attention sub-layer; a cross-attention
    sub-layer (``cross``) has the same shapes."""
    h, kv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim"), "normal"),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", "head_dim"), "normal"),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"), "normal",
                       scale_dim=h * hd),
    }


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, Hkv, Smax, hd)
    v: torch.Tensor
    # tokens filled so far: an int32 tensor on the CPU (0-d for one layer,
    # (num_blocks,) when stacked), so reading it never waits for the card
    length: torch.Tensor


def _split_heads(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, H, S, hd) → (B, Hkv, G, S, hd)."""
    b, h, s, hd = q.shape
    return q.reshape(b, num_kv, h // num_kv, s, hd)


def _merge_heads(o5: torch.Tensor) -> torch.Tensor:
    b, kvh, g, s, hd = o5.shape
    return o5.reshape(b, kvh * g, s, hd)


def _token_mask(q_pos, k_pos, *, causal, window):
    mask = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                      dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def dense_attention(q, k, v, *, scale, causal, window, softcap,
                    q_offset: int = 0, q_segments=None, kv_segments=None):
    """(B, H, Sq, hd) × (B, Hkv, Skv, hd) attention with a dense mask."""
    sq, skv = q.shape[2], k.shape[2]
    q5 = _split_heads(q, k.shape[1]).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", q5, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    q_pos = (torch.arange(sq, device=q.device) + q_offset)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = _token_mask(q_pos, k_pos, causal=causal, window=window)
    if q_segments is not None:
        seg = q_segments[:, :, None] == kv_segments[:, None, :]  # (B,Sq,Skv)
        mask = (mask[None] & seg)[:, None, None]                 # (B,1,1,Sq,Skv)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return _merge_heads(o).to(q.dtype)


def blockwise_attention(q, k, v, *, scale, causal, window, softcap,
                        block_q: int, block_k: int,
                        num_global_blocks: int = 0,
                        q_segments=None, kv_segments=None):
    """Interest-managed blockwise attention on the block-sparse flash kernel.

    :func:`repro_torch.kernels.ops.flash_attention` builds the static block
    schedule by interval matching over interest extents (the first
    ``num_global_blocks`` query blocks see every KV block) and runs the
    kernel over it (its plain version on CPU tensors); unmatched KV blocks
    are never touched.  q is right-aligned in the KV window.  The model
    calls it with Sq == Skv for self-attention, causal or not, and with
    Sq != Skv, non-causal, for cross-attention; there the alignment plays
    no part (the JAX package's pure-JAX path masks tokens with q at 0).
    Shapes that are not multiples of the blocks take
    :func:`dense_attention`.
    """
    sq, skv = q.shape[2], k.shape[2]
    if sq % block_q or skv % block_k:
        return dense_attention(q, k, v, scale=scale, causal=causal,
                               window=window, softcap=softcap,
                               q_offset=skv - sq, q_segments=q_segments,
                               kv_segments=kv_segments)
    if q_segments is not None:
        q_segments = q_segments.to(torch.int32).contiguous()
        kv_segments = kv_segments.to(torch.int32).contiguous()
    return flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
        causal=causal, window=window, softcap=softcap or None,
        q_segments=q_segments, kv_segments=kv_segments,
        num_global_blocks=num_global_blocks, block_q=block_q,
        block_k=block_k)


def _project(x: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """(B, S, d) × (d, heads, hd) → (B, S, heads, hd)."""
    b, s, _ = x.shape
    return (x @ w.to(dt).reshape(w.shape[0], -1)).view(b, s, w.shape[1],
                                                      w.shape[2])


def _output(o: torch.Tensor, wo: torch.Tensor, dt) -> torch.Tensor:
    """(B, H, S, hd) × (H, hd, d) → (B, S, d)."""
    b, h, s, hd = o.shape
    return o.transpose(1, 2).reshape(b, s, h * hd) \
        @ wo.to(dt).reshape(h * hd, -1)


def _decode_attention(q, cache: KVCache, pos: int, *, scale, window, softcap,
                      dt):
    """One query position against the whole cache, masked to ≤ pos."""
    smax = cache.k.shape[2]
    k_pos = torch.arange(smax, device=q.device)[None, :]
    q_pos = torch.full((1, 1), pos, dtype=torch.int64, device=q.device)
    mask = _token_mask(q_pos, k_pos, causal=True, window=window)
    q5 = _split_heads(q, cache.k.shape[1]).float()
    sc = torch.einsum("bkgqd,bksd->bkgqs", q5, cache.k.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, cache.v.float())
    return _merge_heads(o).to(dt)


def attention_layer(params, x, cfg: ModelConfig, *,
                    causal: bool = True, window: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None,
                    segments: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    cache: Optional[KVCache] = None,
                    num_global_blocks: int = 0):
    """Full attention sub-layer (projections + core + output).

    * forward/prefill: pass ``positions`` (B, S); returns (out, cache|None).
    * decode: pass ``cache`` and x of shape (B, 1, D); this token's K/V go
      to position ``cache.length``.
    * cross-attention: pass ``kv_override`` = the encoder's (k, v) heads
      (:func:`make_cross_kv`); q gets no rope, and no cache is read or
      written.

    A prefill writes the whole prefix into ``cache.k`` / ``cache.v`` and a
    decode step one position, in place; the returned cache holds the same
    tensors and the new length.  ``cfg.attn_impl == "dense"`` takes
    :func:`dense_attention` at every length.
    """
    s = x.shape[1]
    scale = cfg.head_dim ** -0.5
    dt = cfg.dtype

    q = _project(x, params["wq"], dt)                      # (B, S, H, hd)
    if kv_override is None:
        k = _project(x, params["wk"], dt)
        v = _project(x, params["wv"], dt)
        if positions is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        k = k.transpose(1, 2).contiguous()                 # (B, Hkv, S, hd)
        v = v.transpose(1, 2).contiguous()
    else:
        k, v = kv_override
        cache = None
    q = q.transpose(1, 2).contiguous()                     # (B, H, S, hd)

    new_cache = None
    if cache is not None:
        if s == 1:
            pos = int(cache.length)
            cache.k[:, :, pos] = k[:, :, 0].to(cache.k.dtype)
            cache.v[:, :, pos] = v[:, :, 0].to(cache.v.dtype)
            new_cache = KVCache(cache.k, cache.v,
                                torch.tensor(pos + 1, dtype=torch.int32))
            o = _decode_attention(q, new_cache, pos, scale=scale,
                                  window=window, softcap=cfg.attn_softcap,
                                  dt=dt)
            return _output(o, params["wo"], dt), new_cache
        cache.k[:, :, :s] = k.to(cache.k.dtype)
        cache.v[:, :, :s] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v,
                            torch.tensor(s, dtype=torch.int32))

    if cfg.attn_impl == "dense" or s <= cfg.attn_block_q:
        o = dense_attention(q, k, v, scale=scale, causal=causal,
                            window=window, softcap=cfg.attn_softcap,
                            q_segments=segments, kv_segments=segments)
    else:
        o = blockwise_attention(
            q, k, v, scale=scale, causal=causal, window=window,
            softcap=cfg.attn_softcap, block_q=cfg.attn_block_q,
            block_k=cfg.attn_block_k, num_global_blocks=num_global_blocks,
            q_segments=segments, kv_segments=segments)
    return _output(o, params["wo"], dt), new_cache


def make_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V (B, Hkv, S_enc, hd) from the encoder output
    (B, S_enc, d), through the sub-layer's ``wk`` / ``wv``; no rope."""
    dt = cfg.dtype
    k = _project(enc_out, params["wk"], dt).transpose(1, 2).contiguous()
    v = _project(enc_out, params["wv"], dt).transpose(1, 2).contiguous()
    return k, v
