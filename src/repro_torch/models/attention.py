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

Under a mesh, ``wq`` / ``wk`` / ``wv`` run column-parallel over ``heads``
/ ``kv_heads`` and ``wo`` row-parallel (its partial outputs all-reduced),
as the layout of each leaf says (:func:`head_layout`): the flash kernel
runs on this rank's local heads, and the KV caches hold its local KV
heads.  Where the divisibility fallback replicates ``kv_heads`` but not
``heads``, every rank computes every KV head and attends with the ones
its q heads' groups need.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.api import ModelConfig, ParamDef
from repro_torch.models.common import rope
from repro_torch.parallel.collectives import copy_to, reduce_from
from repro_torch.parallel.sharding import Sharder

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


def _decode_attention(q, ck, cv, pos: int, *, scale, window, softcap, dt):
    """One query position against the whole cache (k, v), masked to ≤ pos."""
    smax = ck.shape[2]
    k_pos = torch.arange(smax, device=q.device)[None, :]
    q_pos = torch.full((1, 1), pos, dtype=torch.int64, device=q.device)
    mask = _token_mask(q_pos, k_pos, causal=True, window=window)
    q5 = _split_heads(q, ck.shape[1]).float()
    sc = torch.einsum("bkgqd,bksd->bkgqs", q5, ck.float()) * scale
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(mask, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, cv.float())
    return _merge_heads(o).to(dt)


class HeadLayout(NamedTuple):
    """How one rank's attention heads sit in the global ones."""
    q_groups: tuple        # process groups splitting the q heads (or ())
    kv_groups: tuple       # process groups splitting the KV heads (or ())
    q_heads: int           # local q heads
    kv_heads: int          # local KV heads (the projection's and cache's)
    # where the q heads split and the KV heads do not: the KV heads that
    # the local q heads attend with, in order (local q head j uses
    # kv_select[j // group]); None: the local KV heads as they are
    kv_select: Optional[List[int]]


def head_layout(cfg: ModelConfig, sharder: Sharder) -> HeadLayout:
    """The run-time split of ``heads`` and ``kv_heads`` (each leaf's
    spec), and the GQA mapping that survives it: rank r's q heads
    [r·H/P, (r+1)·H/P) pair with KV heads [r·Hkv/P, (r+1)·Hkv/P) when
    both split; when only ``heads`` splits, each local q head keeps its
    global group's KV head."""
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    qs, ks = sharder.split("heads", h), sharder.split("kv_heads", kvh)
    if ks.size > 1 and ks.axes != qs.axes:
        raise ValidationError(
            f"{cfg.name}: kv_heads split over {ks.axes}, heads over "
            f"{qs.axes}: the port needs both over the same mesh axes")
    hl, kvl = h // qs.size, kvh // ks.size
    select = None
    if qs.size > 1 and ks.size == 1:
        g, off = h // kvh, qs.index * hl
        if hl % g == 0:                   # whole groups
            select = [off // g + i for i in range(hl // g)]
        elif g % hl == 0:                 # inside one group
            select = [off // g]
        else:
            select = [(off + j) // g for j in range(hl)]
    return HeadLayout(sharder.groups(qs.axes), sharder.groups(ks.axes),
                      hl, kvl, select)


def _select(t: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """The KV heads the local q heads attend with (a replicated K/V used
    for this rank's block of work: its gradient is all-reduced)."""
    if lay.kv_select is None:
        return t
    t = copy_to(t, lay.q_groups)
    if lay.kv_select == list(range(t.shape[1])):
        return t
    return t[:, lay.kv_select]


def attention_layer(params, x, cfg: ModelConfig,
                    sharder: Optional[Sharder] = None, *,
                    causal: bool = True, window: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None,
                    segments: Optional[torch.Tensor] = None,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    cache: Optional[KVCache] = None,
                    num_global_blocks: int = 0):
    """Full attention sub-layer (projections + core + output).

    * forward/prefill: pass ``positions`` (B, S); returns (out, cache|None).
      Rope rotates q and k at ``positions`` unless ``cfg.use_rope`` is
      False (NoPE); the scores are scaled by ``cfg.attn_scale``.
    * decode: pass ``cache`` and x of shape (B, 1, D); this token's K/V go
      to position ``cache.length``.
    * cross-attention: pass ``kv_override`` = the encoder's (k, v) heads
      (:func:`make_cross_kv`); q gets no rope, and no cache is read or
      written.

    A prefill writes the whole prefix into ``cache.k`` / ``cache.v`` and a
    decode step one position, in place; the returned cache holds the same
    tensors and the new length.  ``cfg.attn_impl == "dense"`` takes
    :func:`dense_attention` at every length.  Under a mesh the heads are
    this rank's (:func:`head_layout`) and the output is all-reduced where
    ``heads`` splits.
    """
    s = x.shape[1]
    scale = cfg.attn_scale
    dt = cfg.dtype
    lay = head_layout(cfg, sharder or Sharder())

    xq = copy_to(x, lay.q_groups)
    q = _project(xq, params["wq"], dt)                     # (B, S, H, hd)
    if kv_override is None:
        xkv = xq if lay.kv_groups else x
        k = _project(xkv, params["wk"], dt)
        v = _project(xkv, params["wv"], dt)
        if positions is not None and cfg.use_rope:
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
            o = _decode_attention(q, _select(cache.k, lay),
                                  _select(cache.v, lay), pos, scale=scale,
                                  window=window, softcap=cfg.attn_softcap,
                                  dt=dt)
            return reduce_from(_output(o, params["wo"], dt),
                               lay.q_groups), new_cache
        cache.k[:, :, :s] = k.to(cache.k.dtype)
        cache.v[:, :, :s] = v.to(cache.v.dtype)
        new_cache = KVCache(cache.k, cache.v,
                            torch.tensor(s, dtype=torch.int32))

    k, v = _select(k, lay), _select(v, lay)
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
    return reduce_from(_output(o, params["wo"], dt), lay.q_groups), new_cache


def make_cross_kv(params, enc_out: torch.Tensor, cfg: ModelConfig,
                  sharder: Optional[Sharder] = None):
    """Cross-attention K/V (B, Hkv, S_enc, hd) from the encoder output
    (B, S_enc, d), through the sub-layer's ``wk`` / ``wv``; no rope.
    Under a mesh, this rank's KV heads (all where ``kv_heads`` is
    replicated)."""
    dt = cfg.dtype
    enc_out = copy_to(enc_out, head_layout(cfg, sharder or Sharder())
                      .kv_groups)
    k = _project(enc_out, params["wk"], dt).transpose(1, 2).contiguous()
    v = _project(enc_out, params["wv"], dt).transpose(1, 2).contiguous()
    return k, v
