"""The backward pass of the flash kernel: the VJP of a differentiable twin.

The JAX package differentiates attention through its pure-JAX
``blockwise_attention`` (``repro/models/attention.py``), a double
``lax.scan`` that XLA differentiates; its Pallas kernel has no backward.
:func:`blockwise_attention_twin` is the same computation in plain torch:
for each query block, the KV blocks of its schedule (``kv_index`` /
``kv_count``) in order, an online softmax in float32 with the same token
masks (causal, window, packed-document segments, ``q_offset``) and logit
softcap.  Two things differ and neither changes the function: the padded
slots of the schedule (``t >= kv_count[i]``, masked out entirely in the
JAX scan) are skipped, and the running max is held out of autograd (the
softmax does not depend on the shift, so its gradient through the max is
zero in exact arithmetic; flash backward passes drop it the same way).

:func:`flash_attention_vjp` is the backward of
:class:`repro_torch.kernels.flash_attention.FlashAttentionFunction`: it
recomputes the twin from the saved q, k and v one query block at a time
and takes that block's VJP with ``torch.autograd.grad``.  Query blocks are
independent in the forward, so the sum of the blocks' VJPs is the VJP of
the whole; only one block's (q-block, kv-block) pairs are alive at once
(at B = 4, H = 15, 512-blocks each pair's float32 scores are ~63 MB).
Plain torch is the port's choice here: the JAX package has no backward
kernel to port, and a hand-written one is later work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1.0e30


def _q_block(qb: torch.Tensor, kv_blocks, i: int, q_segments, kv_segments, *,
             scale: float, causal: bool, window: Optional[int],
             softcap: Optional[float], block_q: int, block_k: int,
             q_offset: int) -> torch.Tensor:
    """Output (B, Hkv, G, bq, D) float32 of query block ``i`` (``qb``,
    float32 (B, Hkv, G, bq, D)) over ``kv_blocks``: (block index, k, v)
    with k, v float32 (B, Hkv, bk, D), in schedule order."""
    b, hkv, g, bq, d = qb.shape
    dev = qb.device
    m = torch.full((b, hkv, g, bq), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, bq), device=dev)
    acc = torch.zeros((b, hkv, g, bq, d), device=dev)
    q_pos = q_offset + i * block_q + torch.arange(bq, device=dev)[:, None]
    qs = slice(i * block_q, (i + 1) * block_q)
    for kb, kj, vj in kv_blocks:
        s = torch.einsum("bkgqd,bksd->bkgqs", qb, kj) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        k_pos = kb * block_k + torch.arange(block_k, device=dev)[None, :]
        mask = torch.ones((bq, block_k), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        mask = mask.expand(b, bq, block_k)
        if q_segments is not None:
            ks = slice(kb * block_k, (kb + 1) * block_k)
            mask = mask & (q_segments[:, qs, None] == kv_segments[:, None, ks])
        mask = mask[:, None, None]                          # (b,1,1,bq,bk)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] \
            + torch.einsum("bkgqs,bksd->bkgqd", p, vj)
        m = m_new
    safe = torch.where(l > 0, l, torch.ones_like(l))
    return acc / safe[..., None]


def _schedule(kv_index, kv_count):
    index = kv_index.cpu()
    return index, kv_count.cpu().tolist()


def blockwise_attention_twin(q, k, v, kv_index, kv_count,
                             q_segments=None, kv_segments=None, *,
                             scale: float, causal: bool,
                             window: Optional[int], softcap: Optional[float],
                             block_q: int, block_k: int,
                             q_offset: int = 0) -> torch.Tensor:
    """Block-sparse attention (B, H, Sq, D) in float32, differentiable:
    q (B, H, Sq, D), k/v (B, Hkv, Skv, D) of any float dtype (cast to
    float32), the schedule of :func:`repro_torch.kernels.ops.build_block_structure`
    (int32, on any device), segments (B, Sq) / (B, Skv) or None.  The
    answer depends on the schedule, as the kernel's does."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    index, count = _schedule(kv_index, kv_count)
    q5 = q.float().reshape(b, hkv, h // hkv, sq, d)
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(sq // block_q):
        blocks = [(kb, kf[:, :, kb * block_k:(kb + 1) * block_k],
                   vf[:, :, kb * block_k:(kb + 1) * block_k])
                  for kb in index[i, :count[i]].tolist()]
        outs.append(_q_block(
            q5[:, :, :, i * block_q:(i + 1) * block_q], blocks, i,
            q_segments, kv_segments, scale=scale, causal=causal,
            window=window, softcap=softcap, block_q=block_q,
            block_k=block_k, q_offset=q_offset))
    return torch.cat(outs, dim=3).reshape(b, h, sq, d)


def flash_attention_vjp(q, k, v, dout, kv_index, kv_count,
                        q_segments=None, kv_segments=None, *, scale: float,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float], block_q: int, block_k: int,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's dtypes: the VJP of
    :func:`blockwise_attention_twin` at (q, k, v) for the upstream
    gradient ``dout`` (B, H, Sq, D), one query block at a time."""
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    index, count = _schedule(kv_index, kv_count)
    q5 = q.detach().float().reshape(b, hkv, g, sq, d)
    do5 = dout.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.detach().float(), v.detach().float()
    dq = torch.zeros_like(q5)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for i in range(sq // block_q):
        if count[i] == 0:
            continue
        qs = slice(i * block_q, (i + 1) * block_q)
        kbs = index[i, :count[i]].tolist()
        qb = q5[:, :, :, qs].clone().requires_grad_()
        kjs = [kf[:, :, kb * block_k:(kb + 1) * block_k].clone()
               .requires_grad_() for kb in kbs]
        vjs = [vf[:, :, kb * block_k:(kb + 1) * block_k].clone()
               .requires_grad_() for kb in kbs]
        with torch.enable_grad():
            o = _q_block(qb, list(zip(kbs, kjs, vjs)), i, q_segments,
                         kv_segments, scale=scale, causal=causal,
                         window=window, softcap=softcap, block_q=block_q,
                         block_k=block_k, q_offset=q_offset)
            grads = torch.autograd.grad(o, [qb] + kjs + vjs, do5[:, :, :, qs])
        dq[:, :, :, qs] = grads[0]
        n = len(kbs)
        for kb, gk, gv in zip(kbs, grads[1:1 + n], grads[1 + n:]):
            ks = slice(kb * block_k, (kb + 1) * block_k)
            dk[:, :, ks] += gk
            dv[:, :, ks] += gv
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
