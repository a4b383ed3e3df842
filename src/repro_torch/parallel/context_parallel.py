"""Context parallelism: sequence-sharded attention over the ranks of a
mesh dimension.

Context parallelism shards the sequence over a mesh axis with replicated
weights, making norms, MLPs and projections local; the only
communication is what attention needs:

* :func:`halo_window_attention` — local / sliding-window layers: the last
  ``window`` KV positions come from the left neighbour (one exchange per
  whole chunk the window spans);
* :func:`ring_attention` — full-causal layers: KV chunks rotate around
  the ring under a running online softmax (Liu et al., Ring Attention).

The counterpart of the JAX package's ``repro/parallel/context_parallel.py``:
its ``ppermute`` is a send to the neighbouring rank and a receive from
the other (``batch_isend_irecv``), in the same order; a rank that
``ppermute`` sends nothing to receives zeros, as there.  Each function is
called by every rank of ``group`` with its contiguous chunk of s_l
positions (rank r holds positions [r·s_l, (r+1)·s_l)).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.errors import ValidationError
from repro_torch.parallel.sharding import PartitionSpec

NEG_INF = -1.0e30


def _attend(q, k, v, mask, scale, softcap):
    """One masked block: (m, l, acc) online-softmax partials.

    q: (b, kvh, g, sq, hd); k/v: (b, kvh, sk, hd); mask: (sq, sk).  f32.
    """
    s = torch.einsum("bkgqd,bksd->bkgqs", q, k) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bksd->bkgqd", p, v)
    return m, l, acc


def _merge(m1, l1, a1, m2, l2, a2):
    """Combine two online-softmax partials (flash-decoding merge)."""
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return m, l1 * c1 + l2 * c2, a1 * c1[..., None] + a2 * c2[..., None]


def _split(q, kvh):
    b, h, s, hd = q.shape
    return q.reshape(b, kvh, h // kvh, s, hd)


def _shift(x: torch.Tensor, group, *, ring: bool) -> torch.Tensor:
    """Rank i's ``x`` to rank i + 1 of ``group`` (and, with ``ring``, the
    last rank's to rank 0); what this rank receives, zeros if nothing.
    gloo's send and receive take host memory only (its collectives stage
    CUDA tensors themselves; its point-to-point calls do not): a CUDA
    tensor goes through the host there."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    if p == 1:
        return x.clone() if ring else torch.zeros_like(x)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return _shift(x.cpu(), group, ring=ring).to(x.device)
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    if ring or idx < p - 1:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, (idx + 1) % p),
                              group))
    if ring or idx > 0:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, (idx - 1) % p),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def halo_window_attention(q, k, v, *, window: int, group,
                          scale: Optional[float] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """Sliding-window causal attention over a seq-sharded layout.

    q (b, H, s_l, hd), k/v (b, KV, s_l, hd): this rank's contiguous s_l
    positions; the window may span up to P − 1 chunks to the left (whole
    chunks are exchanged, then masked).
    """
    b, h, s_l, hd = q.shape
    kvh = k.shape[1]
    if scale is None:
        scale = hd ** -0.5
    idx, p = dist.get_rank(group), dist.get_world_size(group)
    num_halo = -(-window // s_l)                   # whole-chunk halos
    if num_halo >= p:
        raise ValidationError(f"{window=} spans the whole ring; use "
                              "ring_attention")
    k_chunks, v_chunks = [k], [v]
    ck, cv = k, v
    for _ in range(num_halo):
        ck = _shift(ck, group, ring=False)
        cv = _shift(cv, group, ring=False)
        k_chunks.insert(0, ck)
        v_chunks.insert(0, cv)
    k_ext = torch.cat(k_chunks, dim=2).float()
    v_ext = torch.cat(v_chunks, dim=2).float()

    dev = q.device
    q_pos = (idx * s_l + torch.arange(s_l, device=dev))[:, None]
    # extended keys start num_halo chunks to the left; ranks near the
    # start hold zero halos, masked by k_pos >= 0
    ext = s_l * (num_halo + 1)
    k_pos = (idx * s_l - num_halo * s_l
             + torch.arange(ext, device=dev))[None, :]
    mask = (k_pos >= 0) & (k_pos <= q_pos) & (k_pos > q_pos - window)

    m, l, acc = _attend(_split(q, kvh).float(), k_ext, v_ext, mask, scale,
                        softcap)
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).reshape(b, h, s_l, hd).to(q.dtype)


def ring_attention(q, k, v, *, group, scale: Optional[float] = None,
                   softcap: Optional[float] = None) -> torch.Tensor:
    """Full-causal attention over a seq-sharded layout (Ring Attention):
    at hop t this rank holds the chunk of rank (idx − t) mod P, attends to
    it under the causal mask and merges the partial into its running
    softmax, then passes the chunk on to rank idx + 1."""
    b, h, s_l, hd = q.shape
    kvh = k.shape[1]
    if scale is None:
        scale = hd ** -0.5
    idx, p = dist.get_rank(group), dist.get_world_size(group)
    dev = q.device
    q5 = _split(q, kvh).float()
    q_pos = (idx * s_l + torch.arange(s_l, device=dev))[:, None]
    g = h // kvh
    m = torch.full((b, kvh, g, s_l), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, g, s_l), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, g, s_l, hd), dtype=torch.float32, device=dev)
    kc, vc = k, v
    for t in range(p):
        src = (idx - t) % p                        # whose chunk we hold
        k_pos = (src * s_l + torch.arange(s_l, device=dev))[None, :]
        m2, l2, a2 = _attend(q5, kc.float(), vc.float(), k_pos <= q_pos,
                             scale, softcap)
        m, l, acc = _merge(m, l, acc, m2, l2, a2)
        if t < p - 1:                              # the last pass is unused
            kc = _shift(kc, group, ring=True)
            vc = _shift(vc, group, ring=True)
    safe = torch.where(l > 0, l, 1.0)
    return (acc / safe[..., None]).reshape(b, h, s_l, hd).to(q.dtype)


def cp_specs(mesh, batch_axes=("data",), seq_axis: str = "model"
             ) -> PartitionSpec:
    """The spec of a seq-sharded (b, h, s, hd) tensor."""
    return PartitionSpec(tuple(batch_axes), None, seq_axis, None)
