"""Public entry points over the sweep kernels and the attention kernel.

Encoding, sorting and padding are plain torch; the sweeps themselves run on
the kernels of :mod:`repro_torch.kernels.sbm_sweep` for CUDA tensors and
on their plain versions for CPU tensors.  :func:`flash_attention` builds
the block schedule on the host (:func:`build_block_structure`, numpy) and
runs :mod:`repro_torch.kernels.flash_attention` over it, under autograd
through its ``FlashAttentionFunction`` when a CUDA q, k or v requires
grad.

The sweeps' phases are spans of :mod:`repro_torch.perf.spans`
(``sweep.count``; in :func:`sbm_enumerate_kernel` ``sweep.passes_ab``,
``sweep.segment_max``, ``sweep.bitmasks``, ``sweep.scan``,
``sweep.pass_c``, ``sweep.stitch``) and, on the card, the counters
``sweep.pass_c_blocks`` and ``sweep.pass_c_fallback_blocks`` (pass C's
blocks that left its list path), recorded only under a profiler.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents
from repro_torch.core.sweep import _indicator_deltas, _pad_stream, encode_endpoints
from repro_torch.kernels.flash_attention import (FlashAttentionFunction,
                                                 flash_attention_kernel)
from repro_torch.kernels import sbm_sweep as sweep_kernels
from repro_torch.perf import spans

COUNT_BLOCK = 2048
# One segment of pass C holds ceil(n/32) words per mask per segment, six
# mask arrays in all: at n = m = 1e6 a 4096-endpoint segment keeps each
# array near 122 MB (512 endpoints would need about 1 GB each).
ENUMERATE_BLOCK = 4096


def _empty_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def sbm_count_kernel(subs: Extents, upds: Extents, *,
                     block_size: int = COUNT_BLOCK) -> torch.Tensor:
    """K via the two-pass sweep kernels (sort in torch, sweep on passes A
    and B), as an exact 0-d int64 tensor."""
    if subs.size == 0 or upds.size == 0:
        return _empty_count(subs.lo.device)
    with spans.span("sweep.count"):
        ep = _pad_stream(encode_endpoints(subs, upds), block_size)
        deltas = torch.stack(_indicator_deltas(ep))      # (4, total)
        _, _, k = sweep_kernels.sweep_count(deltas, block_size=block_size)
    return k


def _num_words(count: int) -> int:
    return max(-(-count // 32), 1)


def pass_c_scratch_bytes(n: int, m: int,
                         block_size: int = ENUMERATE_BLOCK) -> int:
    """Bytes of the (num_blocks, W) int32 word arrays that
    :func:`sbm_enumerate_kernel` keeps alive at once for ``n`` subscriptions
    and ``m`` updates: the Add/Del words of both sides, the two entering
    sets and pass C's two scratch copies of them — four arrays of
    ``ceil(n/32)`` words and four of ``ceil(m/32)`` a segment.  It grows as
    (n+m)·(n+m)/block_size: about 1 GB at n = m = 1e6 and 98 GB at 1e7
    (block 4096)."""
    if n == 0 or m == 0:
        return 0
    num_blocks = -(-(2 * n + 2 * m) // block_size)   # the padded stream
    return 4 * num_blocks * 4 * (_num_words(n) + _num_words(m))


def card_segment(block_size: int, n: int, m: int) -> int:
    """The segment size :func:`sbm_enumerate_kernel` runs at on the card:
    ``block_size``, or where the delta-bitmask kernel
    (:data:`~repro_torch.kernels.sbm_sweep.BITMASK_MAX_BLOCK`) or pass C
    (:func:`~repro_torch.kernels.sbm_sweep.emit_pairs_max_block` for these
    W) takes less, the largest segment both take, rounded down to a
    multiple of 4 (pass B's 16-byte loads); builds the library."""
    limit = min(sweep_kernels.BITMASK_MAX_BLOCK,
                sweep_kernels.emit_pairs_max_block(_num_words(n),
                                                   _num_words(m)))
    if block_size <= limit:
        return block_size
    if limit < 4:
        raise ValidationError(f"pass C takes no segment at n={n}, m={m} on "
                              "this card (its mask summaries alone fill a "
                              "block's shared memory)")
    return limit - limit % 4


def _type_bitmasks(ep, up, n: int, m: int, block_size: int):
    real = ep.owner >= 0
    valid_s = (ep.is_sub & real).to(torch.int32)
    valid_u = (~ep.is_sub & real).to(torch.int32)
    sadd, sdel = sweep_kernels.delta_bitmasks(
        ep.owner, up, valid_s, num_words=_num_words(n), block_size=block_size)
    uadd, udel = sweep_kernels.delta_bitmasks(
        ep.owner, up, valid_u, num_words=_num_words(m), block_size=block_size)
    return sadd, sdel, uadd, udel


def sbm_delta_bitmasks(subs: Extents, upds: Extents, *,
                       block_size: int = ENUMERATE_BLOCK):
    """Algorithm 6's (Sadd, Sdel, Uadd, Udel) as per-segment int32 words."""
    ep = _pad_stream(encode_endpoints(subs, upds), block_size)
    up = ep.is_upper.to(torch.int32)
    return _type_bitmasks(ep, up, subs.size, upds.size, block_size)


def _stitch_blocks(out_i, out_j, block_sums, k_total, *, max_pairs: int,
                   cap: int) -> torch.Tensor:
    """Final (max_pairs, 2) buffer from per-segment emission regions: slot
    s lives in the segment whose exclusive pair-offset range contains it
    (the output-space analogue of the counting master step)."""
    num_blocks = out_i.shape[0]
    incl = torch.cumsum(block_sums, dim=0, dtype=torch.int64)
    slots = torch.arange(max_pairs, dtype=torch.int64, device=out_i.device)
    b = torch.searchsorted(incl, slots, right=True).clamp(max=num_blocks - 1)
    r = slots - (incl[b] - block_sums[b])
    valid = (slots < torch.clamp(k_total, max=max_pairs)) & (r < cap)
    r = r.clamp(0, cap - 1)
    pairs = torch.stack([out_i[b, r], out_j[b, r]], dim=-1)
    return torch.where(valid[:, None], pairs, -1)


def sbm_enumerate_kernel(subs: Extents, upds: Extents, *, max_pairs: int,
                         block_size: int = ENUMERATE_BLOCK
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All matching (i, j) pairs via the five sweep kernels.

    Passes A/B size the output: the per-segment emission totals and their
    exclusive scan are the cross-segment pair offsets.  The delta-bitmask
    kernel plus the Algorithm-6 monoid scan kernel seed each segment's active
    sets, and pass C writes each segment's pairs into its own region,
    stitched by the offset table.  Returns (pairs (max_pairs, 2) int32
    padded with −1, exact count as a 0-d int64 tensor) — the contract of
    :func:`repro_torch.core.enumerate.sbm_enumerate`, in pass C's
    segment-sequential order.  Each segment's region holds the largest
    segment total, read with one host sync, so no pair is ever dropped.

    Any ``block_size`` is answered.  On the card a segment larger than the
    delta-bitmask kernel or pass C takes runs at :func:`card_segment`'s
    size instead (never on the plain versions): pass C writes each
    segment's pairs in stream order and the stitch concatenates segments
    in stream order, so the pairs, their order and the count do not depend
    on the segment size.
    """
    dev = subs.lo.device
    n, m = subs.size, upds.size
    if n == 0 or m == 0:
        return (torch.full((max_pairs, 2), -1, dtype=torch.int32, device=dev),
                _empty_count(dev))
    with spans.span("sweep.passes_ab"):
        if dev.type == "cuda":
            block_size = card_segment(block_size, n, m)
        ep = _pad_stream(encode_endpoints(subs, upds), block_size)
        deltas = torch.stack(_indicator_deltas(ep))
        # pass B's per-endpoint counts stay here: pass C derives the same
        # counts inside each block from its records and entering popcounts,
        # in the same scans that give it the single-pair members
        # (csrc/sbm_sweep.cu)
        emit, seg_totals, k_total = sweep_kernels.sweep_count(
            deltas, block_size=block_size)
    with spans.span("sweep.segment_max"):
        cap = max(int(seg_totals.max()), 1)
    with spans.span("sweep.bitmasks"):
        up = ep.is_upper.to(torch.int32)
        sadd, sdel, uadd, udel = _type_bitmasks(ep, up, n, m, block_size)
    with spans.span("sweep.scan"):
        sub_active0 = sweep_kernels.delta_scan(sadd, sdel)
        upd_active0 = sweep_kernels.delta_scan(uadd, udel)
    with spans.span("sweep.pass_c"):
        out_i, out_j = sweep_kernels.emit_pairs(
            ep.owner.clamp(min=0), up, ep.is_sub.to(torch.int32),
            (ep.owner >= 0).to(torch.int32), sub_active0, upd_active0,
            block_size=block_size, cap=cap)
        if out_i.is_cuda:
            # the launch's blocks, and on the device those that left the
            # kernel's list path: summed when the store is read, no sync
            spans.count("sweep.pass_c_blocks", out_i.shape[0])
            spans.count("sweep.pass_c_fallback_blocks",
                        sweep_kernels.emit_pairs.general_blocks)
    with spans.span("sweep.stitch"):
        pairs = _stitch_blocks(out_i, out_j, seg_totals, k_total,
                               max_pairs=max_pairs, cap=cap)
    return pairs, k_total


# ---------------------------------------------------------------------------
# Interest-managed (block-sparse) flash attention
# ---------------------------------------------------------------------------

def build_block_structure(
    seq_len_q: int,
    seq_len_kv: int,
    *,
    block_q: int = 128,
    block_k: int = 128,
    causal: bool = True,
    window: Optional[int] = None,
    num_global_blocks: int = 0,
    extra_block_mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The static block schedule, by 1-D interval matching (host numpy).

    Query block i subscribes to the key range it may see (causal prefix,
    sliding window, everything for the first ``num_global_blocks``; q is
    right-aligned to the KV window); KV block j updates its token span.
    Returns (kv_index (nq, max_nk) int32 padded with 0, kv_count (nq,)
    int32, block mask (nq, nk) bool) — the same arrays as the JAX
    package's ``repro.kernels.ops.build_block_structure``.
    """
    nq = seq_len_q // block_q
    nk = seq_len_kv // block_k
    off = seq_len_kv - seq_len_q
    q_start = np.arange(nq) * block_q + off
    q_end = q_start + block_q - 1
    lo = np.zeros(nq)
    hi = q_end.astype(np.float64) if causal else np.full(nq, seq_len_kv - 1)
    if window is not None:
        lo = np.maximum(q_start - window + 1, 0).astype(np.float64)
    if num_global_blocks:
        lo[:num_global_blocks] = 0.0
        hi[:num_global_blocks] = seq_len_kv - 1
    k_start = np.arange(nk) * block_k
    k_end = k_start + block_k - 1
    bm = (lo[:, None] <= k_end[None, :]) & (k_start[None, :] <= hi[:, None])
    if extra_block_mask is not None:
        bm |= np.asarray(extra_block_mask, bool)
    counts = bm.sum(axis=1, dtype=np.int32)
    max_nk = max(int(counts.max()), 1)
    kv_index = np.zeros((nq, max_nk), np.int32)
    for i in range(nq):
        idx = np.nonzero(bm[i])[0]
        kv_index[i, :len(idx)] = idx
    return kv_index, counts, bm


@functools.lru_cache(maxsize=64)
def _host_schedule(sq: int, skv: int, block_q: int, block_k: int,
                   causal: bool, window: Optional[int],
                   num_global_blocks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The schedule as CPU int32 tensors, built once per shape: the layers
    of a prefill share it.  Nothing writes to the cached tensors."""
    kv_index, kv_count, _ = build_block_structure(
        sq, skv, block_q=block_q, block_k=block_k, causal=causal,
        window=window, num_global_blocks=num_global_blocks)
    return torch.from_numpy(kv_index), torch.from_numpy(kv_count)


def flash_attention(
    q: torch.Tensor,            # (B, H, Sq, D)
    k: torch.Tensor,            # (B, Hkv, Skv, D)
    v: torch.Tensor,
    *,
    scale: Optional[float] = None,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_segments: Optional[torch.Tensor] = None,
    kv_segments: Optional[torch.Tensor] = None,
    num_global_blocks: int = 0,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Interest-managed flash attention (public API).

    The block schedule comes from matching the (causal, window, global)
    interest extents; within a block the token masks handle the rest
    (diagonal causality, window edges, document boundaries).  q is
    right-aligned in the KV window (``q_offset = Skv - Sq``).  ``scale``
    defaults to ``D ** -0.5``.

    When autograd records the call and q, k or v is a CUDA tensor that
    requires grad, the launch runs inside
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFunction`
    (its backward recomputes the attention in float32 over the same
    schedule); otherwise it is the wrapper's call, which on CPU tensors is
    the plain version, differentiable as it stands.
    """
    sq, skv = q.shape[2], k.shape[2]
    kv_index, kv_count = _host_schedule(sq, skv, block_q, block_k, causal,
                                        window, num_global_blocks)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)   # as the wrapper, from the true D
    if torch.is_grad_enabled() and q.device.type == "cuda" \
            and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(
            q, k, v, kv_index, kv_count, q_segments, kv_segments, scale,
            causal, window, softcap, block_q, block_k, skv - sq)
    return flash_attention_kernel(
        q, k, v, kv_index, kv_count, q_segments, kv_segments, scale=scale,
        causal=causal, window=window, softcap=softcap, block_q=block_q,
        block_k=block_k, q_offset=skv - sq)
