"""Match matrices and padded index lists — the interface between DDM
matching and block-sparse attention.

Attention blocks are extents: query block i *subscribes* to the key range
it is interested in (sliding window, global section, its own document, …)
and KV block j *updates* the token range it covers.  The match matrix is
the block-sparsity structure of the flash-attention kernel, and the padded
row-index form is its gather schedule.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.intervals import Extents, intersect_1d, intersect_ddim


def match_matrix(subs: Extents, upds: Extents) -> torch.Tensor:
    """(n, m) boolean match matrix (1-d extents)."""
    return intersect_1d(subs.lo[:, None], subs.hi[:, None],
                        upds.lo[None, :], upds.hi[None, :])


def match_matrix_ddim(subs: Extents, upds: Extents) -> torch.Tensor:
    """(n, m) boolean match matrix for d-rectangles (AND over projections)."""
    if subs.ndim_space == 1:
        return match_matrix(subs, upds)
    return intersect_ddim(subs, upds)


def row_index_lists(mask: torch.Tensor, *, max_per_row: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row padded column-index lists from a boolean matrix.

    Sort-based compaction: a stable sort of the negated rows puts the
    matching columns, in ascending column order, in the first
    ``row_count`` slots.  Returns (idx (n, max_per_row) int32 padded with
    -1, counts (n,) int32).
    """
    counts = mask.sum(dim=-1, dtype=torch.int32)
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    idx = order[:, :max_per_row].to(torch.int32)
    slot = torch.arange(max_per_row, dtype=torch.int32,
                        device=mask.device)[None, :]
    return torch.where(slot < counts[:, None], idx, -1), counts


def block_extents_for_sequence(seq_len: int, block: int,
                               *, window: int | None = None,
                               causal: bool = True,
                               num_global_blocks: int = 0,
                               device="cuda") -> Tuple[Extents, Extents]:
    """Interest extents for block-sparse attention over a token sequence,
    on ``device``.

    Query block q covers tokens [q·B, (q+1)·B-1]; its *subscription*
    extent is the key range it may attend to:

      * causal: [0, (q+1)·B - 1]                     (prefix)
      * + window w: [max(0, q·B - w + 1), (q+1)·B - 1] (sliding window)
      * the first ``num_global_blocks`` query blocks subscribe to the
        whole sequence.

    KV block k's *update* extent is its token span.  Matching the two sets
    gives the block mask of local/global/causal attention.  All arithmetic
    is float32, as in the JAX package.
    """
    nq = -(-seq_len // block)
    q_start = torch.arange(nq, dtype=torch.float32, device=device) * block
    q_end = torch.clamp(q_start + block, max=float(seq_len)) - 1
    lo = torch.zeros(nq, dtype=torch.float32, device=device) if causal \
        else q_start * 0.0
    if window is not None:
        lo = torch.clamp(q_start - window + 1, min=0.0)
    hi = q_end if causal else torch.full((nq,), float(seq_len - 1),
                                         dtype=torch.float32, device=device)
    if num_global_blocks:
        is_global = torch.arange(nq, device=device) < num_global_blocks
        lo = torch.where(is_global, 0.0, lo)
        hi = torch.where(is_global, float(seq_len - 1), hi)
    return Extents(lo, hi), Extents(q_start, q_end)


def block_mask_from_extents(q_sub: Extents, kv_upd: Extents) -> torch.Tensor:
    """Block-sparsity mask (nq, nk) from interest extents (DDM matching)."""
    return match_matrix(q_sub, kv_upd)


def document_extents(doc_ids: torch.Tensor, num_docs: int) -> Extents:
    """Per-document token-span extents from a packed doc-id vector.

    doc_ids: (seq,) non-decreasing packed-document labels.  Returns
    ``num_docs`` float32 extents [first_token, last_token] on doc_ids'
    device (empty docs: lo > hi, so they match nothing), by searchsorted.
    """
    ids = torch.arange(num_docs, dtype=doc_ids.dtype, device=doc_ids.device)
    first = torch.searchsorted(doc_ids, ids, right=False)
    last = torch.searchsorted(doc_ids, ids, right=True) - 1
    return Extents(first.to(torch.float32), last.to(torch.float32))
