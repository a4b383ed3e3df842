"""Grid-based matching — paper §3.2 (Boukerche & Dzermajko).

The routing space is cut into ``G`` cells; extents are binned to the cells
they overlap; per-cell brute force finds candidates.  A pair sharing several
cells would be reported repeatedly, so it is counted only in the cell of
``max(S.lo, U.lo)``, which makes the count exact without a filtering pass.

Binning uses the sort-based machinery (sort extent-cell assignments, rank
inside the cell) into per-cell buckets of ``cap`` slots; an assignment
whose stable rank in its cell reaches ``cap`` is dropped, and the count is
then a lower bound (the JAX package's degraded estimate, reproduced
exactly: the same buckets, the same drops).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.errors import GridOverflowError  # noqa: F401  (re-export)
from repro_torch.core.intervals import Extents, intersect_1d


def _cell_of(x: torch.Tensor, cell_width: torch.Tensor, num_cells: int
             ) -> torch.Tensor:
    """floor(x / cell_width) in float32 (Python's floor division through
    fmod, as ``jnp.floor_divide``), clipped into [0, num_cells − 1], as
    int64.  ``cell_width`` is a 0-d float32 tensor, so no step runs in
    double precision."""
    q = torch.div(x, cell_width, rounding_mode="floor")
    return q.clamp(0, num_cells - 1).to(torch.int64)


def _bin_extents(lo: torch.Tensor, hi: torch.Tensor, num_cells: int,
                 cell_width: torch.Tensor, cap: int):
    """Distribute extents into per-cell padded buckets.

    Returns (buckets (G, cap) int64 — indices into the extent set in
    extent-index order, padded with -1; overflow — the 0-d int64 count of
    assignments dropped beyond ``cap``).  An extent spanning c cells lands
    in each.
    """
    n = lo.shape[0]
    dev = lo.device
    first = _cell_of(lo, cell_width, num_cells)
    last = _cell_of(hi, cell_width, num_cells)
    offs = torch.arange(num_cells, dtype=torch.int64, device=dev)
    cell = first[:, None] + offs[None, :]
    valid = offs[None, :] < (last - first + 1)[:, None]
    cell = torch.where(valid, cell, num_cells).reshape(-1)   # overflow bucket
    ext = torch.arange(n, dtype=torch.int64, device=dev)[:, None] \
        .expand(n, num_cells).reshape(-1)
    order = torch.sort(cell, stable=True).indices
    cell_sorted = cell[order]
    ext_sorted = ext[order]
    pos = torch.arange(cell_sorted.shape[0], dtype=torch.int64, device=dev)
    seg_start = torch.searchsorted(
        cell_sorted, torch.arange(num_cells + 1, dtype=torch.int64,
                                  device=dev))
    rank = pos - seg_start[cell_sorted]
    ok = (rank < cap) & (cell_sorted < num_cells)
    buckets = torch.full((num_cells + 1, cap), -1, dtype=torch.int64,
                         device=dev)
    buckets[torch.where(ok, cell_sorted, num_cells),
            rank.clamp(0, cap - 1)] = torch.where(ok, ext_sorted, -1)
    counts = seg_start[1:] - seg_start[:-1]
    overflow = (counts - cap).clamp(min=0).sum(dtype=torch.int64)
    return buckets[:num_cells], overflow


def _gather(e: Extents, idx: torch.Tensor):
    """Bounds of bucket slots; empty slots become inert [+inf, -inf]."""
    live = idx >= 0
    safe = idx.clamp(min=0)
    return (torch.where(live, e.lo[safe], float("inf")),
            torch.where(live, e.hi[safe], float("-inf")))


def grid_count(subs: Extents, upds: Extents, *, num_cells: int = 64,
               length: float = 1.0e6, cap: int = 512, strict: bool = False):
    """Match count via grid binning + per-cell BF with first-cell dedup.

    Returns (count, overflow), 0-d int64 tensors on the extents' device.
    A nonzero overflow means ``cap`` was too small for the densest cell
    and the count is a LOWER BOUND — the JAX package's bound and overflow,
    exactly.  With ``strict=True`` that undercount raises
    :class:`GridOverflowError` instead.  The cell width is
    ``length / num_cells`` in float32; coordinates below 0 fold into cell
    0 and coordinates past ``length`` into the last cell (the count stays
    exact, but the load concentrates there and overflows ``cap`` early).
    """
    dev = subs.lo.device
    cell_w = torch.tensor(np.float32(length) / np.float32(num_cells),
                          dtype=torch.float32, device=dev)
    s_buckets, s_over = _bin_extents(subs.lo, subs.hi, num_cells, cell_w, cap)
    u_buckets, u_over = _bin_extents(upds.lo, upds.hi, num_cells, cell_w, cap)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for c in range(num_cells):
        s_lo, s_hi = _gather(subs, s_buckets[c])
        u_lo, u_hi = _gather(upds, u_buckets[c])
        hit = intersect_1d(s_lo[:, None], s_hi[:, None],
                           u_lo[None, :], u_hi[None, :])
        # first-shared-cell dedup: count only where max(lo) is in this cell
        start = torch.where(hit, torch.maximum(s_lo[:, None], u_lo[None, :]),
                            0.0)
        hit = hit & (_cell_of(start, cell_w, num_cells) == c)
        count += hit.sum(dtype=torch.int64)
    overflow = s_over + u_over
    if strict and int(overflow) > 0:
        raise GridOverflowError(
            f"grid_count overflow: {int(overflow)} extent-cell assignments "
            f"dropped beyond cap={cap} (count {int(count)} is a lower "
            "bound) — raise cap or num_cells")
    return count, overflow
