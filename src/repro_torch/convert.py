"""State carried across from the JAX package's objects to the port's.

* :func:`service_from_tables` — a reference ``DDMService``'s region tables
  (``_subs``/``_upds``: ``lo``/``hi`` ``(d, capacity)`` float32, ``live``
  ``(capacity,)`` bool, ``free`` a list of ints) → a port
  :class:`~repro_torch.core.service.DDMService` that holds the same regions
  under the same rids.
* :func:`extents_from_arrays` — extents from array-likes (numpy, or
  anything ``np.asarray`` reads, such as the JAX package's arrays) to the
  port's tensor :class:`~repro_torch.core.intervals.Extents`.

Everything crosses as numpy arrays and lists, so nothing here imports the
JAX package.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.incremental import SUB, UPD
from repro_torch.core.intervals import Extents
from repro_torch.core.service import DDMService, _RegionTable


class RegionTableState(NamedTuple):
    """One side's region table as plain arrays (the reference layout)."""

    lo: np.ndarray      # (d, capacity) float32, dead slots +inf
    hi: np.ndarray      # (d, capacity) float32, dead slots -inf
    live: np.ndarray    # (capacity,) bool
    free: List[int]     # free rids; list.pop() takes the next one


def _table(state, side: str) -> _RegionTable:
    lo = np.array(state.lo, dtype=np.float32, copy=True)
    hi = np.array(state.hi, dtype=np.float32, copy=True)
    live = np.array(state.live, dtype=bool, copy=True)
    free = [int(r) for r in state.free]
    if lo.ndim != 2 or lo.shape[0] < 1 or hi.shape != lo.shape \
            or live.shape != (lo.shape[1],):
        raise ValidationError(
            f"{side} table must have lo/hi (d, capacity) with d >= 1 and live "
            f"(capacity,): got lo {lo.shape}, hi {hi.shape}, live {live.shape}")
    bad = [r for r in free if not 0 <= r < live.shape[0] or live[r]]
    if bad or len(set(free)) != len(free):
        raise ValidationError(
            f"{side} free list must hold distinct dead rids "
            f"(offending: {bad[:4]})")
    return _RegionTable(lo=lo, hi=hi, live=live, free=free)


def service_from_tables(subs, upds, *, device="cuda",
                        **service_kwargs) -> DDMService:
    """A port service holding the regions of a reference service.

    ``subs``/``upds`` are the reference's ``_subs``/``_upds`` tables, or
    :class:`RegionTableState`\\ s with the same four fields.  The free lists
    are taken as they are: their order reflects the reference's history and
    decides which rids later registrations get.  The index is loaded with
    every live region under its own rid; the match cache starts cold, so the
    first ``pairs()`` rebuilds it with the sweep.  The service's ``dims``
    is the tables' d; both tables must have the same d.
    """
    sub_table = _table(subs, SUB)
    upd_table = _table(upds, UPD)
    dims = sub_table.lo.shape[0]
    if upd_table.lo.shape[0] != dims:
        raise ValidationError(
            f"{SUB} table has d = {dims}, {UPD} table d = "
            f"{upd_table.lo.shape[0]}")
    svc = DDMService(dims=dims, device=device, **service_kwargs)
    svc._subs = sub_table
    svc._upds = upd_table
    adds = {}
    for side, table in ((SUB, svc._subs), (UPD, svc._upds)):
        rids = table.live_ids()
        if rids.size:
            adds[side] = (rids, table.lo[:, rids].T, table.hi[:, rids].T)
    if adds:
        svc._index.apply_batch_arrays(adds=adds, want_delta=False)
    return svc


def extents_from_arrays(lo, hi, *, device="cuda") -> Extents:
    """Extents over tensors on ``device`` from array-likes ``(n,)`` or
    ``(d, n)`` (float32)."""
    return Extents(
        torch.from_numpy(np.array(lo, np.float32)).to(device),
        torch.from_numpy(np.array(hi, np.float32)).to(device)).validate()
