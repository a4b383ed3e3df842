"""Parallel Sort-Based Matching (the paper's Algorithms 4/5/6) in PyTorch.

Pipeline (paper §4):

1.  **Endpoint encoding + sort** — every extent contributes two endpoint
    records ``(value, is_upper, is_sub, owner)``.  Ties sort lowers before
    uppers so that *closed*-interval semantics hold.
2.  **Segmented local scans** and the **master prefix combine** (Fig. 5).
3.  **Emission** — at every *upper* endpoint the number of active
    counterpart extents is emitted.

For counting semantics the delta-set monoid of Algorithm 6 degenerates to
±1 integer deltas and the sweep collapses to four prefix sums, under any
of three scans (``scan_impl``, :func:`resolve_cumsum`).  The faithful
set form (Algorithm 6 with Sadd/Sdel materialized) is
:func:`segment_delta_sets` / :func:`active_sets_at_segment_starts`.
Counts are exact int64 tensors: the port behaves like the JAX package
with x64 enabled, never like its saturating int32 mode.
"""
from __future__ import annotations

import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core import prefix as prefix_lib
from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents, _np


class EndpointStream(NamedTuple):
    """Sorted endpoint records (all shape (2N,))."""

    values: torch.Tensor      # float32 endpoint coordinate (sorted)
    is_upper: torch.Tensor    # bool
    is_sub: torch.Tensor      # bool — subscription vs update endpoint
    owner: torch.Tensor       # int32 — index into the owning extent set


def encode_endpoints(subs: Extents, upds: Extents) -> EndpointStream:
    """Build + sort the endpoint stream (paper Alg. 4 lines 1-4).

    The order equals the JAX package's ``lexsort((is_upper, values))`` over
    ``[subs.lo, subs.hi, upds.lo, upds.hi]``: by value, lowers before
    uppers at equal values, then input order.  The records are laid out
    lowers first (``[subs.lo, upds.lo, subs.hi, upds.hi]``), which is that
    layout after a stable sort on ``is_upper``, so one stable sort on the
    values finishes the lexsort.  The sort key is ``value + 0.0``: it turns
    −0.0 into +0.0, so a radix sort over float bits cannot separate the
    two zeros (the reference treats them as equal and keeps input order).
    """
    n = subs.lo.shape[0]
    m = upds.lo.shape[0]
    dev = subs.lo.device
    values = torch.cat([subs.lo, upds.lo, subs.hi, upds.hi])
    is_upper = torch.cat([torch.zeros(n + m, dtype=torch.bool, device=dev),
                          torch.ones(n + m, dtype=torch.bool, device=dev)])
    sub_side = torch.cat([torch.ones(n, dtype=torch.bool, device=dev),
                          torch.zeros(m, dtype=torch.bool, device=dev)])
    is_sub = torch.cat([sub_side, sub_side])
    ids = torch.cat([torch.arange(n, dtype=torch.int32, device=dev),
                     torch.arange(m, dtype=torch.int32, device=dev)])
    owner = torch.cat([ids, ids])
    order = torch.sort(values + 0.0, stable=True).indices
    return EndpointStream(values[order], is_upper[order], is_sub[order],
                          owner[order])


def _indicator_deltas(ep: EndpointStream):
    """The four ±1 indicator streams of the counting sweep (int32)."""
    sub_lo = (ep.is_sub & ~ep.is_upper).to(torch.int32)
    sub_up = (ep.is_sub & ep.is_upper).to(torch.int32)
    upd_lo = (~ep.is_sub & ~ep.is_upper).to(torch.int32)
    upd_up = (~ep.is_sub & ep.is_upper).to(torch.int32)
    return sub_lo, sub_up, upd_lo, upd_up


def _emission_counts(sub_lo, sub_up, upd_lo, upd_up, cumsum_fn):
    """Per-endpoint emission counts given an inclusive-cumsum primitive.

    At a subscription-upper endpoint the sweep emits ``|UpdSet|`` pairs
    (updates opened at positions ≤ k, not closed before k); symmetrically
    for update-uppers.  Each overlapping pair is emitted exactly once.
    """
    c_sub_lo = cumsum_fn(sub_lo)
    c_sub_up = cumsum_fn(sub_up)
    c_upd_lo = cumsum_fn(upd_lo)
    c_upd_up = cumsum_fn(upd_up)
    active_sub_before = c_sub_lo - (c_sub_up - sub_up)
    active_upd_before = c_upd_lo - (c_upd_up - upd_up)
    return sub_up * active_upd_before + upd_up * active_sub_before


def _pad_stream(ep: EndpointStream, multiple: int) -> EndpointStream:
    """Pad to a segment multiple with inert sentinel endpoints.

    A padded record is an update-*lower* endpoint at +inf with owner −1: it
    increments active_upd after every real endpoint but is never emitted
    against (emission happens only at upper endpoints, all before it).
    """
    total = ep.values.shape[0]
    pad = (-total) % multiple
    if pad == 0:
        return ep
    dev = ep.values.device
    return EndpointStream(
        torch.cat([ep.values, torch.full((pad,), float("inf"),
                                         dtype=ep.values.dtype, device=dev)]),
        torch.cat([ep.is_upper, torch.zeros(pad, dtype=torch.bool, device=dev)]),
        torch.cat([ep.is_sub, torch.zeros(pad, dtype=torch.bool, device=dev)]),
        torch.cat([ep.owner, torch.full((pad,), -1, dtype=torch.int32,
                                        device=dev)]),
    )


def resolve_cumsum(scan_impl: str, num_segments: int):
    """Inclusive int32 cumsum primitive for a named scan backend.

    ``scan_impl``: ``'two_level'`` (paper Fig. 5,
    :func:`~repro_torch.core.prefix.cumsum_two_level`), ``'blelloch'``
    (the tree scan, :func:`~repro_torch.core.prefix.cumsum_blelloch`) or
    ``'xla'`` — the JAX package's name for its framework scan, kept for
    the surface: in the port it is the framework's own ``torch.cumsum``.
    Any other value raises :class:`ValidationError`.
    """
    if scan_impl == "two_level":
        return functools.partial(prefix_lib.cumsum_two_level,
                                 num_segments=num_segments)
    if scan_impl == "blelloch":
        return prefix_lib.cumsum_blelloch
    if scan_impl == "xla":
        return functools.partial(torch.cumsum, dim=-1, dtype=torch.int32)
    raise ValidationError(f"unknown scan_impl {scan_impl!r}")


def sbm_count(subs: Extents, upds: Extents, *, num_segments: int = 8,
              scan_impl: str = "two_level") -> torch.Tensor:
    """Parallel SBM (counting form): K = |{(i,j): S_i ∩ U_j ≠ ∅}| as a 0-d
    int64 tensor on the extents' device.

    ``scan_impl`` picks the prefix scan (:func:`resolve_cumsum`); every
    variant gives the same K.  Per-endpoint emissions fit int32 (each is
    at most max(n, m)); their sum is taken in int64, so K is exact beyond
    2³¹ — the JAX package's behaviour under x64 (without x64 it saturates
    at 2³¹−1).
    """
    cumsum_fn = resolve_cumsum(scan_impl, num_segments)
    if subs.lo.shape[-1] == 0 or upds.lo.shape[-1] == 0:
        return torch.zeros((), dtype=torch.int64, device=subs.lo.device)
    ep = _pad_stream(encode_endpoints(subs, upds), num_segments)
    emit = _emission_counts(*_indicator_deltas(ep), cumsum_fn)
    return emit.sum(dtype=torch.int64)


def sbm_count_exact(subs: Extents, upds: Extents, *, num_segments: int = 8,
                    scan_impl: str = "two_level") -> int:
    """K as a Python int (the count is exact int64 on every path)."""
    return int(sbm_count(subs, upds, num_segments=num_segments,
                         scan_impl=scan_impl))


def probe_count(subs: Extents, upds: Extents, *, num_segments: int = 8,
                scan_impl: str = "two_level") -> tuple:
    """Plan-aware counting sweep: ``(K, seconds)`` for the runtime planner.
    The exact K seeds :func:`repro_torch.core.runtime.initial_capacity`, so
    the follow-on enumeration needs zero retries."""
    t0 = time.perf_counter()
    k = sbm_count_exact(subs, upds, num_segments=num_segments,
                        scan_impl=scan_impl)
    return k, time.perf_counter() - t0


def sbm_active_profile(subs: Extents, upds: Extents, *, num_segments: int = 8):
    """Per-endpoint (active_sub, active_upd) counts *after* each endpoint —
    the paper's Fig. 4 quantity (|SubSet| as the sweep advances), over the
    padded stream.  Returns ``(ep, active_sub, active_upd)``, the counts
    int32 (two-level scans)."""
    ep = _pad_stream(encode_endpoints(subs, upds), num_segments)
    sub_lo, sub_up, upd_lo, upd_up = _indicator_deltas(ep)
    cumsum_fn = resolve_cumsum("two_level", num_segments)
    active_sub = cumsum_fn(sub_lo) - cumsum_fn(sub_up)
    active_upd = cumsum_fn(upd_lo) - cumsum_fn(upd_up)
    return ep, active_sub, active_upd


# --------------------------------------------------------------------------
# Emission ranks — the offset side of sweep-based pair enumeration
# --------------------------------------------------------------------------

def rank_tables_from_cumsums(is_sub, is_upper, owner, c_sub_lo, c_upd_lo,
                             n: int, m: int, combine=lambda t: t):
    """Per-extent emission ranges from the two lower-indicator cumsums.

    In the sorted stream every endpoint has a unique position, so pair
    (i, j) overlaps exactly when the later of the two lower endpoints falls
    strictly inside the other extent's position interval.  Partitioning
    pairs by which extent opens later makes each extent's emission set a
    contiguous rank range over the counterpart type's lower endpoints:

      class A (upd opens later):  j ∈ upds_by_lo[a_start[i] : a_start[i]+a_count[i]]
      class B (sub opens later):  i ∈ subs_by_lo[b_start[j] : b_start[j]+b_count[j]]

    ``sum(a_count) + sum(b_count) = K``.  All tables are int32; records
    with ``owner < 0`` (padding) never contribute.  Each scatter writes
    deselected records to one spare slot past the end, dropped afterwards.

    The inputs may be one rank's contiguous slice of the stream, with the
    *global* cumsums: ``combine`` then folds each locally scattered table
    into the global one (a sum over the ranks, since each endpoint lies
    in one slice); the identity when the caller holds the whole stream.
    """
    real = owner >= 0
    idx_owner = owner.to(torch.int64)

    def scatter(count, sel, idx, vals):
        out = torch.zeros(count + 1, dtype=torch.int32, device=owner.device)
        out.scatter_(0, torch.where(sel, idx, count),
                     torch.where(sel, vals, 0).to(torch.int32))
        return combine(out[:count])

    sel_s_lo = is_sub & ~is_upper & real
    sel_s_up = is_sub & is_upper & real
    sel_u_lo = ~is_sub & ~is_upper & real
    sel_u_up = ~is_sub & is_upper & real

    a_start = scatter(n, sel_s_lo, idx_owner, c_upd_lo)
    a_end = scatter(n, sel_s_up, idx_owner, c_upd_lo)
    b_start = scatter(m, sel_u_lo, idx_owner, c_sub_lo)
    b_end = scatter(m, sel_u_up, idx_owner, c_sub_lo)
    # rank → extent id (c_*_lo - 1 is this lower endpoint's 0-based rank)
    subs_by_lo = scatter(n, sel_s_lo, c_sub_lo.to(torch.int64) - 1, owner)
    upds_by_lo = scatter(m, sel_u_lo, c_upd_lo.to(torch.int64) - 1, owner)
    return a_start, a_end - a_start, b_start, b_end - b_start, \
        subs_by_lo, upds_by_lo


def emission_rank_tables(ep: EndpointStream, n: int, m: int, cumsum_fn):
    """:func:`rank_tables_from_cumsums` over a whole sorted stream, with the
    two lower-indicator cumsums from ``cumsum_fn``.  Requires lo <= hi."""
    sub_lo, _sub_up, upd_lo, _upd_up = _indicator_deltas(ep)
    return rank_tables_from_cumsums(
        ep.is_sub, ep.is_upper, ep.owner,
        cumsum_fn(sub_lo), cumsum_fn(upd_lo), n, m)


# --------------------------------------------------------------------------
# Faithful set-form (Algorithm 5 + 6): delta sets + monoid prefix
# --------------------------------------------------------------------------

def segment_delta_sets(ep: EndpointStream, num_segments: int, n: int, m: int):
    """Algorithm 6 lines 1-17, vectorized.

    Returns (Sadd, Sdel, Uadd, Udel), each (P, n|m) boolean on the
    stream's device: Sadd[p] = subs whose *lower* is in segment p and
    upper is not; Sdel[p] = subs whose *upper* is in segment p and lower
    is not.  ``ep`` must be padded to a multiple of ``num_segments``
    (:class:`ValidationError` otherwise).
    """
    total = ep.values.shape[0]
    if total % num_segments:
        raise ValidationError("stream must be padded to a segment multiple")
    dev = ep.values.device
    seg = total // num_segments
    seg_of = torch.arange(total, dtype=torch.int64, device=dev) // seg
    segs = torch.arange(num_segments, dtype=torch.int64, device=dev)
    real = ep.owner >= 0
    owner = ep.owner.to(torch.int64)

    def segment_of(sel, count):
        # segment holding each extent's selected endpoint (-1: none);
        # deselected records land in a spare slot past the end
        out = torch.full((count + 1,), -1, dtype=torch.int64, device=dev)
        out.scatter_(0, torch.where(sel, owner, count),
                     torch.where(sel, seg_of, -1))
        return out[:count]

    def per_type(side, count):
        lo_seg = segment_of(side & ~ep.is_upper & real, count)
        up_seg = segment_of(side & ep.is_upper & real, count)
        add = (lo_seg[None, :] == segs[:, None]) \
            & (up_seg[None, :] != segs[:, None])
        rem = (up_seg[None, :] == segs[:, None]) \
            & (lo_seg[None, :] != segs[:, None])
        return add, rem

    sadd, sdel = per_type(ep.is_sub, n)
    uadd, udel = per_type(~ep.is_sub, m)
    return sadd, sdel, uadd, udel


def active_sets_at_segment_starts(subs: Extents, upds: Extents,
                                  num_segments: int):
    """SubSet[p]/UpdSet[p] of Algorithm 6 lines 18-21 (boolean masks):
    ``(ep, sub_active, upd_active)`` with the active sets *entering* each
    segment of the padded stream."""
    n, m = subs.lo.shape[0], upds.lo.shape[0]
    ep = _pad_stream(encode_endpoints(subs, upds), num_segments)
    sadd, sdel, uadd, udel = segment_delta_sets(ep, num_segments, n, m)
    sub_active = prefix_lib.delta_scan_exclusive(sadd, sdel)
    upd_active = prefix_lib.delta_scan_exclusive(uadd, udel)
    return ep, sub_active, upd_active


# --------------------------------------------------------------------------
# Distributed sweep: the paper's algorithm across a device-mesh dimension
# --------------------------------------------------------------------------

def sbm_count_shard_body(sub_lo, sub_up, upd_lo, upd_up, *, group):
    """Per-rank body: this rank's contiguous shard of the four indicator
    streams of the sorted, padded stream (a multiple of
    ``kernels.ops.COUNT_BLOCK`` long), the ranks of ``group`` holding the
    shards in order.  Returns the global K as a 0-d int64 tensor.

    Exactly the paper's three phases with "processor" := rank: local
    deltas (pass A, :func:`repro_torch.kernels.sbm_sweep.block_sums`, over
    the shard's segments) → all-gather master combine (each rank's (4,)
    column totals; the earlier ranks' sum is the shard's carry, added to
    the local exclusive scan of the segment sums) → local emission (pass
    B, :func:`repro_torch.kernels.sbm_sweep.emission`, from those
    offsets).  K is the all-reduce of the shards' int64 emission totals:
    exact beyond 2³¹, the JAX package's behaviour under x64.  On CUDA
    tensors passes A and B are the kernels; on CPU tensors their plain
    versions.
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels import sbm_sweep as sweep_kernels

    bs = ops.COUNT_BLOCK
    deltas = torch.stack([sub_lo, sub_up, upd_lo, upd_up]).to(torch.int32)
    sums = sweep_kernels.block_sums(deltas, block_size=bs)
    carry = prefix_lib.shard_exclusive_offsets(
        sums.sum(dim=0, dtype=torch.int32), group)
    offsets = torch.cumsum(sums, dim=0, dtype=torch.int32) - sums + carry
    _, seg = sweep_kernels.emission(deltas, offsets, block_size=bs)
    return collectives.all_reduce_sum(seg.sum(dtype=torch.int64), group)


def sbm_count_sharded(subs: Extents, upds: Extents, mesh, axis_name: str):
    """End-to-end distributed SBM count over one dimension of a
    ``DeviceMesh``: K as a 0-d int64 tensor on the extents' device, the
    same on every rank.

    Every rank of the dimension calls it with the same extents.  Each
    sorts the whole endpoint stream (as the JAX package sorts before its
    ``shard_map``), pads it with inert sentinels to a multiple of
    P · ``COUNT_BLOCK`` and sweeps its own contiguous shard
    (:func:`sbm_count_shard_body`); the active-set carry crosses ranks
    through the gathered shard totals.
    """
    from repro_torch.kernels import ops

    group, p, index = collectives.mesh_axis(mesh, axis_name)
    if subs.size == 0 or upds.size == 0:
        return torch.zeros((), dtype=torch.int64, device=subs.lo.device)
    ep = _pad_stream(encode_endpoints(subs, upds), p * ops.COUNT_BLOCK)
    shard = ep.values.shape[0] // p
    part = slice(index * shard, (index + 1) * shard)
    return sbm_count_shard_body(*(d[part] for d in _indicator_deltas(ep)),
                                group=group)


# --------------------------------------------------------------------------
# Sequential references (host) — Algorithm 4 verbatim
# --------------------------------------------------------------------------

def _host_stream(subs: Extents, upds: Extents):
    s_lo, s_hi, u_lo, u_hi = (_np(a) for a in (subs.lo, subs.hi,
                                              upds.lo, upds.hi))
    n, m = s_lo.shape[0], u_lo.shape[0]
    values = np.concatenate([s_lo, s_hi, u_lo, u_hi])
    is_upper = np.concatenate([np.zeros(n, bool), np.ones(n, bool),
                               np.zeros(m, bool), np.ones(m, bool)])
    is_sub = np.concatenate([np.ones(2 * n, bool), np.zeros(2 * m, bool)])
    owner = np.concatenate([np.arange(n), np.arange(n),
                            np.arange(m), np.arange(m)])
    return np.lexsort((is_upper, values)), is_upper, is_sub, owner


def sequential_sbm_count_numpy(subs: Extents, upds: Extents) -> int:
    """Paper Algorithm 4 with counting semantics — the serial baseline."""
    order, is_upper, is_sub, _ = _host_stream(subs, upds)
    k = 0
    sub_active = 0
    upd_active = 0
    for up, sb in zip(is_upper[order].tolist(), is_sub[order].tolist()):
        if sb:
            if not up:
                sub_active += 1
            else:
                sub_active -= 1
                k += upd_active
        else:
            if not up:
                upd_active += 1
            else:
                upd_active -= 1
                k += sub_active
    return k


def sequential_sbm_pairs_numpy(subs: Extents, upds: Extents) -> set:
    """Paper Algorithm 4 verbatim (set semantics, emits pairs)."""
    order, is_upper, is_sub, owner = _host_stream(subs, upds)
    sub_set: set = set()
    upd_set: set = set()
    out = set()
    for up, sb, o in zip(is_upper[order].tolist(), is_sub[order].tolist(),
                         owner[order].tolist()):
        if sb:
            if not up:
                sub_set.add(o)
            else:
                sub_set.discard(o)
                out.update((o, j) for j in upd_set)
        else:
            if not up:
                upd_set.add(o)
            else:
                upd_set.discard(o)
                out.update((i, o) for i in sub_set)
    return out


def sequential_sbm_pairs_numpy_ddim(subs: Extents, upds: Extents,
                                    sweep_dim: int = 0) -> set:
    """Algorithm 4 extended to d dims: the 1-d sweep on ``sweep_dim``, then
    the paper-§3 projection filter on every other dimension — the host
    reference of the d-dim engines (any ``sweep_dim`` gives the same set)."""
    if subs.ndim_space == 1:
        return sequential_sbm_pairs_numpy(subs, upds)
    cand = sequential_sbm_pairs_numpy(subs.dim(sweep_dim), upds.dim(sweep_dim))
    s_lo, s_hi, u_lo, u_hi = (_np(a) for a in (subs.lo, subs.hi,
                                              upds.lo, upds.hi))
    others = [d for d in range(subs.ndim_space) if d != sweep_dim]
    return {(i, j) for i, j in cand
            if all(s_lo[d, i] <= u_hi[d, j] and u_lo[d, j] <= s_hi[d, i]
                   for d in others)}
