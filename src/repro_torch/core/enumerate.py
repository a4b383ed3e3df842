"""Pair enumeration — count → prefix offsets → scatter, padded buffers.

Two engines behind the same (pairs, count) contract:

* :func:`sbm_enumerate` — the sort-based sweep in its rank-table form,
  output-sensitive O((n+m)·log(n+m) + K): per-extent emission ranges come
  from the indicator cumsums, their exclusive scan is the offset table and
  a slot-parallel gather (searchsorted + gather) materializes the pairs.
  :func:`repro_torch.kernels.ops.sbm_enumerate_kernel` is the kernel form.
* :func:`enumerate_matches` — blocked all-pairs O(n·m) + compaction, the
  cross-check oracle.

:func:`sbm_enumerate_sharded` runs the sweep's scheme across the ranks of
one ``DeviceMesh`` dimension.

Overflow contract (all engines): pairs beyond ``max_pairs`` are dropped but
still counted — callers check ``count <= max_pairs`` and retry bigger.
Counts are exact int64 tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core import prefix as prefix_lib
from repro_torch.core import runtime as runtime_lib
from repro_torch.core.intervals import Extents, intersect_1d
from repro_torch.core.sweep import (_indicator_deltas, _pad_stream,
                                    emission_rank_tables, encode_endpoints,
                                    probe_count, rank_tables_from_cumsums,
                                    resolve_cumsum,
                                    sequential_sbm_pairs_numpy)


def _empty_result(max_pairs: int, device):
    return (torch.full((max_pairs, 2), -1, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int64, device=device))


def sbm_enumerate(subs: Extents, upds: Extents, *, max_pairs: int,
                  num_segments: int = 8, scan_impl: str = "two_level"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All matching (i, j) pairs via the sort-based sweep (1-d extents).

    Returns (pairs (max_pairs, 2) int32 padded with (−1, −1), count as a
    0-d int64 tensor).  Deterministic order: subscription emitters by id,
    then update emitters by id, each range ordered by the counterpart's
    lower-endpoint rank — the JAX package's order.  ``scan_impl`` picks
    the prefix scan of the rank tables (:func:`~repro_torch.core.sweep.
    resolve_cumsum`); the buffer is the same under every variant.
    Requires lo <= hi.
    """
    cumsum_fn = resolve_cumsum(scan_impl, num_segments)
    dev = subs.lo.device
    n, m = subs.size, upds.size
    if n == 0 or m == 0:
        return _empty_result(max_pairs, dev)
    ep = _pad_stream(encode_endpoints(subs, upds), num_segments)
    a_start, a_cnt, b_start, b_cnt, subs_by_lo, upds_by_lo = \
        emission_rank_tables(ep, n, m, cumsum_fn)

    # Offset table: scan of per-emitter counts (the n subs then the m upds),
    # exact in int64.
    counts = torch.cat([a_cnt, b_cnt]).to(torch.int64)
    off = torch.cumsum(counts, dim=0, dtype=torch.int64)
    k_total = off[-1]

    # Slot-parallel emission: slot s belongs to the emitter whose offset
    # range contains it; its rank within the emitter selects the
    # counterpart by lower-endpoint rank (a contiguous range).
    slots = torch.arange(max_pairs, dtype=torch.int64, device=dev)
    e = torch.searchsorted(off, slots, right=True).clamp(max=n + m - 1)
    r = slots - (off[e] - counts[e])
    is_a = e < n
    j_of_a = upds_by_lo[(a_start[e.clamp(max=n - 1)] + r).clamp(0, m - 1)]
    i_of_b = subs_by_lo[(b_start[(e - n).clamp(0, m - 1)] + r).clamp(0, n - 1)]
    pi = torch.where(is_a, e, i_of_b)
    pj = torch.where(is_a, j_of_a, e - n)
    valid = slots < torch.clamp(k_total, max=max_pairs)
    pairs = torch.where(valid[:, None], torch.stack([pi, pj], dim=-1), -1)
    return pairs.to(torch.int32), k_total


def sbm_enumerate_sharded(subs: Extents, upds: Extents, mesh,
                          axis_name: str, *, max_pairs: int,
                          max_pairs_per_shard: int | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed sweep enumeration over one dimension of a ``DeviceMesh``.

    Every rank calls it with the same extents and gets the same (pairs
    (max_pairs, 2) int32, count 0-d int64).  The sorted stream, padded to
    a multiple of P, is split into contiguous shards; the two lower-
    indicator cumsums run as the distributed two-level scan, the rank
    tables are summed over the ranks (O(n+m) of traffic), and each rank
    emits the pairs whose emitting upper endpoint it holds into a local
    buffer of ``max_pairs_per_shard`` (default ``max_pairs``) pairs.  The
    buffers are gathered and stitched in rank order by the shard totals'
    prefix; a shard that emitted more than its buffer leaves (-1, -1)
    holes where its excess would go.  Order: upper endpoints in stream
    order, each emitter's counterparts by lower-endpoint rank.

    The count is exact int64 and the buffer is never blanked: the JAX
    package's behaviour under x64 (without x64 it pins the count at
    2³¹−1 and blanks the buffer once K passes it).
    """
    group, p, index = collectives.mesh_axis(mesh, axis_name)
    dev = subs.lo.device
    n, m = subs.size, upds.size
    if n == 0 or m == 0:
        return _empty_result(max_pairs, dev)
    cap = max_pairs if max_pairs_per_shard is None else max_pairs_per_shard
    ep = _pad_stream(encode_endpoints(subs, upds), p)
    shard = ep.values.shape[0] // p
    part = slice(index * shard, (index + 1) * shard)
    owner, is_sub, is_upper = ep.owner[part], ep.is_sub[part], \
        ep.is_upper[part]
    sub_lo, _sub_up, upd_lo, _upd_up = (d[part] for d in _indicator_deltas(ep))
    # stream positions fit int32 (the pair counts below do not)
    c_sub_lo = prefix_lib.shard_inclusive_cumsum(sub_lo, group)
    c_upd_lo = prefix_lib.shard_inclusive_cumsum(upd_lo, group)
    a_start, a_cnt, b_start, b_cnt, subs_by_lo, upds_by_lo = \
        rank_tables_from_cumsums(
            is_sub, is_upper, owner, c_sub_lo, c_upd_lo, n, m,
            combine=lambda t: collectives.all_reduce_sum(t, group))

    # one count per local upper endpoint: its emitter's class count
    real = owner >= 0
    sel_s_up = is_sub & is_upper & real
    sel_u_up = ~is_sub & is_upper & real
    o = owner.clamp(min=0).to(torch.int64)
    cnt = (torch.where(sel_s_up, a_cnt[o.clamp(max=n - 1)], 0)
           + torch.where(sel_u_up, b_cnt[o.clamp(max=m - 1)], 0)
           ).to(torch.int64)
    lc = torch.cumsum(cnt, dim=0, dtype=torch.int64)
    local_total = lc[-1]

    slots = torch.arange(cap, dtype=torch.int64, device=dev)
    e = torch.searchsorted(lc, slots, right=True).clamp(max=shard - 1)
    r = slots - (lc[e] - cnt[e])
    oe = o[e]
    j_of_a = upds_by_lo[(a_start[oe.clamp(max=n - 1)] + r).clamp(0, m - 1)]
    i_of_b = subs_by_lo[(b_start[oe.clamp(max=m - 1)] + r).clamp(0, n - 1)]
    is_a = sel_s_up[e]
    pi = torch.where(is_a, oe, i_of_b)
    pj = torch.where(is_a, j_of_a, oe)
    buf = torch.where((slots < local_total)[:, None],
                      torch.stack([pi, pj], dim=-1), -1).to(torch.int32)

    # the master step: every shard's total, then the stitch by their prefix
    totals = collectives.all_gather(local_total, group)          # (P,)
    incl = torch.cumsum(totals, dim=0, dtype=torch.int64)
    base = incl - totals
    k_total = incl[-1]
    bufs = collectives.all_gather(buf, group)                     # (P, cap, 2)
    out = torch.full((max_pairs, 2), -1, dtype=torch.int32, device=dev)
    if cap:
        slots = torch.arange(max_pairs, dtype=torch.int64, device=dev)
        s = torch.searchsorted(incl, slots, right=True).clamp(max=p - 1)
        r = slots - base[s]
        valid = (slots < k_total.clamp(max=max_pairs)) & (r < cap)
        out = torch.where(valid[:, None], bufs[s, r.clamp(0, cap - 1)], out)
    return out, k_total


def sbm_enumerate_planned(subs: Extents, upds: Extents, *,
                          num_segments: int = 8,
                          scan_impl: str = "two_level",
                          policy: runtime_lib.CapacityPolicy =
                          runtime_lib.DEFAULT_POLICY,
                          recorder: runtime_lib.StatsRecorder | None = None):
    """Plan-aware sweep enumeration: probe → plan → emit, instrumented.

    The counting sweep's exact K sizes ``max_pairs`` to its ladder bucket,
    so the executor needs zero retries.  Returns ``(pairs, count, stats)``.
    """
    dev = subs.lo.device
    if subs.size == 0 or upds.size == 0:
        stats = runtime_lib.MatchStats(engine="sweep", count=0, capacity=0)
        stats.add_phase("probe", 0.0)
        if recorder is not None:
            recorder.record(stats)
        return (torch.full((0, 2), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev), stats)

    k, probe_s = probe_count(subs, upds, num_segments=num_segments,
                             scan_impl=scan_impl)

    def fn(s, u, *, max_pairs):
        return sbm_enumerate(s, u, max_pairs=max_pairs,
                             num_segments=num_segments, scan_impl=scan_impl)

    return runtime_lib.execute_enumeration(
        fn, subs, upds, estimate=k, policy=policy, engine="sweep",
        probe_seconds=probe_s, recorder=recorder)


def enumerate_matches(subs: Extents, upds: Extents, *, max_pairs: int,
                      block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """All matching (i, j) pairs of 1-d extents, padded to ``max_pairs``
    with (−1, −1), in (i, j) order: blocked all-pairs test + compaction.
    O(n·m) — the oracle the sweep engines are tested against.  Pairs beyond
    ``max_pairs`` are dropped but still counted."""
    dev = subs.lo.device
    out = torch.full((max_pairs, 2), -1, dtype=torch.int32, device=dev)
    count = 0
    for start in range(0, subs.size, block):
        stop = min(start + block, subs.size)
        mask = intersect_1d(subs.lo[start:stop, None], subs.hi[start:stop, None],
                            upds.lo[None, :], upds.hi[None, :])
        idx = mask.nonzero().to(torch.int32)          # row-major: (i, j) order
        idx[:, 0] += start
        take = max(0, min(idx.shape[0], max_pairs - count))
        out[count:count + take] = idx[:take]
        count += idx.shape[0]
    return out, torch.tensor(count, dtype=torch.int64, device=dev)


def enumerate_matches_sweep_numpy(subs: Extents, upds: Extents) -> np.ndarray:
    """Host-side O(N log N + K) enumeration via the sequential sweep, as a
    sorted (K, 2) int32 array."""
    pairs = sorted(sequential_sbm_pairs_numpy(subs, upds))
    if not pairs:
        return np.zeros((0, 2), np.int32)
    return np.asarray(pairs, np.int32)
