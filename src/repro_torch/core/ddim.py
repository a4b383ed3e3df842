"""True d-dimensional matching: selective-dimension sweep + bit-matrix AND.

The paper states the DDM problem for d-dimensional axis-parallel rectangles
but evaluates in 1-d; its journal version (arXiv:1911.03456) resolves the
d > 1 case with per-dimension match bit-vectors combined by bitwise AND.
Both d-dim strategies of the JAX package, on the port's sweep substrate:

* **Selective-dimension sweep** — the counting sweep probes every
  projection, the dimension with the fewest 1-d matches generates
  candidates and the other projections are filtered pairwise.
  ``max_pairs`` must bound the *generator-dimension* candidate count.  The
  probe and the candidate engine are parameters (``count_fn``/``engine``):
  the defaults are the plain torch sweep (:func:`sbm_count`,
  :func:`sbm_enumerate`, the reference's pair order); the service passes
  the kernel entry points of :mod:`repro_torch.kernels.ops`.
* **Bit-matrix AND** — one packed match bitmap AND-reduced across
  dimensions (n × ceil(m/32) words); ``max_pairs`` bounds only the final
  K.  The words come from :func:`repro_torch.kernels.bitmatch.bitmatch`:
  the CUDA kernel for tensors on the card, its plain version on the CPU.

Counts are exact int64 tensors (the JAX package under x64).
:func:`bitmatrix_sharded` shards the subscription rows of the bit-matrix
over one ``DeviceMesh`` dimension.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import collectives
from repro_torch.core import prefix as prefix_lib
from repro_torch.core import runtime as runtime_lib
from repro_torch.core.enumerate import (_empty_result, enumerate_matches,
                                        sbm_enumerate)
from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents, intersect_1d
from repro_torch.core.sweep import sbm_count, sbm_count_exact
from repro_torch.kernels import bitmatch as bitmatch_kernels
from repro_torch.perf import spans

METHODS = ("sweep", "bitmatrix", "blocked")


def _dim_rows(e: Extents) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, n) views of lo/hi — promotes the 1-d layout to one row."""
    if e.lo.ndim == 1:
        return e.lo[None, :], e.hi[None, :]
    return e.lo, e.hi


# ---------------------------------------------------------------------------
# Dimension selection (the cheap counting sweep as a selectivity probe)
# ---------------------------------------------------------------------------

def per_dimension_counts(subs: Extents, upds: Extents, *,
                         num_segments: int = 8,
                         count_fn: Optional[Callable] = None
                         ) -> Tuple[int, ...]:
    """1-d match count of every projection — d counting sweeps.

    Each count is the candidate-buffer size a sweep on that dimension would
    need.  ``count_fn(a, b)`` counts one projection (default: the plain
    :func:`sbm_count` with ``num_segments``).
    """
    if count_fn is None:
        def count_fn(a, b):
            return sbm_count(a, b, num_segments=num_segments)
    return tuple(int(count_fn(subs.dim(d), upds.dim(d)))
                 for d in range(subs.ndim_space))


def select_dimension(subs: Extents, upds: Extents, *, num_segments: int = 8,
                     count_fn: Optional[Callable] = None
                     ) -> Tuple[int, Tuple[int, ...]]:
    """(most selective dimension, per-dimension 1-d counts).

    The generator dimension is the argmin of the per-projection match
    counts; ties break toward the lower dimension index.
    """
    counts = per_dimension_counts(subs, upds, num_segments=num_segments,
                                  count_fn=count_fn)
    return min(range(len(counts)), key=lambda d: counts[d]), counts


# ---------------------------------------------------------------------------
# Selective-dimension composition (candidates on dim g, filter the rest)
# ---------------------------------------------------------------------------

def _filter_other_dims(subs: Extents, upds: Extents, pairs: torch.Tensor, *,
                       skip_dim: int):
    """Drop candidate pairs whose non-generator projections do not overlap.

    Kept pairs are compacted to the front in candidate order (a stable
    compaction), the rest of the buffer is (−1, −1); the returned count is
    the post-filter pair count (int64).
    """
    s_lo, s_hi = _dim_rows(subs)
    u_lo, u_hi = _dim_rows(upds)
    keep = pairs[:, 0] >= 0
    i = pairs[:, 0].clamp(min=0).to(torch.int64)
    j = pairs[:, 1].clamp(min=0).to(torch.int64)
    for d in range(s_lo.shape[0]):
        if d != skip_dim:
            keep &= intersect_1d(s_lo[d, i], s_hi[d, i], u_lo[d, j], u_hi[d, j])
    # kept pair p goes to slot (#kept before p); the rest to a spare slot
    size = pairs.shape[0]
    dest = torch.where(keep, torch.cumsum(keep, 0, dtype=torch.int64) - 1,
                       size)
    out = torch.full((size + 1, 2), -1, dtype=pairs.dtype, device=pairs.device)
    out[dest] = pairs
    return out[:size], keep.sum(dtype=torch.int64)


def enumerate_matches_ddim(subs: Extents, upds: Extents, *, max_pairs: int,
                           block: int = 256, method: str = "sweep",
                           num_segments: int = 8,
                           generator_dim: Optional[int] = None,
                           engine: Optional[Callable] = None,
                           count_fn: Optional[Callable] = None):
    """d-dimensional pair enumeration (the JAX package's contract).

    ``method``:

    * ``"sweep"`` (default) — selective-dimension composition: the counting
      sweep probes every projection (``count_fn``) and the dimension with
      the fewest 1-d matches generates candidates with ``engine(a, b,
      max_pairs=...)`` (default :func:`sbm_enumerate`); the other
      projections are filtered pairwise.  ``generator_dim`` pins the
      generator (``0`` is the legacy dim-0 composition).
    * ``"bitmatrix"`` — the packed AND matrix (:func:`bitmatrix_enumerate`);
      ``max_pairs`` bounds only the final d-dim K.
    * ``"blocked"`` — the O(n·m) all-pairs oracle on dim 0 + filter.

    Returns ``(pairs, count)``: a ``(max_pairs, 2)`` int32 buffer padded
    with (−1, −1), valid pairs compacted to the front.  ``count`` is the
    exact post-filter count when the generator pass fit its buffer; if the
    generator overflowed ``max_pairs``, it is the generator's own exact
    candidate count instead — greater than ``max_pairs``, so the
    count-then-retry loop grows the buffer and the retry returns the exact
    K.
    """
    if method not in METHODS:
        raise ValidationError(f"unknown method {method!r}")
    if subs.size == 0 or upds.size == 0:
        return _empty_result(max_pairs, subs.lo.device)
    if method == "bitmatrix":
        return bitmatrix_enumerate(subs, upds, max_pairs=max_pairs)
    if method == "sweep":
        if engine is None:
            def engine(a, b, *, max_pairs):
                return sbm_enumerate(a, b, max_pairs=max_pairs,
                                     num_segments=num_segments)
        candidates = engine
    else:
        def candidates(a, b, *, max_pairs):
            return enumerate_matches(a, b, max_pairs=max_pairs, block=block)
    if subs.ndim_space == 1:   # before the probe — 1-d needs no selection
        return candidates(subs, upds, max_pairs=max_pairs)
    if generator_dim is not None:
        gen = generator_dim
    elif method == "sweep":
        gen, _counts = select_dimension(subs, upds, num_segments=num_segments,
                                        count_fn=count_fn)
    else:
        gen = 0
    pairs, cand = candidates(subs.dim(gen), upds.dim(gen), max_pairs=max_pairs)
    pairs, kept = _filter_other_dims(subs, upds, pairs, skip_dim=gen)
    # Overflow contract: past the buffer `kept` undercounts; the generator's
    # exact count is then the buffer the retry needs.
    return pairs, torch.where(cand > max_pairs, cand.to(torch.int64), kept)


def enumerate_matches_ddim_planned(
        subs: Extents, upds: Extents, *, method: str = "sweep",
        block: int = 256, num_segments: int = 8,
        generator_dim: Optional[int] = None,
        policy: runtime_lib.CapacityPolicy = runtime_lib.DEFAULT_POLICY,
        recorder: Optional[runtime_lib.StatsRecorder] = None):
    """Plan-aware d-dim enumeration: probe → plan → emit, instrumented.

    The per-dimension counting sweeps double as the planner's probe: the
    generator dimension's 1-d count is exactly the candidate buffer the
    selective sweep needs, so the run is retry-free.  The bit-matrix method
    probes the final d-dim K instead.  Returns ``(pairs, count, stats)``
    with the stats ``regime`` ``sweep_dim{gen}``, ``bitmatrix`` or the
    method's name.
    """
    if method not in METHODS:
        raise ValidationError(f"unknown method {method!r}")
    gen = generator_dim
    with spans.span("plan.probe", timed=True) as probe:
        if subs.size == 0 or upds.size == 0:
            estimate, regime = 0, method
        elif method == "bitmatrix":
            estimate, regime = int(bitmatrix_count(subs, upds)), "bitmatrix"
        elif subs.ndim_space == 1 or method == "blocked":
            estimate = (sbm_count_exact(subs, upds,
                                        num_segments=num_segments)
                        if method == "sweep" else None)
            regime = method
        else:
            if gen is None:
                gen, counts = select_dimension(subs, upds,
                                               num_segments=num_segments)
                estimate = counts[gen]
            else:
                estimate = int(sbm_count(subs.dim(gen), upds.dim(gen),
                                         num_segments=num_segments))
            regime = f"sweep_dim{gen}"

    def fn(s, u, *, max_pairs):
        return enumerate_matches_ddim(
            s, u, max_pairs=max_pairs, block=block, method=method,
            num_segments=num_segments, generator_dim=gen)

    return runtime_lib.execute_enumeration(
        fn, subs, upds, estimate=estimate, policy=policy, engine="ddim",
        regime=regime, probe_seconds=probe.seconds, recorder=recorder)


# ---------------------------------------------------------------------------
# Bit-matrix AND (journal version: per-dimension bit-vectors, bitwise AND)
# ---------------------------------------------------------------------------

def bitmatrix_words(subs: Extents, upds: Extents) -> torch.Tensor:
    """The packed d-dim match matrix: (n, ceil(m/32)) int32 words carrying
    the uint32 pattern.

    Bit ``j % 32`` of word ``(i, j // 32)`` is set iff S_i ∩ U_j ≠ ∅ in
    every dimension.  The CUDA kernel computes it for tensors on the card,
    its plain version for tensors on the CPU; any other device raises.
    """
    return bitmatch_kernels.bitmatrix_kernel(subs, upds)[0]


def _popcount_total(words: torch.Tensor) -> torch.Tensor:
    """Σ popcount of a packed word matrix, exact in int64."""
    return prefix_lib.popcount32(words).sum(dtype=torch.int64)


def bitmatrix_count(subs: Extents, upds: Extents) -> torch.Tensor:
    """d-dim K via the packed AND matrix, exact int64 — the sum of the
    kernel's row popcounts."""
    if subs.size == 0 or upds.size == 0:
        return torch.zeros((), dtype=torch.int64, device=subs.lo.device)
    return bitmatch_kernels.bitmatrix_kernel(subs, upds)[2]


def pairs_from_bitmatrix(words: torch.Tensor, *, m: int, max_pairs: int,
                         count: Optional[torch.Tensor] = None):
    """(pairs, count) from packed match words — the shared emission tail.

    Row-major order (subscription id, then update id), as the JAX package.
    Only the nonzero words are expanded to their 32 bits, so the cost is
    O(nonzero words) beyond one pass over the matrix — never the n × m
    unpacked mask.  ``count`` (exact even past ``max_pairs``) defaults to
    the popcount of ``words``; pass a precomputed total to skip that pass.
    """
    if count is None:
        count = _popcount_total(words)
    dev = words.device
    nz = torch.nonzero(words)                      # (row, word), row-major
    vals = words[nz[:, 0], nz[:, 1]].to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    cols = nz[:, 1:] * 32 + shifts                 # (nonzero words, 32)
    hit = (((vals[:, None] >> shifts) & 1) == 1) & (cols < m)
    ii = nz[:, :1].expand(-1, 32)[hit][:max_pairs]
    jj = cols[hit][:max_pairs]
    out = torch.full((max_pairs, 2), -1, dtype=torch.int32, device=dev)
    out[:ii.shape[0], 0] = ii.to(torch.int32)
    out[:jj.shape[0], 1] = jj.to(torch.int32)
    return out, count


def bitmatrix_enumerate(subs: Extents, upds: Extents, *, max_pairs: int):
    """d-dim enumeration via the packed AND matrix.

    ``max_pairs`` bounds only the final d-dim match count K — never any
    single-dimension candidate count: the engine for the regime where every
    projection is dense.
    """
    return bitmatch_kernels.sbm_bitmatrix_kernel(subs, upds,
                                                 max_pairs=max_pairs)


# ---------------------------------------------------------------------------
# Sharded bit-matrix (subscription rows over a device-mesh dimension)
# ---------------------------------------------------------------------------

def bitmatrix_sharded(subs: Extents, upds: Extents, mesh, axis_name: str):
    """(words, count) with subscription rows sharded over one dimension of
    a ``DeviceMesh``; every rank calls it with the same extents and gets
    the same result.

    Each rank packs and ANDs its contiguous shard of the rows (padded to a
    multiple of P with inert ``[+inf, -inf]`` rows, whose words are all
    zero) against the whole update set — on the card one launch of the
    bit-matrix AND kernel, through
    :func:`repro_torch.kernels.bitmatch.bitmatrix_kernel` — the shards'
    words are gathered and sliced back to ``(n, ceil(m/32))`` int32 words
    (uint32 patterns), and K is the all-reduce of the shards' exact int64
    popcounts (the kernel's row counts).
    """
    group, p, index = collectives.mesh_axis(mesh, axis_name)
    n, m = subs.size, upds.size
    dev = subs.lo.device
    if n == 0 or m == 0:
        return (torch.zeros((n, max(-(-m // 32), 1)), dtype=torch.int32,
                            device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    s_lo, s_hi = _dim_rows(subs)
    rows = Extents(collectives.shard_padded(s_lo, p, index, float("inf")),
                   collectives.shard_padded(s_hi, p, index, float("-inf")))
    words, _counts, k_local = bitmatch_kernels.bitmatrix_kernel(rows, upds)
    gathered = collectives.all_gather(words, group)
    return (gathered.reshape(-1, words.shape[1])[:n],
            collectives.all_reduce_sum(k_local, group))
