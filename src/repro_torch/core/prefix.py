"""Prefix computations (paper §4, Fig. 5) and the Algorithm-6 delta-set monoid.

* :func:`cumsum_two_level` — the paper's two-level scan: P local scans, a
  master scan over the P partials, then a broadcast-add.
* :func:`cumsum_blelloch` — the work-efficient tree scan (Blelloch 1989):
  an up-sweep and a down-sweep of log₂ N levels each.
* :func:`cumsum_saturating_i32` — an int32 cumsum that pins at 2³¹−1
  instead of wrapping.
* :func:`shard_exclusive_offsets` / :func:`shard_inclusive_cumsum` — the
  two-level scheme across the ranks of a process group: each rank scans
  its shard, the P shard totals are all-gathered (the master step, O(P)
  scalars, replicated on every rank) and each rank adds the earlier
  ranks' totals: the paper's algorithm with "thread" := rank.
* :func:`delta_combine_bool` / :func:`delta_combine_bits` /
  :func:`delta_scan_exclusive` — Algorithm 6's set monoid on boolean masks
  or packed bitmask words.
* :func:`pack_bits` / :func:`unpack_bits` — the packed word layout shared
  with the JAX package: bit ``k`` of word ``w`` is element ``32·w + k``;
  :func:`popcount32` counts a word's set bits.

Packed words are held as ``int32`` tensors carrying the uint32 bit pattern:
torch's ``uint32`` lacks ``~``, ``<<`` and ``>>`` on the CPU, while the
bitwise operators the monoid needs are exact on ``int32``.  Compare words
with the JAX package's as ``np.uint32`` views.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core import collectives
from repro_torch.core.errors import ValidationError

_WORD_BITS = 32
# weight of bit k in a word, as int64 so a word's value sum stays exact
_BIT_WEIGHTS = torch.ones(_WORD_BITS, dtype=torch.int64) \
    << torch.arange(_WORD_BITS, dtype=torch.int64)


# --------------------------------------------------------------------------
# Dense scans
# --------------------------------------------------------------------------

def exclusive_from_inclusive(inc: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shift an inclusive scan to the exclusive scan of the same sequence."""
    zero = torch.zeros_like(inc.narrow(dim, 0, 1))
    return torch.cat([zero, inc.narrow(dim, 0, inc.shape[dim] - 1)], dim=dim)


def cumsum_two_level(x: torch.Tensor, num_segments: int,
                     dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Inclusive prefix sum via the paper's two-level scheme (Fig. 5).

    Step 1: split into ``P = num_segments`` equal segments, local cumsum.
    Step 2: "master" prefix over the P segment totals.
    Step 3: broadcast-add the exclusive totals back.

    ``x.shape[-1]`` must be divisible by ``num_segments`` (callers pad).
    ``dtype`` is the accumulation type (int32 holds any stream position).
    """
    n = x.shape[-1]
    if n % num_segments:
        raise ValidationError(f"n={n} not divisible by num_segments={num_segments}")
    seg = n // num_segments
    xs = x.reshape(x.shape[:-1] + (num_segments, seg))
    local = torch.cumsum(xs, dim=-1, dtype=dtype)                  # step 1
    totals = local[..., -1]
    carry = exclusive_from_inclusive(torch.cumsum(totals, dim=-1, dtype=dtype))
    return (local + carry[..., None]).reshape(x.shape)              # step 3


def cumsum_blelloch(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis as a tree scan (Blelloch
    1989): the row is zero-padded to a power of two, an up-sweep leaves
    each subtree's sum at its right end, a down-sweep turns those sums into
    the exclusive scan, and adding ``x`` makes it inclusive.  2·log₂ N
    levels, each one elementwise pass over a strided view; the additions
    stay in ``x``'s dtype (int32 wraps as the JAX package's tree scan
    does).  Not ``torch.cumsum``: this is the scan the variant exists to
    compare."""
    n = x.shape[-1]
    size = 1
    while size < n:
        size *= 2
    lead = x.shape[:-1]
    t = x.new_zeros(lead + (size,))
    t[..., :n] = x
    t = t.reshape(-1, size)
    stride = 1
    while stride < size:                                 # up-sweep
        v = t.view(-1, size // (2 * stride), 2 * stride)
        v[..., 2 * stride - 1] += v[..., stride - 1]
        stride *= 2
    t[:, size - 1] = 0
    while stride > 1:                                    # down-sweep
        stride //= 2
        v = t.view(-1, size // (2 * stride), 2 * stride)
        left = v[..., stride - 1].clone()
        v[..., stride - 1] = v[..., 2 * stride - 1]
        v[..., 2 * stride - 1] += left
    return t[:, :n].reshape(lead + (n,)) + x


_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -2 ** 31


def cumsum_saturating_i32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive int32 cumsum of *nonnegative* values that saturates at
    2³¹−1: each prefix is ``min(Σ, 2³¹−1)`` exactly, also where the total
    passes 2³¹ (the JAX package's contract for offset tables: monotonic,
    pinned at the sentinel, never wrapped).  The prefix is taken in exact
    int64 and clamped.

    Negative inputs lie outside that contract (there the JAX package's
    result depends on its scan tree); the port returns each exact prefix
    clamped into the int32 range.
    """
    exact = torch.cumsum(x.to(torch.int64), dim=dim, dtype=torch.int64)
    return exact.clamp(_INT32_MIN, _INT32_MAX).to(torch.int32)


# --------------------------------------------------------------------------
# Distributed scan (the two-level scheme across the ranks of a group)
# --------------------------------------------------------------------------

def shard_exclusive_offsets(local_total: torch.Tensor, group) -> torch.Tensor:
    """Exclusive prefix of per-shard totals across the ranks of ``group``.

    Every rank of the group calls it with its shard's reduction (any shape,
    the same on every rank) and gets the sum of the *earlier* ranks'
    totals, in ``local_total``'s dtype.  The paper's master step: gather
    the P partials and combine them locally.
    """
    gathered = collectives.all_gather(local_total, group)        # (P, ...)
    earlier = gathered[:dist.get_rank(group)]
    return earlier.sum(dim=0, dtype=local_total.dtype)


def shard_inclusive_cumsum(x_shard: torch.Tensor, group) -> torch.Tensor:
    """Full distributed inclusive cumsum along the last axis of an array
    whose contiguous shards, in rank order, lie on the ranks of ``group``
    (every shard non-empty), in ``x_shard``'s dtype."""
    local = torch.cumsum(x_shard, dim=-1, dtype=x_shard.dtype)
    return local + shard_exclusive_offsets(local[..., -1], group)[..., None]


# --------------------------------------------------------------------------
# Delta-set monoid (Algorithm 6, set semantics)
# --------------------------------------------------------------------------
# An element (A, D) denotes the state transformer  S ↦ (S \ D) ∪ A  with
# A ∩ D = ∅.  Composition (apply e1 then e2):
#     A' = (A1 \ D2) ∪ A2      D' = (D1 ∪ D2) \ A2
# Identity: (∅, ∅).  Works elementwise on boolean masks or bitmask words.

def delta_combine_bool(e1: Tuple[torch.Tensor, torch.Tensor],
                       e2: Tuple[torch.Tensor, torch.Tensor]):
    """Compose two delta sets (boolean masks or int32 bitmask words)."""
    a1, d1 = e1
    a2, d2 = e2
    return (a1 & ~d2) | a2, (d1 | d2) & ~a2


# the packed-word name of the same monoid (the combine is elementwise
# bitwise, so one body serves masks and words)
delta_combine_bits = delta_combine_bool


def delta_scan_exclusive(add: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """Exclusive scan of per-segment delta sets.

    ``add``/``rem``: (P, n) boolean masks or (P, W) int32 bitmask words —
    Algorithm 6's Sadd[p]/Sdel[p].  Returns the active set *entering* each
    segment p: the A component of the combine of segments [0, p-1] applied
    to ∅ (A' depends only on A1, A2 and D2, so D is never carried).  The
    scan runs over P in order; each step is one elementwise pass over a row.
    """
    active = torch.empty_like(add)
    acc = torch.zeros_like(add[0])
    for p in range(add.shape[0]):
        active[p] = acc
        acc = (acc & ~rem[p]) | add[p]
    return active


def words_from_values(x: torch.Tensor) -> torch.Tensor:
    """int64 word values in [0, 2³²) → int32 tensors with the same bits."""
    return torch.where(x >= 0x80000000, x - 0x100000000, x).to(torch.int32)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack a (..., n) boolean mask into (..., ceil(n/32)) int32 words."""
    n = mask.shape[-1]
    pad = (-n) % _WORD_BITS
    if pad:
        mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1] + (pad,))], dim=-1)
    m = mask.reshape(mask.shape[:-1] + ((n + pad) // _WORD_BITS, _WORD_BITS))
    weights = _BIT_WEIGHTS.to(mask.device)
    return words_from_values((m.to(torch.int64) * weights).sum(dim=-1,
                                                               dtype=torch.int64))


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`."""
    shifts = torch.arange(_WORD_BITS, dtype=torch.int64, device=words.device)
    bits = ((words.to(torch.int64)[..., :, None] & 0xFFFFFFFF) >> shifts) & 1
    flat = bits.reshape(words.shape[:-1] + (words.shape[-1] * _WORD_BITS,))
    return flat[..., :n].to(torch.bool)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32-held word, as int64 (torch has no popcount):
    the SWAR bit-sum over the word's unsigned value."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24
