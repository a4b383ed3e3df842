"""Prefix computations (paper §4, Fig. 5) and the Algorithm-6 delta-set monoid.

* :func:`cumsum_two_level` — the paper's two-level scan: P local scans, a
  master scan over the P partials, then a broadcast-add.
* :func:`delta_combine_bits` / :func:`delta_scan_exclusive` — Algorithm 6's
  set monoid on boolean masks or packed bitmask words.
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


# --------------------------------------------------------------------------
# Delta-set monoid (Algorithm 6, set semantics)
# --------------------------------------------------------------------------
# An element (A, D) denotes the state transformer  S ↦ (S \ D) ∪ A  with
# A ∩ D = ∅.  Composition (apply e1 then e2):
#     A' = (A1 \ D2) ∪ A2      D' = (D1 ∪ D2) \ A2
# Identity: (∅, ∅).  Works elementwise on boolean masks or bitmask words.

def delta_combine_bits(e1: Tuple[torch.Tensor, torch.Tensor],
                       e2: Tuple[torch.Tensor, torch.Tensor]):
    """Compose two delta sets (boolean masks or int32 bitmask words)."""
    a1, d1 = e1
    a2, d2 = e2
    return (a1 & ~d2) | a2, (d1 | d2) & ~a2


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
