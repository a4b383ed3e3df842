"""Metamorphic relations for the port's matching engines.

The counterpart of the JAX package's ``repro/testing/metamorphic.py``.  A
metamorphic relation needs no oracle: it transforms a workload in a way
that provably preserves (or predictably maps) the pair set and checks the
engine against itself.  The relations here:

* **translation** — ``pairs(S + c, U + c) == pairs(S, U)`` for an offset
  ``c`` that is exact in float32 (a power of two well above the
  coordinate magnitudes), so ties survive the shift bit-for-bit.
* **scale** — ``pairs(2^k · S, 2^k · U) == pairs(S, U)``; powers of two
  only rescale the exponent, so ordering AND ties are preserved exactly.
* **dimension permutation** — matching is symmetric across axes: any
  permutation of the d rows leaves the pair set unchanged.
* **swap sides** — closed-interval overlap is symmetric, so
  ``pairs(U, S)`` must be the transpose of ``pairs(S, U)``.
* **subset monotonicity** — restricting the subscription set restricts
  the pair set exactly: ``pairs(S[keep], U)`` equals the re-indexed
  ``{(i, j) : i ∈ keep}``.
* **batch-split equivalence** (stateful) — applying one churn batch as a
  single flush or as any split into sub-batches must leave identical
  index state AND the composed sub-deltas must equal the single delta.

The transforms run on the extents' device, so an engine is held to the
relations on the device it runs on.  Translation and scale are sound only
where the transform is lossless in float32; the fuzzer applies them to
its integer-grid corpora only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.incremental import BatchDelta
from repro_torch.core.intervals import Extents

PairRunner = Callable[[Extents, Extents], set]


@dataclasses.dataclass
class Violation:
    """One broken relation: the transformed run disagreed with the base."""

    relation: str
    detail: str

    def __str__(self) -> str:
        return f"metamorphic relation {self.relation!r} violated: {self.detail}"


# ---------------------------------------------------------------------------
# workload transforms
# ---------------------------------------------------------------------------

def translate(e: Extents, offset: float) -> Extents:
    c = torch.tensor(offset, dtype=torch.float32, device=e.lo.device)
    return Extents(e.lo + c, e.hi + c)


def scale(e: Extents, factor: float) -> Extents:
    c = torch.tensor(factor, dtype=torch.float32, device=e.lo.device)
    return Extents(e.lo * c, e.hi * c)


def permute_dims(e: Extents, perm: Sequence[int]) -> Extents:
    if e.ndim_space == 1:
        raise ValidationError("dimension permutation needs d > 1")
    p = torch.as_tensor(list(perm), dtype=torch.int64, device=e.lo.device)
    return Extents(e.lo[p, :], e.hi[p, :])


def take(e: Extents, idx: Sequence[int]) -> Extents:
    i = torch.as_tensor(list(idx), dtype=torch.int64, device=e.lo.device)
    return Extents(e.lo[..., i], e.hi[..., i])


# ---------------------------------------------------------------------------
# relations over a stateless pair runner
# ---------------------------------------------------------------------------

def _diff(a: set, b: set) -> str:
    return (f"{len(a)} vs {len(b)} pairs "
            f"(only-base {sorted(a - b)[:4]}, only-transformed {sorted(b - a)[:4]})")


def check_translation(run: PairRunner, subs: Extents, upds: Extents,
                      offset: float = 4096.0) -> Optional[Violation]:
    base = run(subs, upds)
    got = run(translate(subs, offset), translate(upds, offset))
    if got != base:
        return Violation("translation", _diff(base, got))
    return None


def check_scale(run: PairRunner, subs: Extents, upds: Extents,
                factor: float = 0.5) -> Optional[Violation]:
    base = run(subs, upds)
    got = run(scale(subs, factor), scale(upds, factor))
    if got != base:
        return Violation("scale", _diff(base, got))
    return None


def check_dim_permutation(run: PairRunner, subs: Extents, upds: Extents,
                          perm: Optional[Sequence[int]] = None
                          ) -> Optional[Violation]:
    d = subs.ndim_space
    if d == 1:
        return None
    if perm is None:
        perm = list(range(1, d)) + [0]       # rotate — hits every axis
    base = run(subs, upds)
    got = run(permute_dims(subs, perm), permute_dims(upds, perm))
    if got != base:
        return Violation("dim_permutation", _diff(base, got))
    return None


def check_swap_sides(run: PairRunner, subs: Extents, upds: Extents
                     ) -> Optional[Violation]:
    base = run(subs, upds)
    got = {(i, j) for j, i in run(upds, subs)}
    if got != base:
        return Violation("swap_sides", _diff(base, got))
    return None


def check_subset_monotonicity(run: PairRunner, subs: Extents, upds: Extents,
                              keep: Optional[Sequence[int]] = None
                              ) -> Optional[Violation]:
    n = subs.size
    if n < 2:
        return None
    if keep is None:
        keep = list(range(0, n, 2))          # deterministic half
    keep = list(keep)
    base = run(subs, upds)
    pos = {orig: new for new, orig in enumerate(keep)}
    want = {(pos[i], j) for i, j in base if i in pos}
    got = run(take(subs, keep), upds)
    if got != want:
        return Violation("subset_monotonicity", _diff(want, got))
    return None


STATELESS_RELATIONS: Dict[str, Callable] = {
    "translation": check_translation,
    "scale": check_scale,
    "dim_permutation": check_dim_permutation,
    "swap_sides": check_swap_sides,
    "subset_monotonicity": check_subset_monotonicity,
}

# relations whose soundness needs losslessly transformable coordinates
# (the fuzzer applies these only to integer-grid corpora)
TIE_SENSITIVE = ("translation", "scale")


def check_relations(run: PairRunner, subs: Extents, upds: Extents,
                    names: Optional[Sequence[str]] = None) -> List[Violation]:
    out = []
    for name in (names or STATELESS_RELATIONS):
        v = STATELESS_RELATIONS[name](run, subs, upds)
        if v is not None:
            out.append(v)
    return out


# ---------------------------------------------------------------------------
# batch-split equivalence (stateful)
# ---------------------------------------------------------------------------

def compose_deltas(p0: set, deltas: Sequence[BatchDelta]) -> BatchDelta:
    """Net delta of applying ``deltas`` in order to the pair set ``p0``."""
    p = set(p0)
    for d in deltas:
        p -= d.removed
        p |= d.added
    return BatchDelta(p - set(p0), set(p0) - p)


def check_batch_split(dims: int, seed_batch, batch, *, splits: int = 3,
                      impl: str = "vector",
                      device="cuda") -> Optional[Violation]:
    """One flush vs many on ``device``: the batch applied whole and
    applied as ``splits`` sub-batches (rids are disjoint within a batch,
    so any split is legal) must leave identical index state, and the
    composed sub-deltas must equal the single-flush delta."""
    from repro_torch.testing.conformance import churn_runner

    whole = churn_runner(impl, dims, device=device)
    split = churn_runner(impl, dims, device=device)
    whole.apply(*seed_batch)
    split.apply(*seed_batch)
    p0 = whole.all_pairs()

    adds, moves, removes = batch
    d_single = whole.apply(adds, moves, removes)

    ops = ([("add", e) for e in adds] + [("move", e) for e in moves]
           + [("remove", e) for e in removes])
    chunk = max(1, -(-len(ops) // splits))
    sub_deltas = []
    for k in range(0, len(ops), chunk):
        part = ops[k:k + chunk]
        sub_deltas.append(split.apply(
            [e for kind, e in part if kind == "add"],
            [e for kind, e in part if kind == "move"],
            [e for kind, e in part if kind == "remove"]))

    if whole.all_pairs() != split.all_pairs():
        return Violation("batch_split",
                         _diff(whole.all_pairs(), split.all_pairs()))
    composed = compose_deltas(p0, sub_deltas)
    if composed != d_single:
        return Violation(
            "batch_split",
            f"composed sub-deltas {composed} != single-flush {d_single}")
    return None
