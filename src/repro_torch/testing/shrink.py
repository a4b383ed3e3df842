"""Deterministic minimal-reproducer shrinking of the port.

The counterpart of the JAX package's ``repro/testing/shrink.py``.  On any
conformance mismatch the fuzzer hands the failing workload (or churn
script) to this module, which bisects it down to a minimal failing case
and emits two artifacts: a ready-to-paste pytest regression and a JSON
repro.  Everything is deterministic — greedy chunk removal in a fixed
order, no randomness — so the same failure always shrinks to the same
reproducer, and to the same one as the JAX package's on the same inputs.

Shrinking strategy (classic ddmin, adapted):

1. **region removal** — alternately on the subscription and update sides,
   try deleting contiguous chunks (half, then quarter, … down to single
   regions), keeping any deletion under which the failure predicate still
   holds; loop to a fixed point.
2. **value snapping** — per surviving region and dimension, try replacing
   the float bounds with rounded integers (kept only when the failure
   survives).
3. **churn scripts** — drop whole batches, then individual ops inside
   batches.  A shrunk script that references a never-added rid makes the
   engine raise, which the predicate wrapper reports as "not the failure
   being chased", so ddmin never accepts it.

Candidates are built on the device of the input extents; the predicate
runs the engine there.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents, _np

Predicate = Callable[[Extents, Extents], bool]


def _np2(e: Extents) -> Tuple[np.ndarray, np.ndarray]:
    """Extents → (d, n) float32 numpy (1-d promoted to one row)."""
    lo = np.atleast_2d(np.asarray(_np(e.lo), np.float32))
    hi = np.atleast_2d(np.asarray(_np(e.hi), np.float32))
    return lo, hi


def _mk(lo: np.ndarray, hi: np.ndarray, dims: int, device) -> Extents:
    lo = torch.from_numpy(np.ascontiguousarray(lo, np.float32)).to(device)
    hi = torch.from_numpy(np.ascontiguousarray(hi, np.float32)).to(device)
    if dims == 1:
        return Extents(lo[0], hi[0])
    return Extents(lo, hi)


def _safe(pred: Callable, *args) -> bool:
    """A shrunk candidate that makes the engine *raise* is invalid input,
    not the mismatch being chased — treat as not-failing (the port's
    ``ValidationError`` is a ``ValueError``)."""
    try:
        return bool(pred(*args))
    except (ValueError, KeyError, AssertionError):
        return False


def shrink_workload(subs: Extents, upds: Extents, failing: Predicate,
                    *, max_steps: int = 10_000
                    ) -> Tuple[Extents, Extents]:
    """Greedy-deterministic minimization of a failing (subs, upds) pair.

    ``failing(subs, upds) -> bool`` must be True on the input (raises
    otherwise) and is re-evaluated on every candidate; the returned pair
    is a local minimum: no single region can be removed, and no bound
    snapped to an integer, without losing the failure.
    """
    if not _safe(failing, subs, upds):
        raise ValidationError("shrink_workload needs a failing input to start from")
    dims = subs.ndim_space
    device = subs.lo.device
    sides = [list(_np2(subs)), list(_np2(upds))]
    steps = 0

    def build(k: int, lo: np.ndarray, hi: np.ndarray) -> Tuple[Extents, Extents]:
        parts = [
            _mk(*(sides[i][:2] if i != k else (lo, hi)), dims, device)
            for i in (0, 1)
        ]
        return parts[0], parts[1]

    changed = True
    while changed and steps < max_steps:
        changed = False
        for k in (0, 1):                       # subs side first, then upds
            lo, hi = sides[k]
            n = lo.shape[1]
            chunk = max(n // 2, 1)
            while chunk >= 1:
                start = 0
                while start < lo.shape[1] and steps < max_steps:
                    steps += 1
                    keep = np.r_[0:start,
                                 min(start + chunk, lo.shape[1]):lo.shape[1]]
                    if keep.size == lo.shape[1]:
                        break
                    cand_lo, cand_hi = lo[:, keep], hi[:, keep]
                    if _safe(failing, *build(k, cand_lo, cand_hi)):
                        lo, hi = cand_lo, cand_hi
                        sides[k] = [lo, hi]
                        changed = True         # chunk removed: same start
                    else:
                        start += chunk
                if chunk == 1:
                    break
                chunk = max(chunk // 2, 1)

    # value snapping: round each surviving bound to a nearby integer
    for k in (0, 1):
        lo, hi = sides[k]
        for j in range(lo.shape[1]):
            for d in range(lo.shape[0]):
                for arr in (lo, hi):
                    v = arr[d, j]
                    r = np.float32(np.rint(v))
                    if r != v and np.isfinite(v):
                        old = arr[d, j]
                        arr[d, j] = r
                        if not _safe(failing, *build(k, *sides[k][:2])):
                            arr[d, j] = old
    return _mk(*sides[0], dims, device), _mk(*sides[1], dims, device)


# ---------------------------------------------------------------------------
# churn scripts
# ---------------------------------------------------------------------------

def shrink_script(script: List[tuple], failing_script: Callable[[list], bool]
                  ) -> List[tuple]:
    """ddmin over churn scripts: drop batches, then ops inside batches.

    ``script`` is a list of ``(adds, moves, removes)`` tuple-format
    batches; ``failing_script(script) -> bool``.  Illegal shrinks (a move
    of a rid whose add was dropped) raise inside the engine and count as
    not-failing, so the result is always a legal minimal script.
    """
    if not _safe(failing_script, script):
        raise ValidationError("shrink_script needs a failing script to start from")
    # pass 1: drop whole batches
    i = 0
    while i < len(script):
        cand = script[:i] + script[i + 1:]
        if cand and _safe(failing_script, cand):
            script = cand
        else:
            i += 1
    # pass 2: drop individual ops within each batch
    changed = True
    while changed:
        changed = False
        for bi in range(len(script)):
            for group_idx in (0, 1, 2):
                group = list(script[bi][group_idx])
                oi = 0
                while oi < len(group):
                    cand_group = group[:oi] + group[oi + 1:]
                    cand_batch = list(script[bi])
                    cand_batch[group_idx] = cand_group
                    cand = (script[:bi] + [tuple(cand_batch)]
                            + script[bi + 1:])
                    if _safe(failing_script, cand):
                        group = cand_group
                        script = cand
                        changed = True
                    else:
                        oi += 1
    # drop now-empty batches
    return [b for b in script if any(len(g) for g in b)]


def script_region_count(script: List[tuple]) -> int:
    """Distinct (side, rid) regions a script touches — the shrink metric."""
    seen = set()
    for adds, moves, removes in script:
        for side, rid, *_ in list(adds) + list(moves):
            seen.add((side, rid))
        for side, rid in removes:
            seen.add((side, rid))
    return len(seen)


# ---------------------------------------------------------------------------
# repro artifacts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReproArtifact:
    """A shrunk failing case, serializable and pasteable.

    ``kind`` is ``"pairs"`` (stateless mismatch), ``"metamorphic:<rel>"``
    or ``"churn"``; region bounds are row-major per dimension
    (``subs_lo[d][i]``); ``script`` is the tuple-format churn script in a
    JSON-friendly encoding for churn repros.  The JSON fields are the JAX
    package's.
    """

    engine: str
    kind: str
    dims: int
    seed: int
    detail: str
    subs_lo: list = dataclasses.field(default_factory=list)
    subs_hi: list = dataclasses.field(default_factory=list)
    upds_lo: list = dataclasses.field(default_factory=list)
    upds_hi: list = dataclasses.field(default_factory=list)
    script: Optional[list] = None
    want: Optional[list] = None
    got: Optional[list] = None

    @classmethod
    def from_workload(cls, engine: str, kind: str, seed: int, detail: str,
                      subs: Extents, upds: Extents,
                      want=None, got=None) -> "ReproArtifact":
        s_lo, s_hi = _np2(subs)
        u_lo, u_hi = _np2(upds)
        return cls(engine=engine, kind=kind, dims=subs.ndim_space, seed=seed,
                   detail=detail,
                   subs_lo=s_lo.tolist(), subs_hi=s_hi.tolist(),
                   upds_lo=u_lo.tolist(), upds_hi=u_hi.tolist(),
                   want=sorted(want) if want is not None else None,
                   got=sorted(got) if got is not None else None)

    @classmethod
    def from_script(cls, engine: str, seed: int, detail: str, dims: int,
                    script: List[tuple]) -> "ReproArtifact":
        enc = [[[[s, int(r), np.atleast_1d(lo).tolist(),
                  np.atleast_1d(hi).tolist()] for s, r, lo, hi in adds],
                [[s, int(r), np.atleast_1d(lo).tolist(),
                  np.atleast_1d(hi).tolist()] for s, r, lo, hi in moves],
                [[s, int(r)] for s, r in removes]]
               for adds, moves, removes in script]
        return cls(engine=engine, kind="churn", dims=dims, seed=seed,
                   detail=detail, script=enc)

    def region_count(self) -> int:
        if self.script is not None:
            seen = {(s, r) for batch in self.script
                    for group in batch[:2] for s, r, _, _ in group}
            seen |= {(s, r) for batch in self.script for s, r in batch[2]}
            return len(seen)
        return len(self.subs_lo[0]) + len(self.upds_lo[0]) if self.subs_lo \
            else len(self.upds_lo[0])

    def workload(self, device="cuda") -> Tuple[Extents, Extents]:
        dims = self.dims
        return (_mk(np.asarray(self.subs_lo, np.float32).reshape(dims, -1),
                    np.asarray(self.subs_hi, np.float32).reshape(dims, -1),
                    dims, device),
                _mk(np.asarray(self.upds_lo, np.float32).reshape(dims, -1),
                    np.asarray(self.upds_hi, np.float32).reshape(dims, -1),
                    dims, device))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, out_dir: str) -> str:
        os.makedirs(out_dir, exist_ok=True)
        slug = self.kind.replace(":", "_")
        path = os.path.join(
            out_dir, f"repro_{slug}_{self.engine}_seed{self.seed}.json")
        with open(path, "w") as fh:
            fh.write(self.to_json())
        return path

    def to_pytest(self, device: str = "cuda") -> str:
        """A ready-to-paste regression test for the shrunk case, on
        ``device``."""
        import re

        slug = re.sub(r"\W+", "_", f"{self.kind}_{self.engine}")
        name = f"test_repro_{slug}_seed{self.seed}"
        if self.script is not None:
            return (
                f"def {name}():\n"
                f'    """Shrunk fuzz repro (seed {self.seed}): {self.detail}"""\n'
                f"    from repro_torch.testing.conformance import "
                f"check_churn_script\n"
                f"    script = [\n" +
                "".join(f"        ({a!r}, {m!r}, {r!r}),\n"
                        for a, m, r in self.script) +
                f"    ]\n"
                f"    script = [(\n"
                f"        [(s, r, lo, hi) for s, r, lo, hi in adds],\n"
                f"        [(s, r, lo, hi) for s, r, lo, hi in moves],\n"
                f"        [(s, r) for s, r in removes],\n"
                f"    ) for adds, moves, removes in script]\n"
                f"    assert check_churn_script(script, dims={self.dims}, "
                f"device={device!r}) == []\n")
        row = "[0]" if self.dims == 1 else ""
        return (
            f"def {name}():\n"
            f'    """Shrunk fuzz repro (seed {self.seed}): {self.detail}"""\n'
            f"    import torch\n"
            f"    from repro_torch.core.intervals import Extents\n"
            f"    from repro_torch.testing import conformance, oracles\n"
            f"    dev = torch.device({device!r})\n"
            f"    subs = Extents(torch.tensor({self.subs_lo!r}, "
            f"dtype=torch.float32, device=dev){row},\n"
            f"                   torch.tensor({self.subs_hi!r}, "
            f"dtype=torch.float32, device=dev){row})\n"
            f"    upds = Extents(torch.tensor({self.upds_lo!r}, "
            f"dtype=torch.float32, device=dev){row},\n"
            f"                   torch.tensor({self.upds_hi!r}, "
            f"dtype=torch.float32, device=dev){row})\n"
            f"    engine = conformance.get_engine({self.engine!r})\n"
            f"    assert engine.pairs(subs, upds) == "
            f"oracles.reference_pairs(subs, upds)\n")
