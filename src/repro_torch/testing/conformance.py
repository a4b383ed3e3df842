"""Engine registry: every pair-producing path of the port behind one
protocol.

A :class:`MatchEngine` names a path, declares what it supports (spatial
dims, endpoint dtypes, stateless vs stateful) and provides a pair-set
runner ``pairs(subs, upds) -> {(i, j)}`` that honours the ``max_pairs``
check-and-retry overflow contract inside.  Engines register into a
module-level registry; the conformance checks enumerate
:func:`all_engines` at run time, so a newly registered engine is
differential-tested by default.

The built-ins carry the JAX package's names (its ``*_pallas`` engines are
the port's ``*_kernel`` engines).  An engine runs on its inputs' device:
on ``cpu`` extents the ``*_kernel`` engines take the kernels' plain
versions, on ``cuda`` extents they launch the kernels.

Stateful paths (the incremental index, the service) are wrapped as
build-from-scratch runners; their *churn* behaviour is covered by the
churn runners (:func:`churn_runner`), which drive identical add/move/remove
scripts through every delta implementation plus the stateless rebuild.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents, _np
from repro_torch.core.runtime import pairs_via_retry
from repro_torch.testing import oracles

Pair = Tuple[int, int]
PairSet = Set[Pair]


@dataclasses.dataclass(frozen=True)
class MatchEngine:
    """One pair-producing path under conformance.

    ``pairs`` is the pair-set runner: exact ``{(i, j)}`` over the inputs,
    any buffer sizing / overflow retry handled inside.  ``dims`` lists the
    supported spatial dimensionalities (``None`` = any d ≥ 1); ``dtypes``
    the endpoint dtypes the path accepts; ``stateful`` marks paths that
    maintain persistent state (the runner then builds fresh state per
    call).
    """

    name: str
    pairs: Callable[[Extents, Extents], PairSet]
    dims: Optional[Tuple[int, ...]] = None
    dtypes: Tuple[str, ...] = ("float32",)
    stateful: bool = False

    def supports(self, d: int) -> bool:
        return self.dims is None or d in self.dims


_REGISTRY: Dict[str, MatchEngine] = {}
_BUILTIN_DONE = False


def register(engine: MatchEngine) -> MatchEngine:
    """Add an engine to the registry (conformance-tested from now on)."""
    if engine.name in _REGISTRY:
        raise ValidationError(f"engine {engine.name!r} already registered")
    _REGISTRY[engine.name] = engine
    return engine


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def all_engines() -> Dict[str, MatchEngine]:
    """name → engine, built-ins auto-discovered on first use."""
    _ensure_builtin()
    return dict(_REGISTRY)


def get_engine(name: str) -> MatchEngine:
    _ensure_builtin()
    return _REGISTRY[name]


def engines_for(d: int, names=None) -> List[MatchEngine]:
    """Engines supporting spatial dimensionality ``d`` (optionally by name)."""
    sel = all_engines()
    if names is not None:
        sel = {n: e for n, e in sel.items() if n in set(names)}
    return [e for _, e in sorted(sel.items()) if e.supports(d)]


# ---------------------------------------------------------------------------
# mismatch reporting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mismatch:
    """One engine disagreeing with the reference oracle on one workload."""

    engine: str
    subs: Extents
    upds: Extents
    got: PairSet
    want: PairSet
    context: str = ""

    def describe(self) -> str:
        extra = sorted(self.got - self.want)[:5]
        missing = sorted(self.want - self.got)[:5]
        return (f"engine {self.engine!r}{self.context}: "
                f"{len(self.got)} pairs vs reference {len(self.want)} "
                f"(spurious {extra}, missing {missing})")


def check_engine(engine: MatchEngine, subs: Extents, upds: Extents,
                 want: Optional[PairSet] = None) -> Optional[Mismatch]:
    """Grade one engine on one workload; None means conformant."""
    if want is None:
        want = oracles.reference_pairs(subs, upds)
    got = engine.pairs(subs, upds)
    if got == want:
        return None
    return Mismatch(engine=engine.name, subs=subs, upds=upds,
                    got=got, want=want)


# ---------------------------------------------------------------------------
# built-in engines (auto-discovered on first registry read)
# ---------------------------------------------------------------------------

def _np_sides(subs: Extents, upds: Extents):
    """(b, d) numpy blocks + d — the bulk-API input layout."""
    s_lo, s_hi, u_lo, u_hi = (_np(a) for a in (subs.lo, subs.hi,
                                              upds.lo, upds.hi))
    d = 1 if s_lo.ndim == 1 else s_lo.shape[0]
    if s_lo.ndim == 2:
        s_lo, s_hi, u_lo, u_hi = s_lo.T, s_hi.T, u_lo.T, u_hi.T
    return s_lo, s_hi, u_lo, u_hi, d


def _sequential_pairs(subs, upds):
    return oracles.sequential_pairs(subs, upds)


def _blocked_pairs(subs, upds):
    from repro_torch.core import enumerate_matches, enumerate_matches_ddim

    if subs.ndim_space == 1:
        return pairs_via_retry(
            lambda s, u, max_pairs: enumerate_matches(
                s, u, max_pairs=max_pairs, block=32), subs, upds)
    return pairs_via_retry(
        lambda s, u, max_pairs: enumerate_matches_ddim(
            s, u, max_pairs=max_pairs, method="blocked", block=32),
        subs, upds)


def _sweep_pairs(subs, upds):
    from repro_torch.core import enumerate_matches_ddim, sbm_enumerate

    if subs.ndim_space == 1:
        return pairs_via_retry(
            lambda s, u, max_pairs: sbm_enumerate(s, u, max_pairs=max_pairs),
            subs, upds)
    return pairs_via_retry(
        lambda s, u, max_pairs: enumerate_matches_ddim(
            s, u, max_pairs=max_pairs, method="sweep"), subs, upds)


def _sweep_gen0_pairs(subs, upds):
    """The dim-0-generator composition — kept honest as an engine."""
    from repro_torch.core import enumerate_matches_ddim

    return pairs_via_retry(
        lambda s, u, max_pairs: enumerate_matches_ddim(
            s, u, max_pairs=max_pairs, method="sweep", generator_dim=0),
        subs, upds)


def _sweep_kernel_pairs(subs, upds):
    """The sweep kernels' enumeration: passes A and B, the delta-bitmask
    kernel and pass C, in segments of 64 endpoints, so that small cases
    span several segments."""
    from repro_torch.kernels.ops import sbm_enumerate_kernel

    if subs.size == 0 or upds.size == 0:
        return set()     # kernel grids need a nonempty endpoint stream
    return pairs_via_retry(
        lambda s, u, max_pairs: sbm_enumerate_kernel(
            s, u, max_pairs=max_pairs, block_size=64), subs, upds)


def _bitmatrix_pairs(subs, upds):
    from repro_torch.core import bitmatrix_enumerate

    return pairs_via_retry(
        lambda s, u, max_pairs: bitmatrix_enumerate(s, u, max_pairs=max_pairs),
        subs, upds)


def _bitmatrix_kernel_pairs(subs, upds):
    from repro_torch.kernels.bitmatch import sbm_bitmatrix_kernel

    if subs.size == 0 or upds.size == 0:
        return set()     # kernel grids need nonempty extent sets
    return pairs_via_retry(
        lambda s, u, max_pairs: sbm_bitmatrix_kernel(
            s, u, max_pairs=max_pairs), subs, upds)


def _incremental_pairs_impl(subs, upds, index_impl, block_target=None):
    from repro_torch.core import IncrementalIndex

    s_lo, s_hi, u_lo, u_hi, d = _np_sides(subs, upds)
    idx = IncrementalIndex(dims=d, capacity=4,   # growth exercised every call
                           index_impl=index_impl, block_target=block_target,
                           device=subs.lo.device)
    adds = {}
    if s_lo.shape[0]:
        adds["sub"] = (np.arange(s_lo.shape[0], dtype=np.int64), s_lo, s_hi)
    if u_lo.shape[0]:
        adds["upd"] = (np.arange(u_lo.shape[0], dtype=np.int64), u_lo, u_hi)
    if adds:
        idx.apply_batch_arrays(adds=adds, want_delta=False)
    return idx.all_pairs()


def _incremental_pairs(subs, upds):
    """Fresh IncrementalIndex on the flat splice path, one bulk add batch,
    all_pairs() — the conformance twin of incremental_blocked."""
    return _incremental_pairs_impl(subs, upds, "flat")


def _incremental_blocked_pairs(subs, upds):
    """The blocked endpoint index with a tiny pinned block size, so every
    case exercises directory routing + split/merge."""
    return _incremental_pairs_impl(subs, upds, "blocked", block_target=8)


def _registered_pairs(svc, subs, upds):
    """Bulk registration into a fresh service, pairs() read back with the
    rids mapped to input indices through the returned id arrays."""
    s_lo, s_hi, u_lo, u_hi, _ = _np_sides(subs, upds)
    sids = svc.register("sub", s_lo, s_hi)
    uids = svc.register("upd", u_lo, u_hi)
    inv_s = {int(r): i for i, r in enumerate(sids)}
    inv_u = {int(r): j for j, r in enumerate(uids)}
    return {(inv_s[a], inv_u[b]) for a, b in svc.pairs()}


def _service_pairs(subs, upds):
    """Fresh DDMService on the inputs' device."""
    from repro_torch.core import DDMService

    return _registered_pairs(
        DDMService(dims=subs.ndim_space, capacity=4, device=subs.lo.device),
        subs, upds)


def _facade_pairs(subs, upds):
    """The public surface end to end: ``repro_torch.api.DDMService`` with
    side-parameterized register + ``pairs()``."""
    from repro_torch import api

    return _registered_pairs(
        api.DDMService(dims=subs.ndim_space, capacity=4,
                       device=subs.lo.device), subs, upds)


def _ensure_builtin() -> None:
    global _BUILTIN_DONE
    if _BUILTIN_DONE:
        return
    _BUILTIN_DONE = True
    register(MatchEngine("sequential_numpy", _sequential_pairs))
    register(MatchEngine("blocked", _blocked_pairs))
    register(MatchEngine("sweep", _sweep_pairs))
    register(MatchEngine("sweep_gen0", _sweep_gen0_pairs, dims=(2, 3, 4)))
    register(MatchEngine("sweep_kernel", _sweep_kernel_pairs, dims=(1,)))
    register(MatchEngine("bitmatrix", _bitmatrix_pairs))
    register(MatchEngine("bitmatrix_kernel", _bitmatrix_kernel_pairs))
    register(MatchEngine("incremental_index", _incremental_pairs,
                         stateful=True))
    register(MatchEngine("incremental_blocked", _incremental_blocked_pairs,
                         stateful=True))
    register(MatchEngine("ddm_service", _service_pairs, stateful=True))
    register(MatchEngine("api_facade", _facade_pairs, stateful=True))


# ---------------------------------------------------------------------------
# churn runners: one script, every delta implementation, plus the rebuild
# ---------------------------------------------------------------------------

CHURN_IMPLS = ("loop", "vector", "arrays", "blocked")


class _IndexChurnRunner:
    """Drives tuple-format churn batches through one IncrementalIndex
    surface.  ``impl='arrays'``/``'blocked'`` convert each batch to the
    side-grouped array API (the vectorized bulk path); 'loop'/'vector'
    use the tuple API with the corresponding ``delta_impl``.  'loop' and
    'vector' run the flat splice, 'arrays' the default blocked index,
    'blocked' a tiny pinned block size (forced split/merge churn)."""

    def __init__(self, impl: str, dims: int, device):
        from repro_torch.core import IncrementalIndex

        self.impl = impl
        delta_impl = "loop" if impl == "loop" else "vector"
        index_impl = "flat" if impl in ("loop", "vector") else "blocked"
        block_target = 8 if impl == "blocked" else None
        self.idx = IncrementalIndex(dims=dims, capacity=4,
                                    delta_impl=delta_impl,
                                    index_impl=index_impl,
                                    block_target=block_target,
                                    device=device)

    def apply(self, adds, moves, removes):
        if self.impl not in ("arrays", "blocked"):
            return self.idx.apply_batch(adds=adds, moves=moves,
                                        removes=removes)
        grp_a, grp_m, grp_r = {}, {}, {}
        for side in ("sub", "upd"):
            for ops, grp in ((adds, grp_a), (moves, grp_m)):
                sel = [(r, lo, hi) for s, r, lo, hi in ops if s == side]
                if sel:
                    grp[side] = (
                        np.asarray([r for r, _, _ in sel], np.int64),
                        np.stack([np.atleast_1d(lo) for _, lo, _ in sel]),
                        np.stack([np.atleast_1d(hi) for _, _, hi in sel]))
            sel = [r for s, r in removes if s == side]
            if sel:
                grp_r[side] = np.asarray(sel, np.int64)
        return self.idx.apply_batch_arrays(adds=grp_a, moves=grp_m,
                                           removes=grp_r)

    def all_pairs(self):
        return self.idx.all_pairs()


def churn_runner(impl: str, dims: int, *, device="cuda") -> _IndexChurnRunner:
    if impl not in CHURN_IMPLS:
        raise ValidationError(f"unknown churn impl {impl!r} (one of {CHURN_IMPLS})")
    return _IndexChurnRunner(impl, dims, device)


def check_churn_script(script, dims: int, impls=CHURN_IMPLS, *,
                       device="cuda") -> List[str]:
    """Drive one churn script through every delta implementation on
    ``device``.

    ``script`` is a list of ``(adds, moves, removes)`` batches in the
    tuple format of :meth:`IncrementalIndex.apply_batch`.  After every
    batch: all implementations' ``BatchDelta``s must be identical, the
    delta-composed pair set must equal each implementation's
    ``all_pairs()``, and a from-scratch rebuild over the mirrored live
    state (d = 1: the stateless sweep on ``device``; d > 1: the host brute
    force).  Returns human-readable divergence descriptions (empty =
    conformant).
    """
    runners = {impl: churn_runner(impl, dims, device=device)
               for impl in impls}
    live = {"sub": {}, "upd": {}}
    pairs: PairSet = set()
    problems: List[str] = []
    for step, (adds, moves, removes) in enumerate(script):
        deltas = {impl: r.apply(adds, moves, removes)
                  for impl, r in runners.items()}
        for side, rid, lo, hi in adds + moves:
            live[side][rid] = (np.atleast_1d(lo), np.atleast_1d(hi))
        for side, rid in removes:
            del live[side][rid]
        base_impl = impls[0]
        base = deltas[base_impl]
        for impl, d in deltas.items():
            if d != base:
                problems.append(
                    f"batch {step}: BatchDelta of {impl!r} != {base_impl!r}: "
                    f"{d} vs {base}")
        if base.added & base.removed:
            problems.append(f"batch {step}: added ∩ removed non-empty")
        pairs = (pairs - base.removed) | base.added
        want = (oracles.sweep_rebuild_pairs(live["sub"], live["upd"],
                                            device=device)
                if dims == 1
                else oracles.live_pairs(live["sub"], live["upd"], dims))
        if pairs != want:
            problems.append(
                f"batch {step}: delta-composed set drifted from rebuild "
                f"(spurious {sorted(pairs - want)[:4]}, "
                f"missing {sorted(want - pairs)[:4]})")
        for impl, r in runners.items():
            got = r.all_pairs()
            if got != want:
                problems.append(
                    f"batch {step}: {impl!r}.all_pairs() != rebuild")
        if problems:
            break      # later steps run on diverged state — stop at first
    return problems
