"""Differential workload fuzzer over the port's engine registry.

The counterpart of the JAX package's ``repro/testing/fuzz.py``.  It
generates adversarial extent sets — exact endpoint ties, zero-width
extents, extreme float32 magnitudes, duplicated extents, tall-thin and
clustered d-dim sets, single-region and empty worlds — and random churn
scripts of add/move/remove batches, then grades every registered engine
against the cross-checked host reference
(:mod:`repro_torch.testing.oracles`), runs the tie-safe metamorphic
relations, and drives the churn scripts through every delta
implementation plus the stateless rebuild.  Any mismatch is shrunk to a
minimal reproducer (:mod:`repro_torch.testing.shrink`) and written as a
JSON artifact plus a ready-to-paste pytest regression.

The generators draw from ``np.random.RandomState(seed)`` in the JAX
package's order, so one seed gives the same arrays bit for bit (the
``tall_thin`` and ``clustered`` corpora through
:mod:`repro_torch.testing.threefry`); the extents then move to
``device``, where every engine, relation and churn runner of the seed
runs.  On ``cuda`` extents the ``*_kernel`` engines and the service
launch the sweep and bit-matrix kernels.

Run it:

    PYTHONPATH=src python -m repro_torch.testing.fuzz --seeds 100 --engines all
    PYTHONPATH=src python -m repro_torch.testing.fuzz --seeds 25 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.testing.fuzz --self-check

``--device`` defaults to ``cuda``.  ``--self-check`` injects a deliberate
off-by-one (the sweep's closed ``<=`` tie flipped to open ``<``) into a
cloned engine and asserts the harness catches it and shrinks it to ≤ 6
regions — the harness testing the harness.
"""
from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.intervals import Extents, _np, _segment_length
from repro_torch.testing import conformance, metamorphic, oracles, threefry
from repro_torch.testing.shrink import (ReproArtifact, shrink_script,
                                        shrink_workload)

# fixed size ladder (the JAX package's: shapes repeat across seeds)
SIZES = (1, 2, 3, 5, 8, 13, 21, 34)
SMOKE_SIZES = (1, 2, 3, 5, 8)


def _mk(lo_s, hi_s, lo_u, hi_u, d: int, device) -> Tuple[Extents, Extents]:
    def side(lo, hi):
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        if d == 1:
            lo, hi = lo.reshape(-1), hi.reshape(-1)
        return Extents(torch.from_numpy(np.ascontiguousarray(lo)).to(device),
                       torch.from_numpy(np.ascontiguousarray(hi)).to(device))
    return side(lo_s, hi_s), side(lo_u, hi_u)


# ---------------------------------------------------------------------------
# adversarial corpus: name -> gen(rng, n, m, d, device) -> (subs, upds)
# ---------------------------------------------------------------------------

def _grid(rng, count, d, top=12, span=5):
    lo = rng.randint(0, top, (d, count)).astype(np.float32)
    return lo, lo + rng.randint(0, span + 1, (d, count))


def gen_uniform_float(rng, n, m, d, device="cuda"):
    def side(c):
        lo = rng.uniform(0.0, 100.0, (d, c)).astype(np.float32)
        return lo, lo + rng.exponential(8.0, (d, c)).astype(np.float32)
    return _mk(*side(n), *side(m), d, device)


def gen_integer_ties(rng, n, m, d, device="cuda"):
    """Small integer grid: endpoints collide constantly — the tie-break
    (lowers before uppers at equal values) is load-bearing everywhere."""
    return _mk(*_grid(rng, n, d), *_grid(rng, m, d), d, device)


def gen_zero_width(rng, n, m, d, device="cuda"):
    """Points (hi == lo) mixed with thin intervals on the same grid."""
    lo_s = rng.randint(0, 8, (d, n)).astype(np.float32)
    wid = rng.randint(0, 2, (d, n)) * rng.randint(0, 2, (d, n))
    lo_u = rng.randint(0, 8, (d, m)).astype(np.float32)
    return _mk(lo_s, lo_s + wid, lo_u, lo_u, d, device)


def gen_all_identical(rng, n, m, d, device="cuda"):
    """Every extent the same closed interval — maximal ties, K = n·m."""
    lo = float(rng.randint(0, 5))
    hi = lo + float(rng.randint(0, 3))
    return _mk(np.full((d, n), lo), np.full((d, n), hi),
               np.full((d, m), lo), np.full((d, m), hi), d, device)


def gen_duplicates(rng, n, m, d, device="cuda"):
    """A handful of distinct extents, each repeated many times."""
    k = max(1, min(3, n, m))
    lo_k, hi_k = _grid(rng, k, d)
    pick_s = rng.randint(0, k, n)
    pick_u = rng.randint(0, k, m)
    return _mk(lo_k[:, pick_s], hi_k[:, pick_s],
               lo_k[:, pick_u], hi_k[:, pick_u], d, device)


# smallest-normal .. near-max float32.  Denormals are deliberately absent,
# as in the JAX package's corpus: XLA flushes them to zero, so the two
# packages' host oracles would part there
_EXTREME = np.asarray([0.0, np.finfo(np.float32).tiny, 1.0e-30, 1.0,
                       1.0e18, 1.0e37], np.float32)


def gen_extreme_floats(rng, n, m, d, device="cuda"):
    """Tiny-normal / huge finite magnitudes with random signs; lo <= hi by
    construction (sorted per region)."""
    def side(c):
        a = _EXTREME[rng.randint(0, _EXTREME.size, (d, c))]
        a = a * rng.choice([-1.0, 1.0], (d, c)).astype(np.float32)
        b = _EXTREME[rng.randint(0, _EXTREME.size, (d, c))]
        b = b * rng.choice([-1.0, 1.0], (d, c)).astype(np.float32)
        return np.minimum(a, b), np.maximum(a, b)
    return _mk(*side(n), *side(m), d, device)


def _tall_thin_arrays(seed: int, n_sub: int, n_upd: int, alpha: float,
                      d: int, length: float, wide_dim: int):
    """The JAX package's ``make_tall_thin_workload`` of ``PRNGKey(seed)``
    as numpy (d, n + m) lo/hi: dim ``wide_dim`` spans 98 % of the space,
    the others carry segments of length αL/N."""
    total = n_sub + n_upd
    seg_len = _segment_length(alpha, length, total)
    k_lo, k_wide = threefry.split(threefry.key(seed))
    lo = threefry.uniform(k_lo, (d, total), 0.0, length - seg_len)
    hi = lo + np.float32(seg_len)
    wide_lo = threefry.uniform(k_wide, (total,), 0.0, 0.02 * length)
    lo[wide_dim] = wide_lo
    hi[wide_dim] = wide_lo + np.float32(0.98 * length)
    return lo, hi


def _clustered_arrays(seed: int, n_sub: int, n_upd: int, alpha: float,
                      d: int, length: float, n_clusters: int = 16):
    """The JAX package's ``make_clustered_workload`` of ``PRNGKey(seed)``
    as numpy lo/hi ((n + m,) for d = 1, else (d, n + m)): Gaussian jitter
    around ``n_clusters`` uniform centers, clipped to the space."""
    total = n_sub + n_upd
    seg_len = _segment_length(alpha, length, total)
    kc, kj = threefry.split(threefry.key(seed))
    shape = (total,) if d == 1 else (d, total)
    centers = threefry.uniform(kc, (n_clusters,) if d == 1
                               else (d, n_clusters), 0.0, length)
    assign = threefry.randint(kj, (total,), 0, n_clusters)
    jitter = threefry.normal(threefry.fold_in(kj, 1), shape)
    lo = centers[..., assign] \
        + jitter * np.float32(length / (20 * n_clusters))
    lo = np.minimum(np.maximum(lo, np.float32(0.0)),
                    np.float32(length - seg_len))
    return lo, lo + np.float32(seg_len)


def _split_sides(lo, hi, n_sub: int, d: int, device):
    lo, hi = lo.reshape(d, -1), hi.reshape(d, -1)
    return _mk(lo[:, :n_sub], hi[:, :n_sub], lo[:, n_sub:], hi[:, n_sub:],
               d, device)


def gen_tall_thin(rng, n, m, d, device="cuda"):
    """The selective-dimension adversary: one dim matches every pair."""
    seed = int(rng.randint(0, 2**31 - 1))
    n, m = max(n, 2), max(m, 2)
    alpha = min(6.0, float(n + m))          # segment length αL/N needs α ≤ N
    d = max(d, 2)
    lo, hi = _tall_thin_arrays(seed, n, m, alpha, d, 1000.0,
                               int(rng.randint(0, d)))
    return _split_sides(lo, hi, n, d, device)


def gen_clustered(rng, n, m, d, device="cuda"):
    seed = int(rng.randint(0, 2**31 - 1))
    n, m = max(n, 1), max(m, 1)
    lo, hi = _clustered_arrays(seed, n, m, min(4.0, float(n + m)), d,
                               1000.0)
    return _split_sides(lo, hi, n, d, device)


def gen_equal_selectivity(rng, n, m, d, device="cuda"):
    """Every dimension i.i.d. from the same grid — the dimension-selection
    argmin sees constant ties and must still stay deterministic/exact."""
    lo_s = rng.randint(0, 10, (1, n)).astype(np.float32)
    hi_s = lo_s + rng.randint(0, 4, (1, n))
    lo_u = rng.randint(0, 10, (1, m)).astype(np.float32)
    hi_u = lo_u + rng.randint(0, 4, (1, m))
    rep = (np.repeat(lo_s, d, 0), np.repeat(hi_s, d, 0),
           np.repeat(lo_u, d, 0), np.repeat(hi_u, d, 0))
    return _mk(*rep, d, device)


def gen_single_region(rng, n, m, d, device="cuda"):
    """1×1 worlds, biased toward exact endpoint touching."""
    lo = float(rng.randint(0, 4))
    hi = lo + float(rng.randint(0, 3))
    touch = rng.rand() < 0.5
    u_lo = hi if touch else lo + 1.0
    return _mk(np.full((d, 1), lo), np.full((d, 1), hi),
               np.full((d, 1), u_lo), np.full((d, 1), u_lo + 1.0), d, device)


def gen_empty_side(rng, n, m, d, device="cuda"):
    which = rng.randint(0, 3)
    n_eff = 0 if which in (0, 2) else max(n, 1)
    m_eff = 0 if which in (1, 2) else max(m, 1)
    lo_s, hi_s = _grid(rng, n_eff, d)
    lo_u, hi_u = _grid(rng, m_eff, d)
    return _mk(lo_s, hi_s, lo_u, hi_u, d, device)


CORPUS: Dict[str, Callable] = {
    "integer_ties": gen_integer_ties,
    "zero_width": gen_zero_width,
    "all_identical": gen_all_identical,
    "duplicates": gen_duplicates,
    "uniform_float": gen_uniform_float,
    "extreme_floats": gen_extreme_floats,
    "tall_thin": gen_tall_thin,
    "clustered": gen_clustered,
    "equal_selectivity": gen_equal_selectivity,
    "single_region": gen_single_region,
    "empty_side": gen_empty_side,
}

# corpora whose coordinates survive the translation/scale transforms
# losslessly in float32 (see metamorphic.TIE_SENSITIVE)
_INTEGER_CORPORA = ("integer_ties", "zero_width", "all_identical",
                    "duplicates", "equal_selectivity", "single_region")
_DDIM_ONLY = ("tall_thin",)


# ---------------------------------------------------------------------------
# churn scripts
# ---------------------------------------------------------------------------

def random_script(rng, dims: int, batches: int = 6,
                  max_ops: int = 5) -> List[tuple]:
    """A legal random churn script in the tuple-batch format: per batch a
    few add/move/remove ops with disjoint rids, integer-grid bounds (heavy
    ties), removes/moves only of live rids."""
    live = {"sub": set(), "upd": set()}
    next_rid = {"sub": 0, "upd": 0}
    script = []
    for _ in range(batches):
        adds, moves, removes = [], [], []
        used = set()
        for _ in range(rng.randint(1, max_ops + 1)):
            side = "sub" if rng.rand() < 0.5 else "upd"
            op = rng.randint(0, 3)
            cand = [r for r in live[side] if (side, r) not in used]
            lo = rng.randint(0, 20, dims).astype(np.float32)
            hi = lo + rng.randint(0, 6, dims)
            if op == 0 or not cand:
                rid = next_rid[side]
                next_rid[side] += 1
                adds.append((side, rid, lo, hi))
                live[side].add(rid)
            elif op == 1:
                rid = cand[rng.randint(len(cand))]
                moves.append((side, rid, lo, hi))
            else:
                rid = cand[rng.randint(len(cand))]
                removes.append((side, rid))
                live[side].discard(rid)
            used.add((side, rid))
        script.append((adds, moves, removes))
    return script


def probe_duplicate_rid(dims: int, device="cuda") -> List[str]:
    """Duplicate-rid batches must be rejected loudly by every stateful
    surface (a silently aliased slot corrupts the index forever)."""
    problems = []
    for impl in conformance.CHURN_IMPLS:
        runner = conformance.churn_runner(impl, dims, device=device)
        lo = np.zeros(dims, np.float32)
        hi = np.ones(dims, np.float32)
        runner.apply([("sub", 0, lo, hi)], [], [])
        try:
            runner.apply([], [("sub", 0, lo, hi)], [("sub", 0)])
        except ValueError:
            pass
        else:
            problems.append(
                f"churn impl {impl!r} accepted a duplicate-rid batch")
    return problems


# ---------------------------------------------------------------------------
# the fuzz loop
# ---------------------------------------------------------------------------

class Failure:
    """One caught divergence, already shrunk, with its artifact."""

    def __init__(self, artifact: ReproArtifact):
        self.artifact = artifact

    def __str__(self) -> str:
        a = self.artifact
        return (f"[seed {a.seed}] {a.kind} failure in {a.engine!r} "
                f"({a.region_count()} regions after shrink): {a.detail}")


def _shrunk_workload_failure(engine: conformance.MatchEngine, kind: str,
                             seed: int, detail: str, subs, upds,
                             failing) -> Failure:
    try:
        subs, upds = shrink_workload(subs, upds, failing)
    except ValueError:
        pass        # flaky failure (did not reproduce) — keep unshrunk
    want = oracles.reference_pairs(subs, upds)
    try:
        got = engine.pairs(subs, upds)
    except Exception:       # keep the artifact even if the engine now dies
        got = None
    art = ReproArtifact.from_workload(engine.name, kind, seed, detail,
                                      subs, upds, want=want, got=got)
    return Failure(art)


def run_seed(seed: int, engine_names: Optional[List[str]] = None,
             smoke: bool = False,
             extra_engines: Optional[Dict[str, conformance.MatchEngine]] = None,
             device="cuda") -> Tuple[int, List[Failure]]:
    """One fuzz seed on ``device``: workload generation, differential
    grading, metamorphic relations, periodic churn + duplicate-rid
    probes.  Returns (checks_run, failures)."""
    rng = np.random.RandomState(seed)
    names = list(CORPUS)
    corpus = names[seed % len(names)]
    d = int(rng.choice([1, 1, 2, 3]))          # bias to 1-d (most engines)
    if corpus in _DDIM_ONLY:
        d = max(d, 2)
    sizes = SMOKE_SIZES if smoke else SIZES
    n = int(rng.choice(sizes))
    m = int(rng.choice(sizes))
    subs, upds = CORPUS[corpus](rng, n, m, d, device=device)
    d = subs.ndim_space                         # generators may widen d
    want = oracles.reference_pairs(subs, upds)

    engines = conformance.engines_for(d, engine_names)
    if extra_engines:
        engines += [e for e in extra_engines.values() if e.supports(d)]
    checks = 0
    failures: List[Failure] = []
    for engine in engines:
        checks += 1
        mm = conformance.check_engine(engine, subs, upds, want=want)
        if mm is None:
            continue
        failures.append(_shrunk_workload_failure(
            engine, "pairs", seed, mm.describe(), subs, upds,
            lambda s, u, e=engine: e.pairs(s, u) != oracles.reference_pairs(s, u)))

    # metamorphic relations: rotate one engine per seed; tie-sensitive
    # transforms only on integer corpora
    if engines:
        engine = engines[seed % len(engines)]
        rels = [r for r in metamorphic.STATELESS_RELATIONS
                if r not in metamorphic.TIE_SENSITIVE
                or corpus in _INTEGER_CORPORA]
        for rel in rels:
            checks += 1
            v = metamorphic.STATELESS_RELATIONS[rel](engine.pairs, subs, upds)
            if v is not None:
                failures.append(_shrunk_workload_failure(
                    engine, f"metamorphic:{rel}", seed, str(v), subs, upds,
                    lambda s, u, r=rel, e=engine:
                        metamorphic.STATELESS_RELATIONS[r](e.pairs, s, u)
                        is not None))

    # churn + validation probes every third seed
    if seed % 3 == 0:
        churn_d = 1 if seed % 6 == 0 else 2
        script = random_script(rng, churn_d,
                               batches=3 if smoke else 6)
        checks += 1
        problems = conformance.check_churn_script(script, churn_d,
                                                  device=device)
        if problems:
            script = shrink_script(
                script,
                lambda sc: bool(conformance.check_churn_script(
                    sc, churn_d, device=device)))
            art = ReproArtifact.from_script(
                "churn", seed, "; ".join(problems[:3]), churn_d, script)
            failures.append(Failure(art))
        checks += 1
        for msg in probe_duplicate_rid(churn_d, device=device):
            art = ReproArtifact("churn_validation", "churn", churn_d, seed,
                                msg)
            failures.append(Failure(art))

        # batch-split equivalence on a fresh two-batch script
        split_script = random_script(rng, churn_d, batches=2,
                                     max_ops=4 if smoke else 6)
        if len(split_script) == 2:
            checks += 1
            v = metamorphic.check_batch_split(churn_d, split_script[0],
                                              split_script[1], device=device)
            if v is not None:
                art = ReproArtifact.from_script(
                    "index_vector", seed, str(v), churn_d, split_script)
                failures.append(Failure(art))
    return checks, failures


def run_fuzz(seeds: int, engine_names: Optional[List[str]] = None,
             smoke: bool = False, artifacts: Optional[str] = None,
             base_seed: int = 0,
             extra_engines: Optional[Dict] = None,
             verbose: bool = True, device="cuda"
             ) -> Tuple[int, List[Failure]]:
    total_checks = 0
    failures: List[Failure] = []
    for k in range(seeds):
        seed = base_seed + k
        checks, fails = run_seed(seed, engine_names, smoke, extra_engines,
                                 device=device)
        total_checks += checks
        failures.extend(fails)
        if verbose and fails:
            for f in fails:
                print(f"FAIL {f}", file=sys.stderr)
        if verbose and (k + 1) % 25 == 0:
            print(f"  ... {k + 1}/{seeds} seeds, {total_checks} checks, "
                  f"{len(failures)} failures", file=sys.stderr)
    if artifacts:
        for f in failures:
            path = f.artifact.save(artifacts)
            if verbose:
                print(f"  repro artifact: {path}", file=sys.stderr)
                print(f.artifact.to_pytest(str(device)), file=sys.stderr)
    return total_checks, failures


# ---------------------------------------------------------------------------
# self-check: inject a tie bug, assert the harness catches and shrinks it
# ---------------------------------------------------------------------------

def broken_open_interval_engine() -> conformance.MatchEngine:
    """The sweep with its closed-interval ``<=`` tie flipped to ``<``:
    pairs whose intersection is a single point in some dimension vanish —
    exactly what an off-by-one in the endpoint tie-break would do."""
    def pairs(subs: Extents, upds: Extents):
        base = conformance.get_engine("sweep").pairs(subs, upds)
        s_lo, s_hi, u_lo, u_hi = (np.atleast_2d(_np(a)) for a in (
            subs.lo, subs.hi, upds.lo, upds.hi))
        out = set()
        for i, j in base:
            start = np.maximum(s_lo[:, i], u_lo[:, j])
            end = np.minimum(s_hi[:, i], u_hi[:, j])
            if not np.any(start == end):       # drop single-point overlaps
                out.add((i, j))
        return out
    return conformance.MatchEngine("sweep#open-tie-bug", pairs)


def self_check(verbose: bool = True, device="cuda",
               artifact: Optional[list] = None) -> int:
    """Returns 0 when the harness catches AND minimally shrinks the
    injected off-by-one on ``device``; nonzero otherwise (the CI gate).
    ``artifact``: a list that receives the best shrunk artifact."""
    broken = {"sweep#open-tie-bug": broken_open_interval_engine()}
    # the broken engine only: every conformant engine stays out of the run
    _, failures = run_fuzz(30, engine_names=[], smoke=True,
                           extra_engines=broken, verbose=False,
                           device=device)
    caught = [f for f in failures if f.artifact.engine == "sweep#open-tie-bug"
              and f.artifact.kind == "pairs"]
    if not caught:
        print("SELF-CHECK FAILED: injected tie bug was not caught",
              file=sys.stderr)
        return 1
    worst = min(caught, key=lambda f: f.artifact.region_count())
    n_regions = worst.artifact.region_count()
    if artifact is not None:
        artifact.append(worst.artifact)
    if verbose:
        print(f"self-check: injected '<=' tie flip caught {len(caught)} "
              f"time(s); best shrink: {n_regions} regions")
        print(worst.artifact.to_pytest(str(device)))
    if n_regions > 6:
        print(f"SELF-CHECK FAILED: shrunk repro has {n_regions} regions "
              "(acceptance bound is 6)", file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.testing.fuzz",
        description="differential fuzz across the port's DDM engine registry")
    ap.add_argument("--seeds", type=int, default=25,
                    help="number of fuzz seeds (default 25)")
    ap.add_argument("--engines", default="all",
                    help="comma-separated engine names, or 'all'")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + shorter churn scripts (the CI job)")
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--artifacts", default="fuzz_repros", metavar="DIR",
                    help="where shrunk-repro JSON artifacts land on failure")
    ap.add_argument("--self-check", action="store_true",
                    help="inject a tie bug; assert catch + shrink <= 6 regions")
    ap.add_argument("--device", default="cuda",
                    help="where the extents and engines run (default cuda)")
    args = ap.parse_args(argv)

    if args.self_check:
        return self_check(device=args.device)

    engine_names = None if args.engines == "all" \
        else [s for s in args.engines.split(",") if s]
    known = set(conformance.all_engines())
    if engine_names is not None:
        unknown = set(engine_names) - known
        if unknown:
            ap.error(f"unknown engines {sorted(unknown)}; "
                     f"registered: {sorted(known)}")
    checks, failures = run_fuzz(args.seeds, engine_names, args.smoke,
                                artifacts=args.artifacts,
                                base_seed=args.base_seed, device=args.device)
    n_engines = len(known if engine_names is None else engine_names)
    print(f"fuzz: {args.seeds} seeds x {n_engines} engines on {args.device}, "
          f"{checks} checks, {len(failures)} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
