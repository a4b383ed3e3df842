"""The single source of reference pair sets of the port.

Every conformance check answers "what SHOULD the pair set be" through this
module.  Two independent host references back every answer: the
sequential Algorithm-4 sweep (d-dim form: 1-d sweep + projection filter)
and the vectorized numpy brute force.  :func:`reference_pairs`
cross-checks them against each other, so a bug would have to hit two
unrelated host implementations identically before an engine could be
graded against a wrong answer.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch

from repro_torch.core.intervals import Extents, brute_force_pairs_numpy
from repro_torch.core.runtime import pair_set  # noqa: F401 (public here too)
from repro_torch.core.sweep import (
    sequential_sbm_pairs_numpy,
    sequential_sbm_pairs_numpy_ddim,
)

Pair = Tuple[int, int]
PairSet = Set[Pair]


def sequential_pairs(subs: Extents, upds: Extents, sweep_dim: int = 0) -> PairSet:
    """Paper Algorithm 4 on the host (d-dim: sweep ``sweep_dim`` + filter)."""
    return sequential_sbm_pairs_numpy_ddim(subs, upds, sweep_dim)


def brute_force_pairs(subs: Extents, upds: Extents) -> PairSet:
    """Vectorized numpy all-pairs closed-interval test (any d)."""
    return brute_force_pairs_numpy(subs, upds)


def reference_pairs(subs: Extents, upds: Extents) -> PairSet:
    """THE oracle: sequential sweep cross-checked against brute force.

    The two references share no code path (one is a sorted endpoint scan,
    the other a broadcast comparison); disagreement raises immediately
    rather than grading engines against a possibly-wrong answer.
    """
    if subs.size == 0 or upds.size == 0:
        return set()
    want = sequential_sbm_pairs_numpy_ddim(subs, upds)
    bf = brute_force_pairs_numpy(subs, upds)
    if want != bf:
        raise AssertionError(
            "host references disagree: sequential sweep vs brute force "
            f"differ by {want ^ bf} — the oracle itself is broken")
    return want


# ---------------------------------------------------------------------------
# rid-space oracles over live-region state (stateful engines)
# ---------------------------------------------------------------------------

def live_extents(live: Dict[int, tuple], dims: int, *, device="cuda"):
    """dict rid → (lo, hi) → (sorted rids, Extents) with float32 bounds on
    ``device``."""
    ids = sorted(live)
    lo = np.asarray([live[r][0] for r in ids], np.float32).T
    hi = np.asarray([live[r][1] for r in ids], np.float32).T
    if dims == 1:
        lo, hi = lo.reshape(-1), hi.reshape(-1)
    return ids, Extents(torch.from_numpy(np.ascontiguousarray(lo)).to(device),
                        torch.from_numpy(np.ascontiguousarray(hi)).to(device))


def live_pairs(live_s: Dict[int, tuple], live_u: Dict[int, tuple],
               dims: int) -> PairSet:
    """Brute-force pair set over live rid → (lo, hi) dicts, in rid space
    (host only)."""
    if not live_s or not live_u:
        return set()
    sids, subs = live_extents(live_s, dims, device="cpu")
    uids, upds = live_extents(live_u, dims, device="cpu")
    return {(sids[i], uids[j])
            for i, j in brute_force_pairs_numpy(subs, upds)}


def sweep_rebuild_pairs(live_s: Dict[int, tuple],
                        live_u: Dict[int, tuple], *, device="cuda") -> PairSet:
    """From-scratch ``sbm_enumerate`` on ``device`` over live regions (1-d),
    in rid space — the churn oracle: the delta-composed state must equal a
    stateless sweep rebuild after every batch."""
    from repro_torch.core.enumerate import sbm_enumerate

    if not live_s or not live_u:
        return set()
    sids, subs = live_extents(live_s, 1, device=device)
    uids, upds = live_extents(live_u, 1, device=device)
    want_k = len(sequential_sbm_pairs_numpy(subs, upds))
    pairs, count = sbm_enumerate(subs, upds, max_pairs=max(want_k, 1) + 8)
    if int(count) != want_k:
        raise AssertionError(f"sweep rebuild counts {int(count)} pairs, "
                             f"the sequential sweep {want_k}")
    return {(sids[i], uids[j]) for i, j in pair_set(pairs)}


def service_pairs(svc) -> PairSet:
    """Reference pair set of a :class:`repro_torch.core.DDMService`, in rid
    space.

    Reads the live region tables directly (not the delta-maintained
    cache), so comparing ``svc.all_pairs()`` against this is the
    delta-vs-rebuild set-diff check.
    """
    sl = svc._subs.live_ids()
    ul = svc._upds.live_ids()
    if sl.size == 0 or ul.size == 0:
        return set()
    subs = svc._subs.compact(sl, "cpu")
    upds = svc._upds.compact(ul, "cpu")
    return {(int(sl[i]), int(ul[j])) for i, j in reference_pairs(subs, upds)}
