"""Closed-loop full matches through the port's rebuild chain.

One client asks for the whole match again and again; each call takes the
next of ``placements`` placements drawn from the seed at set-up (the
configuration's N, L, alpha, uniform, float32), so no two successive calls
see the same extents.  A match is the chain of the service's rebuild
(``core/service.py`` ``_planned_sweep``) through public functions: the
counting sweep ``kernels.ops.sbm_count_kernel`` probes K (one host sync),
``core.execute_enumeration`` plans the buffer from it and runs
``core.enumerate_matches_ddim(method="sweep")`` on the pass-C engine
``kernels.ops.sbm_enumerate_kernel`` while its scratch fits the service's
budget (else the rank-table engine, as the service does); the count's
sync closes the call, and the pairs stay on the device.

End-to-end: ``ddm_match_ms``, the window's milliseconds over the matches
completed in it (the window closes when the match that started before
``--seconds`` ran out completes).

The check: every match's K against the plain NumPy sweep's for its
placement (``k_wrong``: matches whose K differs), and the whole pair set
of the last match of ``check_placements`` placements drawn from the seed
(``pairs_wrong``: pairs missing, extra or repeated).  Both must be 0.

``control_hook`` puts the control in the program's place: the reference
on the bounds rounded to bfloat16.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from gpubench.gen.extents import uniform_placement
from gpubench.lib.common import seed_stream
from gpubench.reference import interval_sweep


class State:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _match(st: State, p: int):
    """One full match on placement ``p``: (pairs buffer, K)."""
    from repro_torch import core
    from repro_torch.core.intervals import Extents
    from repro_torch.core.service import REBUILD_SCRATCH_BUDGET
    from repro_torch.kernels import ops

    s_lo, s_hi, u_lo, u_hi = st.placements[p]
    subs, upds = Extents(s_lo, s_hi), Extents(u_lo, u_hi)
    k = int(ops.sbm_count_kernel(subs, upds))
    engine = (ops.sbm_enumerate_kernel
              if ops.pass_c_scratch_bytes(subs.size, upds.size)
              <= REBUILD_SCRATCH_BUDGET else None)

    def fn(s, u, *, max_pairs):
        return core.enumerate_matches_ddim(s, u, max_pairs=max_pairs,
                                           method="sweep", generator_dim=0,
                                           engine=engine)

    pairs, _, stats = core.execute_enumeration(
        fn, subs, upds, estimate=k, engine="gpubench", regime="sweep_1d")
    return pairs, int(stats.count)


def setup(ctx) -> State:
    torch, cfg, tr = ctx.torch, ctx.config, ctx.traffic
    if int(cfg["dims"]) != 1 or cfg["placement"] != "uniform" \
            or cfg["bounds_dtype"] != "float32":
        raise ValueError(f"{cfg['name']}: ddm_match runs d = 1, uniform, "
                         "float32 deployments")
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seed_stream(ctx.seed, "placements"))
    st = State(placements=[
        uniform_placement(int(cfg["n_subscriptions"]),
                          int(cfg["n_updates"]), float(cfg["alpha"]),
                          float(cfg["length"]), gen, torch)
        for _ in range(int(tr["placements"]))], kept={}, counts=[],
        match=_match)
    for i in range(int(tr["warmup_matches"])):
        st.match(st, i % len(st.placements))
    ctx.spans.items.clear()
    return st


def window(st: State, ctx) -> Dict:
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    i = 0
    while True:
        p = i % len(st.placements)
        with ctx.spans.span("match"):
            pairs, k = st.match(st, p)
        st.kept[p] = pairs
        st.counts.append((p, k))
        i += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    return {"attempted": i, "failed": 0, "window_s": window_s,
            "end_to_end": {"ddm_match_ms": window_s * 1e3 / i},
            "matches": list(st.counts),
            "n": int(ctx.config["n_subscriptions"]),
            "m": int(ctx.config["n_updates"])}


def _pairs_wrong(torch, pairs, ref_keys: np.ndarray, m: int) -> int:
    """Pairs of the program's buffer missing from, extra to or repeated
    against the reference's (compared as sorted int64 keys on the
    buffer's device)."""
    valid = pairs[pairs[:, 0] >= 0].to(torch.int64)
    got = torch.sort(valid[:, 0] * m + valid[:, 1]).values
    uniq = torch.unique_consecutive(got)
    ref = torch.sort(torch.from_numpy(ref_keys).to(got.device)).values
    both = int(torch.isin(uniq, ref).sum())
    return (got.numel() - both) + (ref.numel() - both)


def check(st: State, rec: Dict, ctx) -> Dict[str, float]:
    torch = ctx.torch
    host = [tuple(t.cpu().numpy() for t in pl) for pl in st.placements]
    ref_k = [interval_sweep.count(*h) for h in host]
    k_wrong = sum(1 for p, k in rec["matches"] if k != ref_k[p])
    rng = np.random.Generator(np.random.PCG64(seed_stream(ctx.seed,
                                                          "check")))
    kept = sorted(st.kept)
    pick = rng.choice(len(kept), size=min(int(ctx.traffic[
        "check_placements"]), len(kept)), replace=False).tolist()
    wrong = 0
    for p in (kept[i] for i in sorted(pick)):
        wrong += _pairs_wrong(torch, st.kept[p],
                              interval_sweep.pair_keys(*host[p]), rec["m"])
    return {"k_wrong": float(k_wrong), "pairs_wrong": float(wrong)}


def control_hook(driver, st: State) -> None:
    """Put the control in the program's place (after set-up): every
    match is answered by the reference on the placement's bounds rounded
    to bfloat16 (the precision below the configuration's float32), its K
    and its whole pair set as an int32 (K, 2) buffer on the device, made
    once a placement.  ``check`` judges it as it judges the program."""
    import torch

    made = {}

    def match(st, p):
        if p not in made:
            host = [t.to(torch.bfloat16).float().cpu().numpy()
                    for t in st.placements[p]]
            m = host[2].size
            k = interval_sweep.count(*host)
            dev = st.placements[p][0].device
            buf = torch.empty((k, 2), dtype=torch.int32, device=dev)
            at = 0
            for keys in interval_sweep.pair_key_chunks(*host):
                pairs = np.stack([keys // m, keys % m], axis=1)
                buf[at:at + len(keys)] = torch.from_numpy(
                    pairs.astype(np.int32)).to(dev)
                at += len(keys)
            made[p] = (buf, k)
        return made[p]

    st.match = match
