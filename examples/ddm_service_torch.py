"""End-to-end DDM driver of the PyTorch/CUDA port — the paper's §5 scenario.

The twin of ``examples/ddm_service.py`` on ``repro_torch``: region
registration, parallel sort-based matching, event routing and dynamic
region movement, at α ∈ {0.01, 1, 100}; prints a wall-clock table for the
sort-based sweep against the BF and rank (ITM-analogue) baselines and
checks every count against an independent oracle (the sequential sweep,
and the three engines against each other).  Runs on the card unless given
``--device cpu``.

    PYTHONPATH=src python examples/ddm_service_torch.py [--n 200000] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (DDMService, bf_count, make_uniform_workload,
                              rank_count, sbm_count)
from repro_torch.core.sweep import sequential_sbm_count_numpy


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def matching_table(n: int, device) -> None:
    print(f"\n== matching wall-clock on {device}, N={n}, counts cross-checked ==")
    print(f"{'alpha':>8} {'K':>12} {'SBM ms':>10} {'rank ms':>10} {'BF ms':>10}")
    for alpha in (0.01, 1.0, 100.0):
        gen = torch.Generator().manual_seed(0)
        subs, upds = make_uniform_workload(n // 2, n // 2, alpha=alpha,
                                           generator=gen, device=device)

        def timed(fn):
            fn()                                     # warm (kernel build)
            _sync(device)
            t0 = time.perf_counter()
            out = int(fn())
            _sync(device)
            return out, (time.perf_counter() - t0) * 1e3

        k_sbm, t_sbm = timed(lambda: sbm_count(subs, upds, num_segments=16))
        k_rank, t_rank = timed(lambda: rank_count(subs, upds))
        k_bf, t_bf = timed(lambda: bf_count(subs, upds, block=2048))
        k_ref = sequential_sbm_count_numpy(subs, upds)
        assert k_sbm == k_rank == k_bf == k_ref, (k_sbm, k_rank, k_bf, k_ref)
        print(f"{alpha:8.2f} {k_sbm:12d} {t_sbm:10.2f} {t_rank:10.2f} "
              f"{t_bf:10.2f}")


def service_demo(device) -> None:
    print(f"\n== DDM service lifecycle (2-D regions) on {device} ==")
    svc = DDMService(dims=2, capacity=4096, device=device)
    rng = np.random.RandomState(0)
    subs = [svc.register("sub", lo, lo + rng.rand(2) * 10)
            for lo in rng.rand(500, 2) * 100]
    upds = [svc.register("upd", lo, lo + rng.rand(2) * 10)
            for lo in rng.rand(200, 2) * 100]
    print(f"registered {len(subs)} subscriptions, {len(upds)} updates")
    print(f"total matches: {svc.match_count()}")

    u = upds[0]
    receivers = svc.matches_for_update(u)
    delivered = svc.route(u, {"event": "position-update"})
    print(f"update region {u} routes to {len(receivers)} subscribers")
    assert set(delivered) == set(receivers)

    # dynamic DDM: an agent moves across the space
    before = len(svc.matches_for_update(u))
    svc.move("upd", u, [0, 0], [100, 100])   # grows to cover everything
    after = len(svc.matches_for_update(u))
    print(f"after move: {before} -> {after} matched subscriptions")
    assert after >= before

    # delta rematching: flush() applies the pending moves as one
    # incremental-index batch and returns exactly the pairs the batch
    # created/destroyed — the notification set, no world rebuild
    svc.all_pairs()                           # warm the cached match state
    svc.move("upd", u, [0, 0], [5, 5])        # shrinks back down
    delta = svc.flush()
    print(f"delta rematch: +{len(delta.added)} / -{len(delta.removed)} pairs")
    assert len(svc.all_pairs()) == svc.match_count()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    matching_table(args.n, args.device)
    service_demo(args.device)
    print("\nOK")


if __name__ == "__main__":
    main()
