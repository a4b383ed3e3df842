"""The paper's section-5 workload (copied from the port's
``core/intervals.make_uniform_workload``): N = n + m extents of identical
length l = alpha·L/N, lower bounds uniform on [0, L - l) in float32 from a
generator on the device, upper = lower + l in float32; the first n are
subscriptions, the rest updates."""
from __future__ import annotations

from typing import Tuple


def uniform_placement(n: int, m: int, alpha: float, length: float, gen,
                      torch) -> Tuple:
    """(sub_lo, sub_hi, upd_lo, upd_hi), float32 tensors on ``gen``'s
    device."""
    total = n + m
    seg = alpha * length / total
    if seg > length:
        raise ValueError(f"alpha={alpha}, N={total}: l > L")
    lo = torch.rand((total,), generator=gen, dtype=torch.float32,
                    device=gen.device) * (length - seg)
    hi = lo + seg
    return (lo[:n].contiguous(), hi[:n].contiguous(),
            lo[n:].contiguous(), hi[n:].contiguous())
