"""Extent (interval / d-rectangle) containers and DDM workload generators.

Terminology follows the paper: *subscription* extents ``S`` and *update*
extents ``U`` are axis-parallel d-rectangles; the DDM problem asks for all
pairs ``(S_i, U_j)`` with a non-empty closed intersection.

Everything here is structure-of-arrays: an extent set with ``n`` members in
``d`` dimensions is a pair of ``(d, n)`` (or ``(n,)`` for d=1) tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.errors import ValidationError


@dataclasses.dataclass(frozen=True)
class Extents:
    """A set of closed intervals (d=1) or d-rectangles (lo/hi of shape (d, n))."""

    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def ndim_space(self) -> int:
        return 1 if self.lo.ndim == 1 else self.lo.shape[0]

    @property
    def size(self) -> int:
        return self.lo.shape[-1]

    def validate(self) -> "Extents":
        if self.lo.shape != self.hi.shape:
            raise ValidationError(
                f"lo/hi shape mismatch: {tuple(self.lo.shape)} vs "
                f"{tuple(self.hi.shape)}")
        return self


def intersect_1d(x_lo, x_hi, y_lo, y_hi):
    """Algorithm 1 of the paper: closed-interval overlap test (broadcasts)."""
    return (x_lo <= y_hi) & (y_lo <= x_hi)


def intersect_ddim(a: Extents, b: Extents):
    """d-rectangles overlap iff all 1-d projections overlap (paper §3)."""
    if a.ndim_space == 1:
        return intersect_1d(a.lo, a.hi, b.lo, b.hi)
    per_dim = intersect_1d(a.lo[:, :, None], a.hi[:, :, None],
                           b.lo[:, None, :], b.hi[:, None, :])
    return per_dim.all(dim=0)


def _segment_length(alpha: float, length: float, total: int) -> float:
    """The paper-§5 segment length l = αL/N; raises when l > L (the
    placement range ``length - l`` would be negative)."""
    seg_len = alpha * length / total
    if seg_len > length:
        raise ValidationError(
            f"alpha={alpha} with N={total} regions gives segment length "
            f"{seg_len} > routing space {length} (need alpha <= N); "
            "placement range length - seg_len would be negative")
    return seg_len


def _split(lo: torch.Tensor, hi: torch.Tensor, n_sub: int, device
           ) -> Tuple[Extents, Extents]:
    lo, hi = lo.to(device), hi.to(device)
    return (Extents(lo[..., :n_sub].contiguous(), hi[..., :n_sub].contiguous()),
            Extents(lo[..., n_sub:].contiguous(), hi[..., n_sub:].contiguous()))


def make_uniform_workload(n_sub: int, n_upd: int, alpha: float,
                          length: float = 1.0e6, d: int = 1, *,
                          generator: Optional[torch.Generator] = None,
                          device="cuda") -> Tuple[Extents, Extents]:
    """The paper's §5 benchmark workload.

    ``N = n_sub + n_upd`` extents, each of identical side ``l = alpha * L / N``
    placed uniformly at random on a routing space of side ``L``.  The draw
    happens on the generator's device and the result moves to ``device``,
    so one seed gives the same extents on every device.
    """
    total = n_sub + n_upd
    seg_len = _segment_length(alpha, length, total)
    shape = (total,) if d == 1 else (d, total)
    gdev = generator.device if generator is not None else "cpu"
    lo = torch.rand(shape, generator=generator, dtype=torch.float32,
                    device=gdev) * (length - seg_len)
    hi = lo + seg_len
    return _split(lo, hi, n_sub, device)


def make_clustered_workload(n_sub: int, n_upd: int, alpha: float,
                            n_clusters: int = 16, length: float = 1.0e6,
                            d: int = 1, *,
                            generator: Optional[torch.Generator] = None,
                            device="cuda") -> Tuple[Extents, Extents]:
    """A skewed workload (Gaussian hot spots) to stress load balance."""
    total = n_sub + n_upd
    seg_len = _segment_length(alpha, length, total)
    gdev = generator.device if generator is not None else "cpu"
    shape = (total,) if d == 1 else (d, total)
    centers = torch.rand((n_clusters,) if d == 1 else (d, n_clusters),
                         generator=generator, device=gdev) * length
    assign = torch.randint(0, n_clusters, (total,), generator=generator,
                           device=gdev)
    jitter = torch.randn(shape, generator=generator, device=gdev) \
        * (length / (20 * n_clusters))
    lo = (centers[..., assign] + jitter).clamp(0.0, length - seg_len) \
        .to(torch.float32)
    hi = lo + seg_len
    return _split(lo, hi, n_sub, device)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mask_numpy(subs: Extents, upds: Extents) -> np.ndarray:
    s_lo, s_hi, u_lo, u_hi = (_np(a) for a in (subs.lo, subs.hi,
                                              upds.lo, upds.hi))
    if s_lo.ndim == 1:
        return (s_lo[:, None] <= u_hi[None, :]) & (u_lo[None, :] <= s_hi[:, None])
    mask = np.ones((s_lo.shape[1], u_lo.shape[1]), dtype=bool)
    for dd in range(s_lo.shape[0]):
        mask &= (s_lo[dd][:, None] <= u_hi[dd][None, :]) \
            & (u_lo[dd][None, :] <= s_hi[dd][:, None])
    return mask


def brute_force_count_numpy(subs: Extents, upds: Extents) -> int:
    """O(n·m) oracle on host — ground truth for every matching test."""
    return int(_mask_numpy(subs, upds).sum())


def brute_force_pairs_numpy(subs: Extents, upds: Extents) -> set:
    """Host oracle returning the exact match set {(i, j)}."""
    ii, jj = np.nonzero(_mask_numpy(subs, upds))
    return set(zip(ii.tolist(), jj.tolist()))
