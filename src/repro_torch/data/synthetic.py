"""The DDM workload registry: named d-dimensional region-set generators.

The axis the matching benchmarks and tests draw from (uniform / clustered /
tall-thin).  The JAX package's LM data pipeline, which shares its module
there, belongs to the model stack and is not ported here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import (
    Extents,
    make_clustered_workload,
    make_tall_thin_workload,
    make_uniform_workload,
)

DDM_WORKLOADS = ("uniform", "clustered", "tall_thin")


def ddm_workload(name: str, n_sub: int, n_upd: int, *, alpha: float,
                 d: int = 1, length: float = 1.0e6,
                 generator: Optional[torch.Generator] = None,
                 device="cuda") -> Tuple[Extents, Extents]:
    """Named d-dim DDM region-set generator (one axis of the bench matrix).

    ``uniform`` and ``clustered`` follow the paper §5 (identical side αL/N,
    uniform or 16-hot-spot placement, d-cubes for d > 1); ``tall_thin`` is
    the adversarial shape whose dim 0 matches every pair (requires d ≥ 2 —
    see :func:`repro_torch.core.intervals.make_tall_thin_workload`).
    """
    kw = dict(alpha=alpha, length=length, d=d, generator=generator,
              device=device)
    if name == "uniform":
        return make_uniform_workload(n_sub, n_upd, **kw)
    if name == "clustered":
        return make_clustered_workload(n_sub, n_upd, **kw)
    if name == "tall_thin":
        return make_tall_thin_workload(n_sub, n_upd, **kw)
    raise ValidationError(f"unknown DDM workload {name!r} "
                          f"(choose from {DDM_WORKLOADS})")
