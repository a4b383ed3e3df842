"""repro_torch.api — the public surface of the port.

* :class:`DDMService` — the single-tenant service (d = 1) with the unified
  mutation surface: ``register(side, lo, hi)``, ``move(side, rids, lo,
  hi)``, ``unregister(side, rids)`` (each a scalar region or a block), plus
  ``flush`` / ``pairs`` / ``match_count`` / ``stats``.
* The exception hierarchy rooted at :class:`DDMError`.

The multi-tenant ``Broker`` and the engine registry are not ported yet.
"""
from __future__ import annotations

from repro_torch.core.errors import (
    CapacityError,
    DDMError,
    DeadlineExceeded,
    GridOverflowError,
    KernelError,
    OverloadError,
    ValidationError,
)
from repro_torch.core.service import DDMService

__all__ = [
    # services
    "DDMService",
    # errors
    "DDMError",
    "ValidationError",
    "CapacityError",
    "GridOverflowError",
    "OverloadError",
    "DeadlineExceeded",
    "KernelError",
]
