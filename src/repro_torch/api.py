"""repro_torch.api — the public surface of the port: the JAX package's
``repro.api`` name for name, plus :class:`KernelError`.

* :class:`DDMService` — the single-tenant service (any d >= 1) with the
  unified mutation surface: ``register(side, lo, hi)``, ``move(side, rids,
  lo, hi)``, ``unregister(side, rids)`` (each a scalar region or a block),
  plus ``flush`` / ``pairs`` / ``match_count`` / ``stats``.
* :class:`Broker` and friends — the concurrent multi-tenant frontend:
  bounded admission queues, per-op deadlines, degraded reads.
* The exception hierarchy rooted at :class:`DDMError` — one ``except``
  clause catches everything the port raises on purpose; :class:`KernelError`
  is a CUDA kernel that failed to build or launch.
* The engine registry — :func:`register_engine` a :class:`MatchEngine` and
  every conformance check picks it up.

Entry points run on ``cuda`` unless given ``device="cpu"`` (the broker's
sessions through ``Broker.create_session(..., device="cpu")``, a journal
replay through ``replay_journal(..., device="cpu")``); the registry's
engines run on their inputs' device.
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
from repro_torch.frontend.broker import (
    AdmissionPolicy,
    Broker,
    BrokerSession,
    CountResult,
    DegradePolicy,
    Ticket,
    replay_journal,
)
from repro_torch.testing.conformance import (
    MatchEngine,
    all_engines,
    engines_for,
    get_engine,
)
from repro_torch.testing.conformance import register as register_engine

__all__ = [
    # services
    "DDMService",
    "Broker",
    "BrokerSession",
    "AdmissionPolicy",
    "DegradePolicy",
    "CountResult",
    "Ticket",
    "replay_journal",
    # errors
    "DDMError",
    "ValidationError",
    "CapacityError",
    "GridOverflowError",
    "OverloadError",
    "DeadlineExceeded",
    # engine registry
    "MatchEngine",
    "register_engine",
    "all_engines",
    "engines_for",
    "get_engine",
    # the port's own
    "KernelError",
]
