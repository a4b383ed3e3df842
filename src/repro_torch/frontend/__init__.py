"""repro_torch.frontend — the concurrent multi-tenant DDM frontend.

Public surface:
  Broker, BrokerSession      — named DDMService sessions behind a
                               thread-safe coalescing boundary
  AdmissionPolicy            — bounded queues: block / reject / shed_oldest
  DegradePolicy, CountResult — graceful read degradation (exact=False)
  Ticket                     — per-mutation future, resolved at flush
  replay_journal             — single-threaded zero-loss verification
"""
from repro_torch.frontend.broker import (
    AdmissionPolicy,
    Broker,
    BrokerSession,
    CountResult,
    DegradePolicy,
    Ticket,
    replay_journal,
)

__all__ = [
    "AdmissionPolicy",
    "Broker",
    "BrokerSession",
    "CountResult",
    "DegradePolicy",
    "Ticket",
    "replay_journal",
]
