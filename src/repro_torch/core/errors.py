"""Exception hierarchy of the PyTorch port.

The same class names and the same double inheritance as the JAX package's
hierarchy, so that ``except ValueError`` / ``except RuntimeError`` callers
of either package keep working: :class:`ValidationError` is-a
``ValueError``, :class:`CapacityError` is-a ``RuntimeError``, and so on.
:class:`KernelError` is the port's own addition: a CUDA kernel that was
refused at launch or failed to build.

This module is stdlib-only; it sits below every other layer of the port.
"""
from __future__ import annotations


class DDMError(Exception):
    """Base of every deliberate failure raised by the DDM system."""


class ValidationError(DDMError, ValueError):
    """A request violated the service-boundary contract before any state
    changed: malformed region bounds (``lo > hi``, wrong length, NaN),
    rid misuse (negative, repeated within one batch, re-add of a live
    rid), unknown sides, illegal pending-queue compositions, or a tensor
    of the wrong device, type or shape handed to a kernel wrapper."""


class CapacityError(DDMError, RuntimeError):
    """An enumeration cannot fit its policy's capacity bounds: either the
    required pair buffer exceeds a ``hard_cap`` or the count-then-retry
    loop failed to converge (:mod:`repro_torch.core.runtime`)."""


class GridOverflowError(DDMError, RuntimeError):
    """``grid_count(strict=True)``: a cell overflowed ``cap`` — the count
    would be a silent lower bound."""


class OverloadError(DDMError, RuntimeError):
    """Admission control refused a mutation (bounded queue full, request
    shed, or a blocked producer timed out)."""


class DeadlineExceeded(DDMError, TimeoutError):
    """A queued mutation's deadline passed before a flush applied it."""


class KernelError(DDMError, RuntimeError):
    """A hand-written CUDA kernel failed to build, or its launch returned
    a CUDA error (``cudaGetLastError() != 0``)."""


class CheckpointError(DDMError, RuntimeError):
    """An asynchronous checkpoint write failed (raised, with the write's
    exception as its cause, by the next ``save`` or ``wait``)."""


__all__ = [
    "DDMError",
    "ValidationError",
    "CapacityError",
    "GridOverflowError",
    "OverloadError",
    "DeadlineExceeded",
    "KernelError",
    "CheckpointError",
]
