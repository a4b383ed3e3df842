"""Engine conformance harness of the port.

* :mod:`repro_torch.testing.oracles` — the reference pair sets.
* :mod:`repro_torch.testing.conformance` — the engine registry and the
  differential checks; every pair-producing path of the port registers
  there.
"""

__all__ = ["conformance", "oracles"]
