"""Engine conformance harness of the port.

Submodules (import what you need — kept lazy here so importing
``repro_torch.testing`` stays cheap):

* :mod:`repro_torch.testing.oracles` — the reference pair sets.
* :mod:`repro_torch.testing.conformance` — the engine registry and the
  differential checks; every pair-producing path of the port registers
  there.
* :mod:`repro_torch.testing.metamorphic` — oracle-free invariance
  relations.
* :mod:`repro_torch.testing.shrink` — deterministic minimal-reproducer
  shrinking.
* :mod:`repro_torch.testing.fuzz` — the adversarial workload fuzzer / CLI
  (``python -m repro_torch.testing.fuzz --seeds N --engines all``), with
  :mod:`repro_torch.testing.threefry` behind two of its corpora.
"""

__all__ = ["conformance", "fuzz", "metamorphic", "oracles", "shrink"]
