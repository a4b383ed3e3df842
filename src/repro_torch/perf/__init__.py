"""Analytic cost models of the port (:mod:`repro_torch.perf.analytic`)."""
