"""repro_torch.analysis — the runtime lock-discipline audit
(:mod:`repro_torch.analysis.lockcheck`) behind ``Broker(debug_locks=True)``.

The static checker (``python -m repro.analysis.check``) is the repo's and
scans this package as well; it is not duplicated here.
"""
