"""Serving engine's idle: device ms a wave in which no kernel, copy or
fill ran while the host was inside the program's ``serve.wave`` span and
outside its ``serve.prefill`` (the profiler's host ranges of the spans
against the busy union of the device's events; admission, token upload,
cache set-up, the argmax and its sync).  In the traced run the harness
syncs at the prefill's end, so the prefill's own device work lies inside
``serve.prefill``."""
from gpubench.lib import program


def read(run):
    waves = program.host_ranges(run, "serve.wave")
    if not run.trace.device or not waves:
        return None
    region = program.subtract(
        program.union(waves),
        program.union(program.host_ranges(run, "serve.prefill")))
    return program.device_idle_ns(run, region) / 1e6 / len(waves)
