"""The monoid scan's idle: device ms a match in which no kernel, copy or
fill ran while the host was inside the program's ``sweep.scan`` span."""
from gpubench.lib import program


def read(run):
    scans = program.host_ranges(run, "sweep.scan")
    matches = len(run.record["matches"])
    if not run.trace.device or not scans or matches == 0:
        return None
    return program.device_idle_ns(run, program.union(scans)) / 1e6 / matches
