"""The monoid scan's launches: host calls that put work on the device
(kernel launches, copies, fills; ``lib.program.LAUNCH_CALLS``) begun
inside the program's ``sweep.scan`` spans (Algorithm 6's exclusive scan
of both sides' delta words), a match."""
from gpubench.lib import program


def read(run):
    scans = program.host_ranges(run, "sweep.scan")
    matches = len(run.record["matches"])
    if not run.trace.device or not scans or matches == 0:
        return None
    return program.launches_in(run, program.union(scans)) / matches
