"""The SSD's exchange between chunks: host calls that put work on the
device (kernel launches, copies, fills; ``lib.program.LAUNCH_CALLS``)
begun inside the program's ``mamba.scan`` spans (the loop over the
chunks), a wave."""
from gpubench.lib import program


def read(run):
    scans = program.host_ranges(run, "mamba.scan")
    waves = len(run.record["waves"])
    if not run.trace.device or not scans or waves == 0:
        return None
    return program.launches_in(run, program.union(scans)) / waves
