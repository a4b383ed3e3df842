"""MoE dispatch: device time a wave in the dispatch class (sort and
searchsorted, gathers, scatters, index kernels; ``lib.names``), in ms."""
from gpubench.lib.names import is_dispatch


def read(run):
    waves = len(run.record["waves"])
    t = run.trace.device_seconds(is_dispatch)
    if waves == 0 or t == 0.0:
        return None
    return 1e3 * t / waves
