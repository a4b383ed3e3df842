"""Pass C's list path share: 100 × (1 − ``sweep.pass_c_fallback_blocks``
/ ``sweep.pass_c_blocks``) over the window, in %: the share of pass C's
blocks that answered their uppers from the per-segment sorted lists,
without the general path.  A port without those
counters gives nothing to read."""
from gpubench.lib import program


def read(run):
    got = program.window_records(run)
    if not run.trace.device or got is None:
        return None
    _, counts = got
    blocks = sum(c.value for c in counts if c.name == "sweep.pass_c_blocks")
    if blocks == 0:
        return None
    fallback = sum(c.value for c in counts
                   if c.name == "sweep.pass_c_fallback_blocks")
    return 100.0 * (1.0 - fallback / blocks)
