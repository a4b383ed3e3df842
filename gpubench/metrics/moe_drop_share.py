"""MoE drops: the program's counters ``moe.dropped`` over ``moe.records``
inside the window, in %: the share of (token, choice) records past their
expert's capacity, which leave the token's output without that expert."""
from gpubench.lib import program


def read(run):
    got = program.window_records(run)
    if not run.trace.device or got is None:
        return None
    _, counts = got
    records = sum(c.value for c in counts if c.name == "moe.records")
    dropped = sum(c.value for c in counts if c.name == "moe.dropped")
    if records == 0:
        return None
    return 100.0 * dropped / records
