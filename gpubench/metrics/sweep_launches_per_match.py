"""Planner and sweep: device events (kernels, copies, fills) a match in
the traced window."""


def read(run):
    matches = len(run.record["matches"])
    launches = run.trace.device_count()
    if matches == 0 or launches == 0:
        return None
    return launches / matches
