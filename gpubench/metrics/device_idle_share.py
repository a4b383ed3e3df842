"""Device idle share of the measured window (``device_idle_share.serve``
and ``device_idle_share.ddm``): the share of the traced window in which
no kernel, copy or fill ran on the card, in %."""


def read(run):
    return 100.0 * run.trace.idle_share()
