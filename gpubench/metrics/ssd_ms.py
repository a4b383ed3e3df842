"""Mamba-2's SSD: device ms a wave between the CUDA events of the
program's ``mamba.ssd`` span (the whole chunked state-space scan: the
quadratic part inside each chunk, the chunks' states and the exchange
between them), summed over the Mamba-2 layers."""
from gpubench.lib import program


def read(run):
    return program.device_ms_a_wave(run, "mamba.ssd")
