"""MoE combine: device ms a wave between the CUDA events of the program's
``moe.combine`` span (each record's expert output gathered back, times
its gate, a token's records summed), summed over the layers."""
from gpubench.lib import program


def read(run):
    return program.device_ms_a_wave(run, "moe.combine")
