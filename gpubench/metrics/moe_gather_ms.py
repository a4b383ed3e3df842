"""MoE gather: device ms a wave between the CUDA events of the program's
``moe.gather`` span (the tokens gathered into the expert bins), summed
over the layers."""
from gpubench.lib import program


def read(run):
    return program.device_ms_a_wave(run, "moe.gather")
