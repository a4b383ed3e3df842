"""The MoE's shared expert: device ms a wave between the CUDA events of
the program's ``moe.shared`` span (its SwiGLU over every token and the
add to the routed sum), summed over the layers."""
from gpubench.lib import program


def read(run):
    return program.device_ms_a_wave(run, "moe.shared")
