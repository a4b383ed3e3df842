"""Hand-written CUDA kernels for the sweep (``csrc/``), their wrappers
(``sbm_sweep``), their plain PyTorch versions (``ref``) and the entry points
over them (``ops``)."""
from repro_torch.kernels.ops import (
    sbm_count_kernel,
    sbm_delta_bitmasks,
    sbm_enumerate_kernel,
)

__all__ = ["sbm_count_kernel", "sbm_delta_bitmasks", "sbm_enumerate_kernel"]
