"""Hand-written CUDA kernels (``csrc/``), their wrappers (``sbm_sweep`` for
the sweep, ``bitmatch`` for the d-dim bit-matrix AND), their plain PyTorch
versions (``ref``) and the entry points over them (``ops``)."""
from repro_torch.kernels.ops import (
    sbm_count_kernel,
    sbm_delta_bitmasks,
    sbm_enumerate_kernel,
)
from repro_torch.kernels.bitmatch import bitmatrix_kernel, sbm_bitmatrix_kernel

__all__ = ["sbm_count_kernel", "sbm_delta_bitmasks", "sbm_enumerate_kernel",
           "bitmatrix_kernel", "sbm_bitmatrix_kernel"]
