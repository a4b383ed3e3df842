"""Classes of device kernels by name (substrings of the profiler's kernel
names), copied from the port's ``chip_smoke.py``."""

# cuBLAS / CUTLASS matrix-product kernels
MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# the MoE dispatch: sort (and searchsorted), the gathers into the expert
# bins and the scatters (bins, combine); the embedding lookup's index
# kernel lands here too
DISPATCH_NAMES = ("sort", "gather", "scatter", "index")
# the port's hand-written kernels (csrc/*.cu)
FLASH_NAME = "flash_attention_fwd"
PASS_C_NAME = "emit_pairs_kernel"


def is_dispatch(name: str) -> bool:
    low = name.lower()
    return (not any(w in low for w in MATMUL_NAMES)
            and FLASH_NAME not in low
            and any(w in low for w in DISPATCH_NAMES))
