"""repro_torch — the PyTorch/CUDA port of the SBM-based DDM system.

A package beside ``repro`` (the JAX reference, which it never imports).
Its entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the kernels are hand-written CUDA for Hopper (``sm_90a``).
"""
