"""Plain references: float32 PyTorch and NumPy, independent of the port
(they import neither ``jax``, nor ``repro``, nor ``repro_torch``)."""
