"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
command runs one cell of ``BENCHMARK.json`` once (see ``README.md``)."""
