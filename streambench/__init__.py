"""The benchmark of the PyTorch and CUDA port (``tpustream_torch``):
see ``README.md`` and ``BENCHMARK.json`` at the root of the checkout."""
