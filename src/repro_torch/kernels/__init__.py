"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``price_grid`` — the fused PriceTable solve (``csrc/price_grid.cu``);
* ``profile_grid`` — mixed-eps page occupancy (``csrc/profile_grid.cu``).

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors; ``_build`` compiles ``csrc/`` with ``nvcc`` at the
first launch.
"""
