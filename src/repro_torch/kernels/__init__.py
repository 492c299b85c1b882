"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``price_grid`` — the fused PriceTable solve (``csrc/price_grid.cu``);
* ``profile_grid`` — mixed-eps page occupancy (``csrc/profile_grid.cu``);
* ``che_solver`` — multi-candidate Che sums (``csrc/che_sums.cu``) and the
  K-way solver, every pass and the hit rate in one launch
  (``csrc/che_solve.cu``);
* ``flash_attention`` — prefill attention (``csrc/flash_attention.cu``);
* ``decode_attention`` — one-token decode attention
  (``csrc/decode_attention.cu``).

Each wrapper runs its plain PyTorch version (``ref`` for the attention and
Che kernels) on CPU tensors and launches its kernel on CUDA tensors;
``_build`` compiles ``csrc/`` with ``nvcc`` at the first launch.  ``ops``
gathers the attention and Che entry points.
"""
