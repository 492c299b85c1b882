"""CAM on PyTorch and CUDA: the port of the ``repro`` package to an NVIDIA H100.

The layout mirrors ``repro`` module for module (``core``, ``index``,
``data``, ``engine``, ``kernels``, ``tuning``), so each module's JAX
counterpart sits at the same path.  The package imports ``torch`` and
numpy, never ``jax`` and never ``repro``.  Entry points run on the card
(``System.torch_device = "cuda"``) unless the caller asks for the CPU; the
hand-written CUDA kernels under ``kernels/csrc`` carry the profile and
price hot paths, and each has a plain PyTorch version beside it that CPU
tensors take.
"""
