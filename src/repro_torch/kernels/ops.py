"""Public entry points of the attention and Che kernels.

Mirrors ``repro/kernels/ops.py``.  Each function dispatches on its tensors'
device, as every kernel wrapper of the port does: CPU tensors take the
plain PyTorch version, CUDA tensors launch the hand-written kernel or
raise.  The JAX wrappers' ``block_*`` and ``interpret`` arguments were the
Pallas tiling and its CPU emulation; they have no counterpart here.
"""
from __future__ import annotations

from repro_torch.kernels.che_solver import che_solve, che_sums
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["flash_attention", "decode_attention", "che_sums", "che_solve"]
