"""Multi-candidate Che-consistency evaluator and its K-way solver.

Replaces the Pallas kernel ``repro/kernels/che_solver.py::che_sums`` and
ports the solver loop around it, ``che_solve``.  Che's approximation for
LRU needs the characteristic time T with C = sum_i (1 - exp(-p_i T));
``che_sums`` evaluates that sum for K candidate times in one pass over the
probabilities, so each pass of ``che_solve`` cuts the (log-space) bracket
by (K + 1)x instead of 2x.

* :func:`repro_torch.kernels.ref.che_sums_ref` is the plain PyTorch version
  (the CPU path and the card-side yardstick);
* :func:`che_sums` is the wrapper: CPU tensors take the plain version, CUDA
  tensors launch ``csrc/che_sums.cu`` (per-block partial sums in a
  grid-stride pass, then one ordered reduction of the partials) or raise.
  ``launches`` counts kernel launches;
* :func:`che_solve` is the host loop of ``iters`` subdivision passes, all
  on the probabilities' device with no host round trip.

What bounds ``che_sums`` on the H100: 4 bytes and K ``expm1f`` per
probability; at the CAM main path's ~10^5 pages a call is launch bound.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import che_sums_ref

__all__ = ["che_sums", "che_sums_ref", "che_solve", "launches"]

#: Kernel launches (not plain-version calls) since import.
launches = 0

_THREADS = 256
_MAX_K = 16
_BLOCKS_PER_SM = 4


def che_sums(probs, t_candidates):
    """sum_i (1 - exp(-p_i * t_k)) for each of K candidates, one pass.

    probs: (N,) float32; t_candidates: (K,). Returns (K,) float32.
    """
    if probs.dim() != 1 or t_candidates.dim() != 1:
        raise ValueError(f"che_sums: probs (N,) and t_candidates (K,) "
                         f"expected, got {tuple(probs.shape)}, "
                         f"{tuple(t_candidates.shape)}")
    if probs.device.type == "cpu":
        return che_sums_ref(probs, t_candidates)
    if probs.device.type != "cuda":
        raise ValueError(f"che_sums runs on CPU or CUDA tensors, got "
                         f"{probs.device}")
    return _launch(probs, t_candidates)


def _launch(probs, t):
    global launches
    k = t.shape[0]
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"che_sums kernel takes 1 to {_MAX_K} candidates, "
                         f"got {k}")
    if t.device != probs.device:
        raise ValueError(f"che_sums: t_candidates on {t.device}, probs on "
                         f"{probs.device}")
    p = probs.float().contiguous()
    tt = t.float().contiguous()
    n = p.shape[0]
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    blocks = max(1, min(-(-n // _THREADS), _BLOCKS_PER_SM * sms))
    partial = torch.empty((blocks, k), dtype=torch.float32, device=p.device)
    out = torch.empty((k,), dtype=torch.float32, device=p.device)
    lib = _build.library()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        code = lib.che_sums_launch(p.data_ptr(), n, tt.data_ptr(), k, blocks,
                                   partial.data_ptr(), out.data_ptr(), stream)
    _build.check(code, "che_sums")
    launches += 1
    return out


def che_solve(probs, capacity, *, k: int = 8, iters: int = 20):
    """Solve C = sum_i (1 - exp(-p_i T)) by K-way interval subdivision.

    Each iteration shrinks the log-space bracket by (K+1)x with ONE
    :func:`che_sums` pass over ``probs``.  Float32 throughout, as JAX.
    Returns T as a 0-dim float32 tensor on ``probs``' device.
    """
    probs = probs.float()
    # host scalars stay on the host (a 0-dim CPU tensor enters CUDA ops as a
    # scalar), so the solve queues its launches without a blocking copy
    capacity = torch.as_tensor(capacity, dtype=torch.float32)
    pmin = torch.clamp(torch.amin(torch.where(probs > 0, probs,
                                              float("inf"))), min=1e-30)
    hi0 = torch.clamp(4.0 * capacity / pmin, min=1.0)
    # the bracket can span 20+ orders of magnitude (pmin is tiny for zipf
    # popularity), so subdivide in log space
    lo0 = hi0 * 1e-30
    log_lo, log_hi = torch.log(lo0), torch.log(hi0)
    fracs = torch.arange(1, k + 1, dtype=torch.float32,
                         device=probs.device) / (k + 1)
    for _ in range(iters):
        log_ts = log_lo + (log_hi - log_lo) * fracs
        sums = che_sums(probs, torch.exp(log_ts))
        # rightmost candidate still below C bounds the solution from the left
        idx = torch.sum(sums < capacity).reshape(1)           # in [0, K]
        grid_pts = torch.cat([log_lo[None], log_ts, log_hi[None]])
        log_lo = grid_pts.index_select(0, idx)[0]
        log_hi = grid_pts.index_select(0, idx + 1)[0]
    return torch.exp(0.5 * (log_lo + log_hi))
