"""Multi-candidate Che-consistency evaluator and its K-way solver.

Replaces the Pallas kernel ``repro/kernels/che_solver.py::che_sums`` and
the jitted solver around it, ``che_solve``.  Che's approximation for LRU
needs the characteristic time T with C = sum_i (1 - exp(-p_i T));
``che_sums`` evaluates that sum for K candidate times in one pass over the
probabilities, so each pass of ``che_solve`` cuts the (log-space) bracket
by (K + 1)x instead of 2x.

* :func:`repro_torch.kernels.ref.che_sums_ref` and
  :func:`repro_torch.kernels.ref.che_solve_ref` (the host loop of
  ``iters`` ``che_sums_ref`` passes) are the plain PyTorch versions: the
  CPU path and the card-side yardstick;
* :func:`che_sums` is the evaluator's wrapper: CPU tensors take the plain
  version, CUDA tensors launch ``csrc/che_sums.cu`` (per-block partial
  sums, the last block to finish adds them in block order: one launch) or
  raise.  ``launches`` counts its launches;
* :func:`che_solve` and :func:`che_hit_rate` are the solver's wrappers:
  CPU tensors take ``che_solve_ref``, CUDA tensors launch
  ``csrc/che_solve.cu`` — the whole solve, every pass and the hit rate
  ``sum_i p_i (1 - exp(-p_i T))``, in ONE cooperative launch of one block
  per SM (:func:`solve_plan`) — or raise.  ``solve_launches`` counts
  those launches.

What bounds the kernels on the H100: 4 bytes and K ``expm1f`` per
probability a pass.  At the CAM main path's ~10^5 pages a ``che_sums``
call is launch bound, and so was the host loop of 16 of them with ~12
small ops a pass that ``che_solve`` replaces; the fused solve is bound by
its grid barrier and the partials' round trip through L2, once a pass.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import che_solve_ref, che_sums_ref

__all__ = ["che_sums", "che_sums_ref", "che_solve", "che_solve_ref",
           "che_hit_rate", "solve_plan", "SolvePlan", "launches",
           "solve_launches"]

#: ``che_sums`` kernel launches (not plain-version calls) since import.
launches = 0
#: ``che_solve`` kernel launches (one a solve) since import.
solve_launches = 0

_THREADS = 256
_MAX_K = 16
_BLOCKS_PER_SM = 4
_SOLVE_THREADS = 512     # a block of the fused solve (che_solve.cu)
_STAGE_MAX = 24_576      # probabilities a block stages (96 KiB, che_solve.cu)

_scratch: dict = {}      # (device index, stream) -> (partials, ticket)
_grids: dict = {}        # device index -> blocks of a solve's grid


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
    return _sums_launch(probs, t_candidates)


def _sums_launch(probs, t):
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
    dev = p.device
    lib = _build.library()
    with torch.cuda.device(dev):
        stream, partials, ticket = _stream_scratch(dev)
        max_blocks = partials.shape[0] // _MAX_K
        blocks = max(1, min(-(-n // _THREADS), max_blocks))
        out = torch.empty((k,), dtype=torch.float32, device=dev)
        code = lib.che_sums_launch(p.data_ptr(), n, tt.data_ptr(), k, blocks,
                                   partials.data_ptr(), ticket.data_ptr(),
                                   out.data_ptr(), stream)
    _build.check(code, "che_sums")
    launches += 1
    return out


def _stream_scratch(dev):
    """(stream, float32 partials, int32 ticket) of the current stream of
    ``dev``, made at its first use.  Kernels on one stream never overlap,
    so ``che_sums`` (4 blocks an SM, K <= 16 partials each) and the fused
    solve (2 buffers of one row per SM) share its partials; calls that
    overlap on two streams must not share a ticket or partials."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch.get((dev.index, stream))
    if scratch is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        scratch = _scratch[(dev.index, stream)] = (
            torch.empty((_BLOCKS_PER_SM * sms * _MAX_K,),
                        dtype=torch.float32, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))
    return (stream,) + scratch


@dataclasses.dataclass(frozen=True)
class SolvePlan:
    """Launch shape of one fused solve: ``blocks`` blocks of ``threads``
    threads, block r taking probabilities ``[r * slice, (r + 1) * slice)``
    (clipped to N) and staging the first ``staged`` of them in shared
    memory; the rest of a longer slice is read from device memory on every
    pass."""
    blocks: int
    threads: int
    slice: int
    staged: int

    @property
    def spilled(self) -> bool:
        return self.slice > self.staged

    @property
    def smem_bytes(self) -> int:
        return 4 * self.staged


@functools.lru_cache(maxsize=None)
def solve_plan(n: int, blocks: int) -> SolvePlan:
    """The fused solve's launch plan for N probabilities over a grid of
    ``blocks`` blocks (one per SM of the card: 132 on an H100 SXM)."""
    if n < 1 or blocks < 1:
        raise ValueError(f"solve_plan: N >= 1 and blocks >= 1 expected, "
                         f"got N={n}, blocks={blocks}")
    piece = -(-n // blocks)
    return SolvePlan(blocks, _SOLVE_THREADS, piece, min(piece, _STAGE_MAX))


@functools.lru_cache(maxsize=None)
def _fracs(k: int):
    """(j + 1) / (k + 1) for j < k, rounded to float32 as the plain loop's
    ``arange / (k + 1)`` rounds them, as a C array."""
    vals = (torch.arange(1, k + 1, dtype=torch.float32) / (k + 1)).tolist()
    return (ctypes.c_float * k)(*vals)


def che_solve(probs, capacity, *, k: int = 8, iters: int = 20):
    """Solve C = sum_i (1 - exp(-p_i T)) by K-way interval subdivision.

    Each of ``iters`` passes shrinks the log-space bracket by (K+1)x with
    one pass over ``probs``; float32 throughout, as JAX.  probs: (N,);
    ``capacity`` a number or a one-element tensor; 1 <= k <= 16.  Returns
    T as a 0-dim float32 tensor on ``probs``' device.
    """
    return _solve(probs, capacity, k, iters, hit_rate=False)[0]


def che_hit_rate(probs, capacity, *, k: int = 8, iters: int = 16):
    """(T, h): :func:`che_solve`'s T and the LRU hit rate
    ``h = sum_i p_i (1 - exp(-p_i T))`` at it, both 0-dim float32 tensors
    on ``probs``' device.  On a CUDA tensor both come from the same single
    launch."""
    return _solve(probs, capacity, k, iters, hit_rate=True)


def _solve(probs, capacity, k, iters, *, hit_rate):
    if probs.dim() != 1:
        raise ValueError(f"che_solve: probs (N,) expected, got "
                         f"{tuple(probs.shape)}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"che_solve takes 1 to {_MAX_K} candidates a "
                         f"pass, got k={k}")
    if iters < 0:
        raise ValueError(f"che_solve: iters >= 0 expected, got {iters}")
    if probs.shape[0] < 1:
        raise ValueError("che_solve: probs holds no page")
    if probs.device.type == "cpu":
        p = probs.float()
        t = che_solve_ref(p, capacity, k=k, iters=iters)
        h = torch.sum(p * -torch.expm1(-p * t)) if hit_rate else None
        return t, h
    if probs.device.type != "cuda":
        raise ValueError(f"che_solve runs on CPU or CUDA tensors, got "
                         f"{probs.device}")
    out = _solve_launch(probs, capacity, k, iters)
    return out[0], out[1]


def _solve_launch(probs, capacity, k, iters):
    global solve_launches
    p = probs.float().contiguous()
    n = p.shape[0]
    if n >= 2**31:
        raise ValueError(f"che_solve kernel takes fewer than 2**31 "
                         f"probabilities, got {n}")
    dev = p.device
    cap_val, cap_t = 0.0, None
    if isinstance(capacity, torch.Tensor) and capacity.device.type != "cpu":
        if capacity.numel() != 1 or capacity.device != dev:
            raise ValueError(f"che_solve: a capacity tensor must hold one "
                             f"value on {dev}, got shape "
                             f"{tuple(capacity.shape)} on {capacity.device}")
        cap_t = capacity.reshape(()).float()    # read by the kernel: no sync
    else:
        cap_val = float(capacity)
    lib = _build.library()
    with torch.cuda.device(dev):
        blocks = _grids.get(dev.index)
        if blocks is None:
            got = ctypes.c_int(0)
            _build.check(lib.che_solve_setup(ctypes.byref(got)),
                         "che_solve setup")
            if got.value == 0:
                raise RuntimeError("che_solve: this card takes no "
                                   "cooperative launch of one block per SM")
            blocks = _grids[dev.index] = got.value
        plan = solve_plan(n, blocks)
        stream, partials, _ = _stream_scratch(dev)
        out = torch.empty((2,), dtype=torch.float32, device=dev)
        code = lib.che_solve_launch(
            p.data_ptr(), n, cap_val,
            None if cap_t is None else cap_t.data_ptr(), _fracs(k), k, iters,
            plan.blocks, plan.slice, plan.staged, partials.data_ptr(),
            out.data_ptr(), stream)
    _build.check(code, "che_solve")
    solve_launches += 1
    return out
