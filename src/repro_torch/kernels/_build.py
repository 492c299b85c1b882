"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Every source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` — one
``nvcc`` process per source, all started together — and the objects link
into ONE shared library with a plain C interface, loaded through
``ctypes``.  No source includes PyTorch's headers, so a cold build takes
seconds.  The library lands in ``build/repro_torch/`` at the repository
root (``REPRO_TORCH_BUILD_DIR`` overrides it) and is rebuilt whenever the
sources or flags change (a content hash is kept beside it).

Wrappers pass tensor pointers and the current stream as ``c_void_p``; each
C entry point returns ``cudaGetLastError()`` after its launches and
:func:`check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

__all__ = ["library", "check", "check_aligned", "refuse_grad",
           "build_seconds", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: C signatures of the entry points (see the ``extern "C"`` functions).
_SIGNATURES = {
    "price_grid_launch": [_I] * 7 + [_P] * 16,
    "profile_grid_launch": [_P] * 5 + [_I] * 7 + [_LL, _P, _P, _P, _P],
    "flash_attention_launch": [_I] * 8 + ([_P] + [_LL] * 3) * 3 + [_P, _P],
    "decode_attention_launch": [_I] * 9 + [_P, _LL, _LL] + [_P] + [_LL] * 3
                               + [_P] + [_LL] * 3 + [_P, _P, _P, _P],
    "che_sums_launch": [_P, _LL, _P, _I, _I] + [_P] * 4,
    "che_solve_setup": [_P],
    "che_solve_launch": [_P, _I, _F, _P, _P] + [_I] * 5 + [_P] * 3,
}

_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build (or cache check) took in this process.
build_seconds: float = 0.0


def _build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    tmp = out.parent / f".objs-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in SOURCES:                       # one nvcc per source, together
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    staged = tmp / out.name
    link = subprocess.run(
        [nvcc, "-shared", *_FLAGS, *map(str, objs), "-o", str(staged)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(staged, out)                   # atomic: readers never see half
    shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libkernels.so"
    stamp = out_dir / "libkernels.sha256"
    digest = _digest()
    if not (lib_path.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        _compile(lib_path)
        stamp.write_text(digest + "\n")
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} at launch ({msg})")


def check_aligned(kernel: str, name: str, t) -> None:
    """Raise unless ``t`` can be read in 16-byte vectors along its last
    dim: a 16-byte-aligned base and the stride of every other dim longer
    than 1 a multiple of 16 bytes (the kernels' ``cp.async`` and ``uint4``
    loads need both)."""
    size = t.element_size()
    if t.data_ptr() % 16 or any(
            st * size % 16 for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1):
        raise ValueError(
            f"{kernel}: {name} must have a 16-byte-aligned base and strides "
            f"that are multiples of 16 bytes for the kernel's vector loads, "
            f"got base % 16 = {t.data_ptr() % 16}, strides {t.stride()} of "
            f"{size}-byte elements")


def refuse_dtensor(kernel: str, *tensors) -> None:
    """Raise on DTensor inputs: the kernels take a device's local tensors,
    and running them on a mesh is not ported (no JAX path calls its
    Pallas kernels under a mesh: training and the dry run use
    ``attn_impl="blockwise"``)."""
    from repro_torch.distributed.sharding import is_dtensor
    if any(is_dtensor(t) for t in tensors):
        raise ValueError(
            f"{kernel} takes local tensors, not DTensors: on a mesh use "
            f"attn_impl='blockwise' or 'dense'")


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise, on every device, when autograd would need ``kernel``'s
    backward: grad mode is on and an input requires grad.  No attention
    kernel has a backward, in this package or in the JAX package (whose
    gradient through its Pallas flash kernel fails in the transpose), so
    training takes ``attn_impl="blockwise"``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward kernel (neither has the JAX "
            f"package's Pallas kernel); train with attn_impl='blockwise', "
            f"or call it under torch.no_grad()")
