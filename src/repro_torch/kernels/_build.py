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

__all__ = ["library", "check", "build_seconds", "SOURCES"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
#: C signatures of the entry points (see the ``extern "C"`` functions).
_SIGNATURES = {
    "price_grid_launch": [_I] * 7 + [_P] * 15,
    "profile_grid_launch": [_P] * 4 + [_I] * 5 + [_LL, _P, _P, _I, _P],
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
