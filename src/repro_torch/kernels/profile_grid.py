"""Mixed-eps page occupancy of a candidate grid: the device half of profiling.

Replaces the Pallas kernel ``repro/kernels/profile_grid.py::profile_grid``
(body ``_occupancy_kernel``) and its wrapper
``point_page_refs_mixed_eps_grid``.  ``core/page_ref.py``'s host function
of the same name is the golden ``np.bincount`` kernel behind every RMI
branch-grid profile; this module computes the same histograms on the card,
where they are born as CUDA tensors and chain into the ``price_grid``
launch without visiting the host.

Queries are grouped by eps class exactly like the host path (the shared
``page_ref.mixed_eps_class_codes``), every class's Eq. 12 LUT is stacked
key-major and centered on the grid-wide max radius D,

    lut[c * C_ipp + s, d] = LUT_c[s, d - (D - D_c)]        (n_c * C_ipp, W)

and each query carries the combined key ``class * C_ipp + slot`` (-1 marks a
pad).  For one candidate row k the histogram is then

    out[k, page_q + d] += lut[key_kq, d]      for d in class band [D-D_c, D+D_c]

in the SAME padded ``(K, P + 2D)`` layout the host kernel accumulates into
(out-of-range window mass lands in the pad and is sliced off).

* :func:`profile_grid_ref` is the plain PyTorch version (a grouped
  ``scatter_add_``);
* :func:`profile_grid` is the wrapper: CPU tensors take the plain version,
  CUDA tensors launch ``csrc/profile_grid.cu`` or raise.  ``launches``
  counts kernel launches.

What bounds the kernel on the H100: one float64 ``atomicAdd`` per nonzero
(query, page) entry into an L2-resident histogram — contention on the hot
pages of a skewed workload, not bytes, sets its time.  The design keeps the
work to each query's own band (per-class band limits), reads the LUT
key-major (contiguous per thread) and stages it in shared memory when it
fits.  Both versions accumulate in float64 and round once to float32, as
the host kernel's float64 ``np.bincount`` does: a hot bin collects
thousands of fractional LUT entries, which float32 accumulation would leave
order-dependent at ~1e-6 relative.  Integer mass is exact.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import page_ref
from repro_torch.core.session import DEFAULT_TORCH_DEVICE, _np64

__all__ = ["profile_grid", "profile_grid_ref",
           "point_page_refs_mixed_eps_grid", "launches"]

#: Kernel launches (not plain-version calls) since import.
launches = 0

#: Max banded entries the plain version materializes at once.
_REF_CHUNK = 1 << 25


def profile_grid_ref(keys: torch.Tensor, pages: torch.Tensor,
                     lut: torch.Tensor, bands: torch.Tensor, *, c_ipp: int,
                     pad: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`profile_grid` (same arguments)."""
    k, q = keys.shape
    out = torch.zeros(k * pad, dtype=torch.float64, device=keys.device)
    k_idx, q_idx = torch.nonzero(keys >= 0, as_tuple=True)
    key = keys[k_idx, q_idx].long()
    base = k_idx * pad + pages.long()[q_idx]
    cls = key // c_ipp
    for ci in torch.unique(cls).tolist():
        sel = torch.nonzero(cls == ci, as_tuple=True)[0]
        lo, hi = (int(v) for v in bands[ci].tolist())
        d = torch.arange(lo, hi + 1, device=keys.device)
        chunk = max(1, _REF_CHUNK // d.numel())
        for a in range(0, sel.numel(), chunk):
            s = sel[a:a + chunk]
            vals = lut[key[s]][:, lo:hi + 1]
            out.scatter_add_(0, (base[s, None] + d).reshape(-1),
                             vals.reshape(-1).double())
    return out.reshape(k, pad).float()


def _launch(keys, pages, lut, bands, c_ipp, pad):
    global launches
    from repro_torch.kernels import _build

    k, q = keys.shape
    n_keys, width = lut.shape
    dev = keys.device
    for name, t, dtype in (("keys", keys, torch.int32),
                           ("pages", pages, torch.int32),
                           ("lut", lut, torch.float32),
                           ("bands", bands, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"profile_grid: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
    if pages.shape != (q,) or n_keys % c_ipp or \
            bands.shape != (n_keys // c_ipp, 2):
        raise ValueError("profile_grid: pages must be (Q,), lut "
                         "(n_classes * c_ipp, W) and bands (n_classes, 2)")
    # the kernel indexes the LUT by key and the histogram by page + band
    # row: keep both inside their buffers
    if q and k and (int(keys.min()) < -1 or int(keys.max()) >= n_keys
                    or int(pages.min()) < 0 or int(bands.min()) < 0
                    or int(bands.max()) >= width
                    or int(pages.max()) + int(bands.max()) >= pad):
        raise ValueError("profile_grid: keys, pages or bands out of range "
                         "for the LUT and the padded histogram")
    acc = torch.zeros((k, pad), dtype=torch.float64, device=dev)
    out = torch.empty((k, pad), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.profile_grid_launch(
            keys.data_ptr(), pages.data_ptr(), lut.data_ptr(),
            bands.data_ptr(), k, q, width, n_keys, c_ipp, pad,
            acc.data_ptr(), out.data_ptr(), sms, stream)
    _build.check(code, "profile_grid")
    launches += 1
    return out


def profile_grid(keys: torch.Tensor, pages: torch.Tensor, lut: torch.Tensor,
                 bands: torch.Tensor, *, c_ipp: int, pad: int
                 ) -> torch.Tensor:
    """Occupancy histograms of a whole candidate grid in one launch.

    Args:
      keys: (K, Q) int32 combined ``class * c_ipp + slot`` per query (per
        candidate row); padded queries carry -1.
      pages: (Q,) int32 shared query pages (any value where keys == -1).
      lut: (n_classes * c_ipp, W) float32 stacked per-class LUT rows,
        key-major, centered on the grid-wide max radius.
      bands: (n_classes, 2) int32 inclusive [lo, hi] band rows of each class
        (rows outside a class's band are zero).
      c_ipp: slots per page (the key's class is ``key // c_ipp``).
      pad: padded histogram width ``num_pages + 2 * max_radius``.

    Returns:
      (K, pad) float32 — the padded layout; callers slice
      ``[:, D : D + num_pages]``.  CPU tensors take
      :func:`profile_grid_ref`; CUDA tensors launch the kernel.
    """
    if keys.device.type == "cpu":
        return profile_grid_ref(keys, pages, lut, bands, c_ipp=c_ipp,
                                pad=pad)
    if keys.device.type != "cuda":
        raise ValueError(f"profile_grid runs on CPU or CUDA tensors, got "
                         f"{keys.device}")
    return _launch(keys, pages, lut, bands, c_ipp, pad)


def _lut_stack(class_eps, c_ipp: int, max_radius: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack per-class Eq. 12 LUTs key-major, centered on the max radius.

    Centering reproduces the host kernel's ``base + (D - D_c) + d'`` offset
    arithmetic: class c's width-``2*D_c+1`` band sits at columns
    ``[D - D_c, D + D_c]`` of the shared width-``2*D+1`` band, and all
    other columns are zero — so one uniform ``page + d`` target rule serves
    every class.  Returns ``(lut (n_c * C_ipp, 2D+1), bands (n_c, 2))``.
    """
    width = 2 * max_radius + 1
    stack = np.zeros((len(class_eps) * c_ipp, width), np.float32)
    bands = np.zeros((len(class_eps), 2), np.int32)
    for ci, eps in enumerate(class_eps):
        radius = page_ref.lut_radius(eps, c_ipp)
        off = max_radius - radius
        stack[ci * c_ipp:(ci + 1) * c_ipp, off:off + 2 * radius + 1] = \
            page_ref._point_lut_np(eps, c_ipp)
        bands[ci] = (off, off + 2 * radius)
    return stack, bands


def point_page_refs_mixed_eps_grid(
    positions: np.ndarray,
    eps_rows: np.ndarray,
    c_ipp: int,
    num_pages: int,
    *,
    device=DEFAULT_TORCH_DEVICE,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Device counterpart of ``page_ref.point_page_refs_mixed_eps_grid``.

    Same signature (plus the torch ``device``), same grouping (one shared
    class-code pass through ``page_ref.mixed_eps_class_codes``), same
    padded-accumulate-then-slice semantics — but the histograms are computed
    on ``device`` and RETURNED as a tensor there, so a caller chaining into
    the pricing kernel never round-trips them through the host.

    Returns (counts (K, num_pages) float32 tensor on ``device``, totals (K,)
    float64 host array).
    """
    positions = np.asarray(positions, np.int64)
    eps_rows = np.maximum(np.asarray(eps_rows, np.int64), 1)
    k, q_n = eps_rows.shape
    if positions.shape[0] != q_n:
        raise ValueError(f"eps_rows has {q_n} columns for "
                         f"{positions.shape[0]} positions")
    page = (positions // c_ipp).astype(np.int32)
    slot = (positions - page.astype(np.int64) * c_ipp).astype(np.int32)
    max_radius = page_ref.lut_radius(int(eps_rows.max()), c_ipp)
    pad = num_pages + 2 * max_radius

    codes, classes = page_ref.mixed_eps_class_codes(eps_rows.ravel())
    present = np.flatnonzero(np.bincount(codes))
    class_eps = [page_ref.mixed_eps_class_eps(c, classes) for c in present]
    # dense-rank the (possibly sparse) codes into lut row groups
    dense = np.searchsorted(present, codes.astype(np.int64)).astype(np.int32)
    keys = dense.reshape(k, q_n) * np.int32(c_ipp) + slot[None, :]
    lut, bands = _lut_stack(class_eps, c_ipp, max_radius)

    def up(a):
        return torch.as_tensor(a, device=device)

    padded = profile_grid(up(keys), up(page), up(lut), up(bands),
                          c_ipp=c_ipp, pad=pad)
    counts = padded[:, max_radius:max_radius + num_pages]
    return counts, _np64(torch.sum(counts, dim=1))
