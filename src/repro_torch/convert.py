"""Carry state across from the JAX package as plain arrays.

* CAM's "weights" are its capacity-independent profiles
  (:class:`repro_torch.core.session.GridProfiles`).  :func:`grid_profiles`
  rebuilds one on a torch device from numpy arrays and plain fields — what
  a JAX ``GridProfiles`` holds, read out with ``np.asarray`` — so the same
  profiles can be priced by both engines.
* A language model's weights are a nested dict of arrays.
  :func:`params_from_jax` maps the JAX ``init_params`` pytree, read out as
  numpy, onto the port's dict: the same keys and the same layer-stacked
  layout.

Nothing here imports ``repro``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, GridProfiles,
                                      SkippedCandidate, SortedScanPart,
                                      WriteStreamPart, resolve_torch_device)

__all__ = ["grid_profiles", "params_from_jax"]


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def _sorted_part(part: Optional[Mapping], device) -> Optional[SortedScanPart]:
    if part is None:
        return None
    cov = part.get("coverage")
    return SortedScanPart(
        total_refs=float(part["total_refs"]),
        distinct_pages=float(part["distinct_pages"]),
        min_capacity=int(part.get("min_capacity", 1)),
        coverage=None if cov is None else _tensor(cov, device),
        pinned_retouches=float(part.get("pinned_retouches", 0.0)))


def _write_part(part: Optional[Mapping], device) -> Optional[WriteStreamPart]:
    if part is None:
        return None
    return WriteStreamPart(counts=_tensor(part["counts"], device),
                           total_refs=float(part["total_refs"]))


def grid_profiles(*, knobs: Sequence, counts, totals, dacs, sizes, caps,
                  scale: float, n_queries: int,
                  sparts: Sequence[Optional[Mapping]] = (),
                  wparts: Sequence[Optional[Mapping]] = (),
                  skipped: Sequence = (),
                  device=DEFAULT_TORCH_DEVICE) -> GridProfiles:
    """A :class:`GridProfiles` on ``device`` from numpy arrays.

    ``counts`` is the (K, P) IRM histogram matrix; ``totals``, ``dacs``,
    ``sizes`` and ``caps`` are (K,) arrays.  Each entry of ``sparts`` is
    ``None`` or a mapping with ``total_refs``, ``distinct_pages``,
    ``min_capacity``, ``coverage`` ((P,) array or ``None``) and
    ``pinned_retouches``; each entry of ``wparts`` is ``None`` or a mapping
    with ``counts`` ((P,) array) and ``total_refs``.  ``skipped`` holds
    ``(knob, reason)`` pairs.  Empty ``sparts`` means no sorted parts.
    """
    dev = resolve_torch_device(device)
    k = len(knobs)
    sp = tuple(sparts) if sparts else (None,) * k
    return GridProfiles(
        knobs=tuple(knobs),
        counts=_tensor(counts, dev),
        totals=np.asarray(totals, np.float64),
        dacs=np.asarray(dacs, np.float64),
        sizes=np.asarray(sizes, np.float64),
        caps=np.asarray(caps, np.int64),
        sparts=tuple(_sorted_part(p, dev) for p in sp),
        skipped=tuple(SkippedCandidate(kn, str(r)) for kn, r in skipped),
        scale=float(scale),
        n_queries=int(n_queries),
        wparts=tuple(_write_part(p, dev) for p in wparts)
        if any(p is not None for p in wparts) else ())


def params_from_jax(tree, device=DEFAULT_TORCH_DEVICE, dtype=None):
    """The port's parameter dict from a JAX parameter pytree of numpy arrays.

    ``tree`` is a nested dict (``jax.tree.map(np.asarray, params)``); each
    leaf becomes a float32 tensor on ``device``, or a ``dtype`` one when
    given (bfloat16 leaves widen to float32 and cast back exactly).
    """
    dev = resolve_torch_device(device)

    def leaf(a):
        t = torch.as_tensor(np.array(a, np.float32), device=dev)
        return t if dtype is None else t.to(dtype)

    return {k: params_from_jax(v, dev, dtype) if isinstance(v, Mapping)
            else leaf(v) for k, v in tree.items()}
