"""IndexModel adapters: one estimation surface over PGM, RMI and RadixSpline.

Each adapter exposes the :class:`repro_torch.core.session.IndexModel` protocol —
``size_bytes``, knob metadata, and ``page_ref_profile(workload, geom, device)``
returning the Eq. 12/13/14 histograms — so a :class:`CostSession` can price
any of the three families (and grid-tune their knobs) without knowing which
design it is holding.  ``window()`` exposes the last-mile search windows the
replay oracle needs, making every adapter directly checkable against ground
truth.

PGM and RadixSpline are uniformly error-bounded, so both delegate to the
shared ``uniform_eps_profile`` — RadixSpline's greedy spline corridor gives
the same |predict - rank| <= eps guarantee, which is exactly the paper's
index-agnosticism claim (§I property i) and what makes RadixSpline *tunable*
here for the first time: eps is its knob, same as PGM's.

RMI has no global bound; its profile is the §V-C workload-weighted mixture of
per-leaf Eq. 12 patterns with leaf error bounds quantized up to powers of two
(bounds LUT instantiations at ~log2(max_eps), windows stay conservative); a
range routes both endpoints and widens each end by its own leaf's bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core import dac as dac_mod
from repro_torch.core import page_ref
from repro_torch.core.cam import CamGeometry
from repro_torch import obs
from repro_torch.core.session import (DEFAULT_TORCH_DEVICE, PageRefProfile,
                                      UnsupportedWorkloadError, mixed_profile,
                                      sorted_stream_profile,
                                      uniform_eps_profile)
from repro_torch.core.workload import (MIXED, POINT, RANGE, SORTED, Workload,
                                       locate)
from repro_torch.index import pgm as pgm_mod
from repro_torch.index import radixspline as rs_mod
from repro_torch.index import rmi as rmi_mod
from repro_torch.index.gapped import (btree_slots, btree_write_amp, gapped_slots,
                                gapped_write_amp, to_slot_space)

__all__ = ["PGMAdapter", "RMIAdapter", "RadixSplineAdapter", "ALEXAdapter",
           "BTreeAdapter", "quantize_eps",
           "ADAPTERS", "wrap_index", "sqrt2_grid", "pow2_grid",
           "DEFAULT_EPS_GRID", "DEFAULT_BRANCH_GRID",
           "DEFAULT_RADIX_BITS_GRID", "DEFAULT_GAP_DENSITY_GRID",
           "DEFAULT_FILL_FACTOR_GRID"]


def sqrt2_grid(lo: int = 4, hi: int = 4096) -> tuple:
    """Dense sqrt(2)-spaced grid (the ONE implementation — the deprecated
    ``pgm_tuner.default_eps_grid`` shim delegates here)."""
    grid, e = [], float(lo)
    while e <= hi:
        grid.append(int(round(e)))
        e *= np.sqrt(2.0)
    return tuple(dict.fromkeys(grid))


def pow2_grid(lo: int = 2**6, hi: int = 2**16) -> tuple:
    """Doubling grid (the ONE implementation behind branch-factor grids)."""
    grid, b = [], int(lo)
    while b <= hi:
        grid.append(b)
        b *= 2
    return tuple(grid)


#: Default knob grids advertised through ``knobs()`` metadata.  A tuner's
#: ``KnobSpace`` is derived from these (``repro_torch.tuning.session``); they are
#: deliberately denser than what replay-based tuning could afford, because
#: grid candidates price through the batched estimators, not execution.
DEFAULT_EPS_GRID = sqrt2_grid()                        # sqrt(2)-spaced 4..4096
DEFAULT_BRANCH_GRID = pow2_grid()                      # doubling 64..65536
DEFAULT_RADIX_BITS_GRID = (8, 10, 12, 14, 16, 18)
DEFAULT_GAP_DENSITY_GRID = (0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5)
DEFAULT_FILL_FACTOR_GRID = (0.55, 0.6, 0.67, 0.75, 0.85, 0.95)


def quantize_eps(eps: np.ndarray) -> np.ndarray:
    """Round leaf error bounds up to powers of two (conservative windows)."""
    eps = np.maximum(np.asarray(eps, np.int64), 1)
    return (2 ** np.ceil(np.log2(eps))).astype(np.int64)


def _probe_windows(adapter, query_keys: np.ndarray, geom: CamGeometry):
    """Shared ``probe_windows`` body: adapter windows -> inclusive page
    intervals, clipped to the valid page range (PAGEINTERVALS in Alg. 2)."""
    lo, hi = adapter.window(query_keys)
    num_pages = geom.num_pages(adapter.n)
    page_lo = np.asarray(lo, np.int64) // geom.c_ipp
    page_hi = np.minimum(np.asarray(hi, np.int64) // geom.c_ipp, num_pages - 1)
    return page_lo, np.maximum(page_hi, page_lo)


@dataclasses.dataclass(frozen=True)
class PGMAdapter:
    """Disk-based PGM-index under the IndexModel protocol (knob: eps)."""

    index: pgm_mod.PGMIndex
    family: str = "pgm"

    @classmethod
    def build(cls, keys: np.ndarray, eps: int) -> "PGMAdapter":
        return cls(pgm_mod.build_pgm(keys, eps))

    @property
    def size_bytes(self) -> float:
        return float(self.index.size_bytes)

    @property
    def eps(self) -> int:
        return self.index.eps

    @property
    def n(self) -> int:
        return self.index.n

    @classmethod
    def knob_metadata(cls) -> Dict[str, object]:
        """Knob space metadata without a built instance (tuner-facing)."""
        return {"eps": {"kind": "error_bound", "tunable": True,
                        "grid": DEFAULT_EPS_GRID}}

    def knobs(self) -> Dict[str, object]:
        return {"eps": {"value": self.index.eps, "kind": "error_bound",
                        "tunable": True, "grid": DEFAULT_EPS_GRID}}

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
        return uniform_eps_profile(workload, self.index.eps, geom,
                                   self.index.n, device=device)

    def window(self, query_keys: np.ndarray):
        return self.index.window(query_keys)

    def probe_windows(self, query_keys: np.ndarray, geom: CamGeometry):
        return _probe_windows(self, query_keys, geom)


@dataclasses.dataclass(frozen=True)
class RadixSplineAdapter:
    """RadixSpline under the IndexModel protocol (knob: corridor eps).

    The fixed-eps spline corridor makes the whole uniform-eps machinery —
    including batched grid tuning — apply unchanged.
    """

    index: rs_mod.RadixSplineIndex
    family: str = "radixspline"

    @classmethod
    def build(cls, keys: np.ndarray, eps: int,
              radix_bits: int = 16) -> "RadixSplineAdapter":
        return cls(rs_mod.build_radixspline(keys, eps, radix_bits))

    @property
    def size_bytes(self) -> float:
        return float(self.index.size_bytes)

    @property
    def eps(self) -> int:
        return self.index.eps

    @property
    def n(self) -> int:
        return self.index.n

    @classmethod
    def knob_metadata(cls) -> Dict[str, object]:
        """2-D knob space: corridor eps x radix table width.

        ``radix_bits`` is a REAL tuning knob under a shared memory budget —
        the table costs 4 * (2^bits + 1) bytes of footprint that competes
        with buffer pages, so a tight budget prefers a narrow table even
        though the in-memory knot search gets a little wider.
        """
        return {"eps": {"kind": "error_bound", "tunable": True,
                        "grid": DEFAULT_EPS_GRID},
                "radix_bits": {"kind": "lookup_accel", "tunable": True,
                               "grid": DEFAULT_RADIX_BITS_GRID}}

    def knobs(self) -> Dict[str, object]:
        return {"eps": {"value": self.index.eps, "kind": "error_bound",
                        "tunable": True, "grid": DEFAULT_EPS_GRID},
                "radix_bits": {"value": self.index.radix_bits,
                               "kind": "lookup_accel", "tunable": True,
                               "grid": DEFAULT_RADIX_BITS_GRID}}

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
        return uniform_eps_profile(workload, self.index.eps, geom,
                                   self.index.n, device=device)

    def window(self, query_keys: np.ndarray):
        return self.index.window(query_keys)

    def probe_windows(self, query_keys: np.ndarray, geom: CamGeometry):
        return _probe_windows(self, query_keys, geom)


@dataclasses.dataclass(frozen=True)
class RMIAdapter:
    """Two-layer RMI under the IndexModel protocol (knob: branch factor)."""

    index: rmi_mod.RMIIndex
    family: str = "rmi"
    # Routing memo: (id(query_keys), c_ipp, strategy) -> (keys ref, eps row,
    # E[DAC]) for points, ("range", id(lo keys), id(hi keys)) -> (both refs,
    # eps_lo, eps_hi) for ranges.  Routing depends only on (index, workload),
    # yet a tuning loop re-prices the same workload under many (budget,
    # policy) Systems; the strong references in the value keep the ids
    # valid for the entry's lifetime, and the FIFO bound keeps a long-lived
    # adapter from pinning arbitrary query arrays.  Excluded from eq/repr
    # (pure cache).
    _ref_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                         repr=False, compare=False)
    _REF_CACHE_MAX = 4

    @classmethod
    def build(cls, keys: np.ndarray, branch: int) -> "RMIAdapter":
        return cls(rmi_mod.build_rmi(keys, branch))

    @property
    def size_bytes(self) -> float:
        return float(self.index.size_bytes)

    @property
    def n(self) -> int:
        return self.index.n

    @classmethod
    def knob_metadata(cls) -> Dict[str, object]:
        return {"branch": {"kind": "fanout", "tunable": True,
                           "grid": DEFAULT_BRANCH_GRID}}

    def knobs(self) -> Dict[str, object]:
        return {"branch": {"value": self.index.branch, "kind": "fanout",
                           "tunable": True, "grid": DEFAULT_BRANCH_GRID}}

    def _remember(self, key, value):
        while len(self._ref_cache) >= self._REF_CACHE_MAX:
            self._ref_cache.pop(next(iter(self._ref_cache)))
        self._ref_cache[key] = value

    def point_ref_eps(self, workload: Workload, geom: CamGeometry):
        """Per-query quantized leaf error bounds + E[DAC] (§V-C inputs).

        This is what the batched mixed-eps grid kernel
        (``page_ref.point_page_refs_mixed_eps_grid``) consumes: routing is
        host-side and cheap, so a whole branch grid can collect every
        candidate's (eps row, E[DAC]) first and profile them in ONE grouped
        pass instead of per-branch mixture histograms.
        """
        if workload.kind != POINT or workload.query_keys is None:
            raise UnsupportedWorkloadError(
                workload.kind,
                detail="RMI profiling needs a point workload with "
                       "query_keys (the root must route them)")
        key = (id(workload.query_keys), geom.c_ipp, geom.strategy)
        hit = self._ref_cache.get(key)
        if hit is not None:
            return hit[1], hit[2]
        index = self.index
        leaf = index.route(workload.query_keys)
        obs.count("route.keys", leaf.shape[0])
        eps_q = quantize_eps(index.leaf_eps[leaf])
        weights = np.bincount(leaf, minlength=index.branch).astype(np.float64)
        weights /= max(weights.sum(), 1.0)
        e_dac = float(dac_mod.expected_dac_rmi(
            index.leaf_eps, weights, geom.c_ipp, geom.strategy))
        self._remember(key, (workload.query_keys, eps_q, e_dac))
        return eps_q, e_dac

    def range_ref_eps(self, workload: Workload, geom: CamGeometry):
        """Quantized leaf error bounds of each range's two endpoints.

        Each endpoint key routes to its own leaf, so a range's lower and
        upper ends carry their own bounds ``e(k) = 2^ceil(log2 max(
        leaf_eps[leaf(k)], 1))``; Eq. 14 widens each end by twice its own
        bound (``page_ref.range_page_spans``).  Returns ``(eps_lo,
        eps_hi)``, memoized like :meth:`point_ref_eps`.
        """
        lo_keys, hi_keys = workload.query_keys, workload.hi_query_keys
        if workload.kind != RANGE or lo_keys is None or hi_keys is None:
            raise UnsupportedWorkloadError(
                workload.kind,
                detail="RMI profiling of ranges needs both endpoints' keys "
                       "(query_keys, hi_query_keys) to route them")
        key = ("range", id(lo_keys), id(hi_keys))
        hit = self._ref_cache.get(key)
        if hit is not None:
            return hit[2], hit[3]
        index = self.index
        eps_lo = quantize_eps(index.leaf_eps[index.route(lo_keys)])
        eps_hi = quantize_eps(index.leaf_eps[index.route(hi_keys)])
        obs.count("route.keys", eps_lo.shape[0] + eps_hi.shape[0])
        self._remember(key, (lo_keys, hi_keys, eps_lo, eps_hi))
        return eps_lo, eps_hi

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
        """§V-C mixture: per-query leaf error bounds, quantized to pow2.

        Points take Eq. 12/13 at their own leaf's bound; a range takes
        Eq. 14 with each endpoint's own bound, and references each page of
        its span once (its E[DAC] mass is the page count).  Sorted probe
        streams carry explicit position windows, so they need no routing —
        RMI prices them through the same shared sorted-stream profile as
        the uniformly error-bounded families (the capacity premise read off
        the widest observed window).  A mixed workload composes its parts
        as the uniform-eps profile does.
        """
        num_pages = geom.num_pages(self.index.n)
        if workload.kind == SORTED:
            return sorted_stream_profile(workload, geom, num_pages,
                                         device=device)
        if workload.kind == MIXED:
            return mixed_profile(
                workload,
                lambda part: self.page_ref_profile(part, geom, device),
                num_pages, device)
        if workload.kind == RANGE:
            with obs.span("cam.route"):
                eps_lo, eps_hi = self.range_ref_eps(workload, geom)
            start, end = page_ref.range_page_spans(
                workload.positions, workload.hi_positions, eps_lo[None, :],
                eps_hi[None, :], geom.c_ipp, self.index.n)
            spans = obs.to_device(np.stack([start, end]).astype(np.int32),
                                  device)
            counts = page_ref.range_page_refs_bounds_grid(*spans, num_pages)
            total = float((end - start + 1).sum())
            return PageRefProfile(counts[0], total,
                                  total / max(workload.n_queries, 1))
        with obs.span("cam.route"):
            eps_q, e_dac = self.point_ref_eps(workload, geom)
        counts, total = page_ref.point_page_refs_mixed_eps(
            workload.positions, eps_q, geom.c_ipp, num_pages, device=device)
        return PageRefProfile(counts, float(total), e_dac)

    def window(self, query_keys: np.ndarray):
        lo, hi, _ = self.index.window(query_keys)
        return lo, hi

    def probe_windows(self, query_keys: np.ndarray, geom: CamGeometry):
        return _probe_windows(self, query_keys, geom)


@dataclasses.dataclass(frozen=True)
class ALEXAdapter:
    """ALEX-style gapped-array updatable index (knob: gap density).

    Writes become first-class: leaves keep ``gap_density`` of their slots
    empty so inserts shift only to the nearest gap instead of rewriting the
    tail.  The knob trades the two I/O streams against each other —

    * more gaps: CHEAPER writes (short shifts, low
      ``gapped_write_amp``) but a BIGGER footprint, so probe windows span
      more pages and the same buffer caches a smaller fraction;
    * fewer gaps: dense reads, expensive shifts.

    Both sides flow through one profile: the read-side refs are the shared
    ``uniform_eps_profile`` in SLOT space (the ``to_slot_space`` remap from
    ``repro_torch.index.gapped``), and the write stream rides its ``write_amp``
    hook, so :class:`~repro_torch.tuning.session.TuningSession` tunes the knob
    with the machinery it already has.

    Model error is treated as uniformly bounded (``eps``): the gapped remap
    is monotone, so the per-leaf linear models keep their corridor in slot
    space.  ``keys`` is kept (when built from data) only for ``window()`` —
    the replay oracle's ground-truth probe windows.
    """

    n: int
    gap_density: float
    eps: int = 64
    keys: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    family: str = "alex"

    @classmethod
    def build(cls, keys: np.ndarray, gap_density: float,
              eps: int = 64) -> "ALEXAdapter":
        keys = np.asarray(keys)
        return cls(n=int(keys.shape[0]), gap_density=float(gap_density),
                   eps=int(eps), keys=keys)

    @property
    def slots(self) -> int:
        return gapped_slots(self.n, self.gap_density)

    @property
    def size_bytes(self) -> float:
        # per-leaf linear models over ~1k-slot nodes (slope+intercept+bounds
        # ~ 48 B) plus a root model: slack grows the leaf count, so the knob
        # also competes for the Eq. 15 memory budget
        return 48.0 * float(np.ceil(self.slots / 1024.0)) + 64.0

    @classmethod
    def knob_metadata(cls) -> Dict[str, object]:
        return {"gap_density": {"kind": "slack", "tunable": True,
                                "grid": DEFAULT_GAP_DENSITY_GRID}}

    def knobs(self) -> Dict[str, object]:
        return {"gap_density": {"value": self.gap_density, "kind": "slack",
                                "tunable": True,
                                "grid": DEFAULT_GAP_DENSITY_GRID}}

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
        slots = self.slots
        return uniform_eps_profile(
            to_slot_space(workload, self.n, slots), self.eps, geom, slots,
            write_amp=gapped_write_amp(self.gap_density, geom.c_ipp),
            device=device)

    def window(self, query_keys: np.ndarray):
        if self.keys is None:
            raise UnsupportedWorkloadError(
                "window", detail="ALEXAdapter built without keys cannot "
                "produce ground-truth windows; use ALEXAdapter.build")
        slots = self.slots
        slot = (locate(self.keys, np.asarray(query_keys))
                * slots) // max(self.n, 1)
        return (np.maximum(slot - self.eps, 0),
                np.minimum(slot + self.eps, slots - 1))

    def probe_windows(self, query_keys: np.ndarray, geom: CamGeometry):
        return _probe_windows(self, query_keys, geom)


@dataclasses.dataclass(frozen=True)
class BTreeAdapter:
    """Disk B+-tree baseline (knob: leaf fill factor).

    The classic updatable baseline the paper's learned indexes displace.
    Inner nodes are assumed memory-resident (they are tiny and hot), so a
    probe touches exactly the leaf page holding the key: ``eps = 0`` in the
    shared profile — the tree pays no model-error fan-out, it pays FOOTPRINT
    (leaves are only ``fill_factor`` full, so the key space spreads over
    ``1/fill_factor`` more pages) and amortized split I/O on inserts
    (``btree_write_amp``).  High fill reads densely but splits constantly;
    low fill wastes cache on slack — the same two-stream trade as ALEX with
    the opposite lever.
    """

    n: int
    fill_factor: float = 0.7
    keys: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    family: str = "btree"
    eps: int = 0

    @classmethod
    def build(cls, keys: np.ndarray, fill_factor: float = 0.7,
              **_ignored) -> "BTreeAdapter":
        keys = np.asarray(keys)
        return cls(n=int(keys.shape[0]), fill_factor=float(fill_factor),
                   keys=keys)

    @property
    def slots(self) -> int:
        return btree_slots(self.n, self.fill_factor)

    @property
    def size_bytes(self) -> float:
        # resident inner nodes: ~16 B (separator + child pointer) per leaf
        # of ~256 slots, times ~1/(1-1/fanout) for upper levels ~ 1.01
        return 16.0 * float(np.ceil(self.slots / 256.0)) + 64.0

    @classmethod
    def knob_metadata(cls) -> Dict[str, object]:
        return {"fill_factor": {"kind": "slack", "tunable": True,
                                "grid": DEFAULT_FILL_FACTOR_GRID}}

    def knobs(self) -> Dict[str, object]:
        return {"fill_factor": {"value": self.fill_factor, "kind": "slack",
                                "tunable": True,
                                "grid": DEFAULT_FILL_FACTOR_GRID}}

    def page_ref_profile(self, workload: Workload, geom: CamGeometry,
                         device=DEFAULT_TORCH_DEVICE) -> PageRefProfile:
        slots = self.slots
        return uniform_eps_profile(
            to_slot_space(workload, self.n, slots), 0, geom, slots,
            write_amp=btree_write_amp(self.fill_factor, geom.c_ipp),
            device=device)

    def window(self, query_keys: np.ndarray):
        if self.keys is None:
            raise UnsupportedWorkloadError(
                "window", detail="BTreeAdapter built without keys cannot "
                "produce ground-truth windows; use BTreeAdapter.build")
        slots = self.slots
        slot = (locate(self.keys, np.asarray(query_keys))
                * slots) // max(self.n, 1)
        return slot, slot

    def probe_windows(self, query_keys: np.ndarray, geom: CamGeometry):
        return _probe_windows(self, query_keys, geom)


ADAPTERS = {"pgm": PGMAdapter, "rmi": RMIAdapter,
            "radixspline": RadixSplineAdapter, "alex": ALEXAdapter,
            "btree": BTreeAdapter}

_RAW_CLASSES = {pgm_mod.PGMIndex: PGMAdapter, rmi_mod.RMIIndex: RMIAdapter,
                rs_mod.RadixSplineIndex: RadixSplineAdapter}


def wrap_index(index) -> "PGMAdapter | RMIAdapter | RadixSplineAdapter":
    """Normalize a raw index or adapter to the IndexModel protocol.

    This is what lets execution paths (join executors, replay harnesses)
    accept any index family without per-design tuple-shape special cases:
    whatever comes in, what comes out has ``probe_windows`` / ``window``
    with one uniform signature.
    """
    if hasattr(index, "probe_windows"):
        return index
    for raw_cls, adapter_cls in _RAW_CLASSES.items():
        if isinstance(index, raw_cls):
            return adapter_cls(index)
    raise TypeError(
        f"cannot adapt {type(index).__name__} to the IndexModel "
        f"protocol; expected one of {[c.__name__ for c in _RAW_CLASSES]} "
        "or an object exposing probe_windows()")
