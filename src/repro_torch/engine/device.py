"""DeviceExecutor — the fused, device-resident PriceTable executor.

Marshals a PriceTable into the padded (row x cell-slot) layout of
``kernels/price_grid.py`` and solves the whole table in one launch of the
CUDA ``price_grid`` kernel: histograms stay on the card, the policy fixed
point, the sorted/mixed composition and the objective argmin fuse into a
single kernel.  Profiles held on the CPU take the kernel's plain torch
version.  Preprocessing mirrors ``CostSession.solve_profiles`` exactly —
zero-part substitution for sorted composition, the compulsory-equivalent
coverage surrogate for legacy coverage-less parts, exact int32 capacity
clamps — so results are float32-equivalent to the HostExecutor.  Only
per-row scalars (distinct-page counts, the argmin id) cross to the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.session import (SortedScanPart, _compulsory_coverage,
                                      _np64)
from repro_torch.kernels import price_grid as _pg

__all__ = ["DeviceExecutor"]

_CAP_MAX = 2**31 - 129   # matches core.session._exact_cap_array


def _exact_i32(values) -> np.ndarray:
    arr = np.floor(np.asarray(values, np.float64))
    return np.clip(arr, -1, _CAP_MAX).astype(np.int32)


class DeviceExecutor:
    """Solve a PriceTable through the fused price-grid kernel."""

    name = "device"

    def solve(self, engine, table, row_scale):
        from repro_torch.core.cache_models import POLICIES
        profiles = table.profiles
        rows = np.asarray(table.rows, np.int64)
        t = rows.shape[0]
        dev = profiles.counts.device

        # ---- per-cell policies: group by (profile row, policy) ----------
        # A kernel block owns ONE fixed point, so multi-policy tables split
        # a profile row into one kernel row per policy it prices under;
        # single-policy tables reduce to the plain per-row grouping.
        base_code = POLICIES.index(engine.cost.system.policy)
        if table.pols is None:
            cell_pols = np.full(t, base_code, np.int64)
        else:
            cell_pols = np.asarray(table.pols, np.int64)
            cell_pols = np.where(cell_pols < 0, base_code, cell_pols)
        ukeys, inv = np.unique(rows * len(POLICIES) + cell_pols,
                               return_inverse=True)
        urows = ukeys // len(POLICIES)
        upols = (ukeys % len(POLICIES)).astype(np.int32)
        k = urows.shape[0]
        upol_set = set(upols.tolist())
        policy = (POLICIES[upol_set.pop()] if len(upol_set) == 1
                  else "multi")

        # ---- cell layout: group cells by profile row, keep table order --
        per_row = np.bincount(inv, minlength=k)
        c_max = int(per_row.max())
        order = np.argsort(inv, kind="stable")
        starts = np.zeros(k, np.int64)
        starts[1:] = np.cumsum(per_row)[:-1]
        slot = np.empty(t, np.int64)
        slot[order] = np.arange(t) - starts[inv[order]]

        caps_i = np.full((k, c_max), -1, np.int32)
        ids = np.full((k, c_max), _pg.PAD_ID, np.int32)
        caps_i[inv, slot] = _exact_i32(table.caps)
        ids[inv, slot] = np.arange(t, dtype=np.int32)
        caps_f = caps_i.astype(np.float32)

        # ---- per-row statistics (solve_profiles preprocessing) ----------
        counts = profiles.counts[torch.as_tensor(urows, device=dev)]  # (K, P)
        num_pages = int(profiles.counts.shape[1])
        sample_f = np.asarray(profiles.totals, np.float64)[urows]
        sample_f = sample_f.astype(np.float32)
        full_f = sample_f * np.float32(profiles.scale)
        wps = ([profiles.wparts[i] for i in urows]
               if profiles.wparts else [])
        has_write = any(wp is not None for wp in wps)
        if has_write:
            # fold the write stream into the request histogram BEFORE
            # normalizing (hit_rate_grid order): writes fault their pages
            # like reads, and probs/n_distinct/pmin describe the mix.
            zero_w = torch.zeros((num_pages,), dtype=torch.float32,
                                 device=dev)
            w_counts = torch.stack(
                [wp.counts.float() if wp is not None else zero_w
                 for wp in wps])
            w_refs = np.asarray([wp.total_refs if wp is not None else 0.0
                                 for wp in wps], np.float32)
            counts = counts + w_counts
            sample_f = sample_f + w_refs
            full_f = full_f + w_refs * np.float32(profiles.scale)
        sample_t = torch.as_tensor(sample_f, device=dev)[:, None]
        probs = counts / torch.clamp(sample_t, min=1e-30)
        inf = torch.tensor(float("inf"), device=dev)
        pmin_t = torch.clamp(torch.amin(torch.where(probs > 0, probs, inf),
                                        dim=1), min=1e-30)
        nd_t = torch.sum(counts > 0, dim=1)
        scale = np.asarray(row_scale, np.float64)[urows].astype(np.float32)

        sparts = [profiles.sparts[i] for i in urows]
        has_sorted = any(sp is not None for sp in sparts)
        surrogate = {}
        f32s = np.zeros((k, _pg._F32_COLS), np.float32)
        i32s = np.zeros((k, _pg._I32_COLS), np.int32)
        f32s[:, 0], f32s[:, 1] = sample_f, full_f
        f32s[:, 8] = scale
        i32s[:, 3] = upols                  # read iff policy == "multi"

        dummy = torch.zeros((k, 1), dtype=torch.float32, device=dev)
        cov = cov_desc = dummy
        if has_sorted:
            zero = SortedScanPart(0.0, 0.0, 1,
                                  torch.zeros((num_pages,),
                                              dtype=torch.float32,
                                              device=dev), 0.0)
            sps = [sp if sp is not None else zero for sp in sparts]
            for i, sp in enumerate(sps):
                if sp.coverage is None:
                    surrogate[i] = sp.distinct_pages
                    sps[i] = dataclasses.replace(
                        sp, coverage=_compulsory_coverage(sp, num_pages,
                                                          dev))
            f32s[:, 4] = [sp.total_refs for sp in sps]
            f32s[:, 5] = f32s[:, 4] * np.float32(profiles.scale)
            i32s[:, 1] = _exact_i32([sp.distinct_pages for sp in sps])
            f32s[:, 6] = i32s[:, 1].astype(np.float32)
            f32s[:, 7] = [sp.pinned_retouches for sp in sps]
            i32s[:, 2] = _exact_i32([sp.min_capacity for sp in sps])
            cov = torch.stack([sp.coverage.float() for sp in sps])
            if policy in ("lfu", "multi"):
                cov_desc = torch.sort(cov, dim=1, descending=True).values
        sorted_probs = (torch.sort(probs, dim=1, descending=True).values
                        if policy in ("lfu", "multi") else dummy)
        wprobs = wprobs_q = None
        if has_write:
            wprobs = w_counts / torch.clamp(sample_t, min=1e-30)
            if policy in ("lfu", "multi"):
                # the LFU resident set is the top-C of the COMBINED stream;
                # permute write mass into that order (the stable argsort
                # tie-break matches cache_models._writeback_terms)
                wprobs_q = torch.gather(
                    wprobs, 1, torch.argsort(-probs, dim=1, stable=True))

        # ---- per-row scalars: the only host round trip before the launch
        nd_i = nd_t.cpu().numpy().astype(np.int64)
        f32s[:, 2] = nd_i.astype(np.float32)
        f32s[:, 3] = pmin_t.cpu().numpy()
        i32s[:, 0] = _exact_i32(nd_i)

        def up(a):
            return torch.as_tensor(a, device=dev)

        # ---- one fused launch -------------------------------------------
        h2, _, best_id = _pg.price_grid(
            policy, probs, sorted_probs, cov_desc, up(f32s), up(i32s),
            up(caps_f), up(caps_i), up(ids), wprobs, wprobs_q,
            has_sorted=has_sorted, has_write=has_write)
        h = _np64(h2)[inv, slot]

        # ---- distinct pages (host-side closed forms, as solve_profiles) -
        if has_sorted:
            nd_row = _np64(torch.sum((counts > 0) | (cov > 0), dim=1))
            for i, true_n in surrogate.items():
                nd_row[i] = float(nd_i[i]) + true_n
        else:
            nd_row = nd_i.astype(np.float64)

        best = int(best_id.reshape(-1)[0])
        return h, nd_row[inv], (best if best < _pg.PAD_ID else None)
