"""The serving loop's reference for an RMI: every candidate routes each key.

``OnlineReference`` with the frozen RMIs of ``reference/rmi.py`` (built by
``reference.tune.knob_sizes``) in place of a uniform eps.  A chunk holds,
per branch factor:

* points (Eq. 12/13): each point at its routed leaf's bound ``e(k) =
  2^ceil(log2 max(eps_leaf, 1))``; E[DAC] the batch's leaf mixture
  ``sum_j w_j (1 + 2 eps_j / C)`` over the unquantized leaf bounds;
* ranges (Eq. 14): every page from ``floor(max(0, lo - 2 e(k_lo)) / C)``
  to ``floor(min(n - 1, hi + 2 e(k_hi)) / C)`` once, each end at the bound
  of its own key's leaf; E[DAC] mass the page count;
* sorted probes: the base class's statistics (no bound moves a window),
  and the capacity premise, the widest window in pages, which the window
  takes as its largest over its chunks.

Everything else (the window, the drift summary, pricing, the decision, the
memo of each distinct chunk and window) is the base class's.
"""
from __future__ import annotations

import numpy as np
import torch

from cambench.reference import cam
from cambench.reference.online import OnlineReference, batch_parts
from cambench.reference.rmi import quantize_eps


class RMIOnlineReference(OnlineReference):
    def __init__(self, inp, sizes, rmis, device, **kw):
        # ``knob_sizes`` builds only the branches that fit the budget
        fits = {b: sizes.get(b, float("inf")) for b in inp.grid}
        super().__init__(inp, fits, device, **kw)
        self.rmis = rmis

    def bounds(self, branch, ranks) -> np.ndarray:
        """``e(k)`` of the keys at ``ranks`` under the RMI of ``branch``."""
        r = self.rmis[branch]
        return quantize_eps(r.leaf_eps[r.route(self.inp.keys[ranks])])

    def chunk(self, batch) -> dict:
        inp, dev, dt = self.inp, self.dev, self.profile_dtype
        c, p, n = inp.c_ipp, inp.num_pages, inp.n
        srt = [e for e in batch if e[0] == "sorted"]
        ch = super().chunk(srt) if srt else {
            "sorted": None, "dac": np.zeros(len(self.knobs)),
            "totals": np.zeros(len(self.knobs)),
            "counts": torch.zeros((len(self.knobs), p), dtype=dt,
                                  device=dev)}
        parts = batch_parts(batch)
        counts, totals, dac = ch["counts"], ch["totals"], ch["dac"]
        if "point" in parts:
            lo = parts["point"][0]
            pos = torch.as_tensor(lo, device=dev)
            for i, b in enumerate(self.knobs):
                r = self.rmis[b]
                leaf = r.route(inp.keys[lo])
                row = cam.mixed_counts(pos, quantize_eps(r.leaf_eps[leaf]),
                                       c, p, dt)
                counts[i] += row
                totals[i] += float(row.sum())
                w = np.bincount(leaf, minlength=r.branch) / leaf.shape[0]
                dac[i] += lo.shape[0] * float(
                    (w * (1.0 + 2.0 * r.leaf_eps / c)).sum())
        if "range" in parts:
            lo, hi = parts["range"]
            for i, b in enumerate(self.knobs):
                start = np.maximum(lo - 2 * self.bounds(b, lo), 0) // c
                end = np.minimum(hi + 2 * self.bounds(b, hi), n - 1) // c
                diff = np.bincount(start, minlength=p + 1) \
                    - np.bincount(end + 1, minlength=p + 1)
                counts[i] += torch.as_tensor(np.cumsum(diff)[:p], dtype=dt,
                                             device=dev)
                refs = float(np.sum(end - start + 1))
                totals[i] += refs
                dac[i] += refs
        if srt:
            lo, hi = parts["sorted"]
            plo = np.maximum(lo, 0) // c
            phi = np.minimum(np.maximum(np.minimum(hi, p * c - 1) // c, plo),
                             p - 1)
            ch["sorted"]["widest"] = int(np.max(phi - plo + 1))
        ch.update(n=len(batch), summary=self.summary_of(parts))
        return ch

    def merged(self) -> dict:
        m = super().merged()
        srt = [ch["sorted"] for ch in self.window if ch["sorted"] is not None]
        if srt:
            m["sorted"]["widest"] = max(s["widest"] for s in srt)
        return m

    def price(self, m: dict) -> dict:
        """{(branch, cap): (h, io, dac, distinct)} of the merged window:
        the base class's pricing with the RMI's sorted capacity premise
        (the window's widest sorted window, for every branch)."""
        rows = {b: i for i, b in enumerate(self.knobs)}
        ridx = np.asarray([rows[b] for b, _, _ in self.cells])
        caps = np.asarray([cap for _, _, cap in self.cells])
        counts = m["counts"]
        h = cam.hit_rates(counts, ridx, caps, ["lru"] * len(ridx),
                          dtype=self.price_dtype)
        dacs = np.asarray(m["dac"], np.float64) / max(m["n"], 1)
        irm = counts > 0
        srt = m["sorted"]
        if srt is not None and srt["refs"] > 0:
            cov = srt["coverage"]
            s_n = float((cov > 0).sum())
            r_irm = np.asarray(m["totals"], np.float64)[ridx]
            r_s, pinned = srt["refs"], srt["pinned"]
            miss_s = np.where(caps < srt["widest"],
                              min(max(r_s - pinned, s_n), r_s), s_n)
            h_s = (r_s - miss_s) / max(r_s, 1.0)
            total = r_irm + r_s
            miss = (1.0 - h) * r_irm + (1.0 - h_s) * r_s
            h = np.where(total > 0, 1.0 - miss / np.maximum(total, 1.0), 0.0)
            irm = irm | (cov > 0)[None, :]
        distinct = irm.sum(-1).cpu().numpy()
        h = np.asarray([float(torch.tensor(v, dtype=self.price_dtype))
                        for v in h])
        return {(b, cap): (float(hj), (1.0 - float(hj)) * dacs[rows[b]],
                           float(dacs[rows[b]]), float(distinct[rows[b]]))
                for (b, _, cap), hj in zip(self.cells, h)}
