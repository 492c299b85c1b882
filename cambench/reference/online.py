"""The serving loop worked out plainly: sketch, drift, retune, decision.

A batch of events is a mix of point lookups, range scans and sorted
probes over true ranks.  Its chunk holds, per candidate eps, the expected
page references of its points (Eq. 12/13) and ranges (Eq. 14: every page
of ``[max(0, lo - 2 eps), min(n - 1, hi + 2 eps)]``), its E[DAC] mass
(points ``1 + 2 eps / C`` each, ranges and sorted probes their pages), and
the sorted probes' statistics (window coverage, R, the junction re-touches
``lo[i+1] == hi[i]``, the capacity premise ``1 + ceil(2 eps / C)``); and
the drift summary (page popularity in 32 bins, log2 window widths, op
mix).  The window is the last ``window_chunks`` chunks, summed (a junction
between chunks counts as a re-touch).  Drift is the largest total-variation
distance of a summary component from the deployed one; with hysteresis and
a cooldown it triggers an evaluation, which prices the (knob x split) table
under LRU — Che on the point/range histogram, Theorem III.1 on the sorted
stream (its distinct pages, or every unpinned reference below the capacity
premise), composed by expected misses — and switches when the I/O saved
over the horizon repays a rebuild (key-file scan, index write, buffer
refill).

``OnlineReference.follow`` replays the program's run batch by batch from
the program's own deployments: the program's choice at each evaluation is
priced by the reference, so one near tie between two knobs does not send
the two runs apart.

The stream replays cyclically, so a long run holds few distinct inputs: a
chunk is a function of its batch alone, and a window's merge and priced
table of its ordered chunks.  The reference computes each once, keyed by
the batch's place in the inputs (``("warm", i)``, ``("stream", j)``) and
by the window's tuple of those keys, and only reads it afterwards; every
batch is still compared.
"""
from __future__ import annotations

import collections
import math

import numpy as np
import torch

from cambench.reference import cam

OPS = ("point", "range", "sorted")
WIDTH_BINS = 24
_OP_INDEX = {"point": 0, "range": 1, "sorted": 2}
_N_OPS = 6


def batch_parts(batch):
    """{op: (lo array, hi array)} of a batch of (op, lo, hi, ts) events."""
    out = {}
    for op in OPS:
        sel = [(lo, hi) for o, lo, hi, _ in batch if o == op]
        if sel:
            a = np.asarray(sel, np.int64)
            out[op] = (a[:, 0], a[:, 1])
    return out


class OnlineReference:
    def __init__(self, inp, sizes, device, *, profile_dtype=torch.float64,
                 price_dtype=torch.float64, summary_dtype=np.float64):
        self.inp, self.dev = inp, torch.device(device)
        self.sizes = sizes
        self.knobs = [k for k in inp.grid
                      if inp.budget - sizes[k] >= inp.page_bytes]
        self.cells = cam.table({k: sizes[k] for k in self.knobs}, inp.budget,
                               inp.page_bytes, inp.splits)
        self.profile_dtype = profile_dtype
        self.price_dtype, self.summary_dtype = price_dtype, summary_dtype
        self.window = collections.deque(maxlen=inp.serving["window_chunks"])
        self.window_keys = collections.deque(maxlen=self.window.maxlen)
        self._chunks, self._merged, self._cells = {}, {}, {}

    def memo(self, store: dict, key, make):
        """``store[key]``, made by ``make()`` the first time.  One instance
        serves one set of inputs, so an equal key means an equal input."""
        if key not in store:
            store[key] = make()
        return store[key]

    def push(self, key, batch) -> None:
        """Slide the window on by ``batch``, at ``key`` in the inputs."""
        self.window.append(self.memo(self._chunks, key,
                                     lambda: self.chunk(batch)))
        self.window_keys.append(key)

    def window_merged(self) -> dict:
        return self.memo(self._merged, tuple(self.window_keys), self.merged)

    def window_cells(self) -> dict:
        return self.memo(self._cells, tuple(self.window_keys),
                         lambda: self.price(self.window_merged()))

    # ------------------------------------------------------------- chunks
    def chunk(self, batch) -> dict:
        inp, dev, dt = self.inp, self.dev, self.profile_dtype
        c, p, n = inp.c_ipp, inp.num_pages, inp.n
        parts = batch_parts(batch)
        k = len(self.knobs)
        counts = torch.zeros((k, p), dtype=dt, device=dev)
        totals = np.zeros(k)
        dac = np.zeros(k)
        ch = {"n": len(batch), "sorted": None}
        if "point" in parts:
            pos = torch.as_tensor(parts["point"][0], device=dev)
            for i, e in enumerate(self.knobs):
                row = cam.point_counts(pos, int(e), c, p, dt)
                counts[i] += row
                totals[i] += float(row.sum())
                dac[i] += len(parts["point"][0]) * (1.0 + 2.0 * e / c)
        if "range" in parts:
            lo, hi = parts["range"]
            for i, e in enumerate(self.knobs):
                start = np.maximum(lo - 2 * e, 0) // c
                end = np.minimum(hi + 2 * e, n - 1) // c
                diff = np.bincount(start, minlength=p + 1) \
                    - np.bincount(end + 1, minlength=p + 1)
                counts[i] += torch.as_tensor(np.cumsum(diff)[:p], dtype=dt,
                                             device=dev)
                refs = float(np.sum(end - start + 1))
                totals[i] += refs
                dac[i] += refs
        if "sorted" in parts:
            lo, hi = parts["sorted"]
            plo = np.maximum(lo, 0) // c
            phi = np.minimum(np.maximum(np.minimum(hi, p * c - 1) // c, plo),
                             p - 1)
            cov = np.cumsum(np.bincount(plo, minlength=p + 1)
                            - np.bincount(phi + 1, minlength=p + 1))[:p]
            refs = float(np.sum(phi - plo + 1))
            dac += refs
            ch["sorted"] = {
                "coverage": torch.as_tensor(cov, dtype=dt, device=dev),
                "refs": refs, "pinned": float(np.sum(plo[1:] == phi[:-1])),
                "first": int(lo[0]) // c, "last": int(hi[-1]) // c}
        ch.update(counts=counts, totals=totals, dac=dac,
                  summary=self.summary_of(parts))
        return ch

    def summary_of(self, parts) -> dict:
        c, p, bins = self.inp.c_ipp, self.inp.num_pages, \
            self.inp.serving["page_bins"]
        pop = np.zeros(bins)
        width = np.zeros(WIDTH_BINS)
        mix = np.zeros(_N_OPS)
        for op, (lo, hi) in parts.items():
            pages = lo // c
            pop += np.bincount(np.minimum(pages * bins // p, bins - 1),
                               minlength=bins)
            mix[_OP_INDEX[op]] += lo.shape[0]
            if op != "point":
                wb = np.minimum(np.floor(np.log2(np.maximum(hi - lo + 1, 1)))
                                .astype(np.int64), WIDTH_BINS - 1)
                width += np.bincount(wb, minlength=WIDTH_BINS)
        return {"page_pop": pop, "width": width, "op_mix": mix}

    def window_summary(self) -> dict:
        out = {}
        for ch in self.window:
            for key, v in ch["summary"].items():
                out[key] = out.get(key, 0) + v
        return out

    def tv(self, a: dict, b: dict) -> float:
        d = 0.0
        for key in a:
            pa = np.asarray(a[key], self.summary_dtype)
            pb = np.asarray(b[key], self.summary_dtype)
            sa, sb = pa.sum(), pb.sum()
            pa = pa / sa if sa > 0 else pa
            pb = pb / sb if sb > 0 else pb
            if pa.sum() == 0 and pb.sum() == 0:
                continue
            d = max(d, float(0.5 * np.abs(pa - pb).sum()))
        return d

    # ------------------------------------------------------------ pricing
    def merged(self) -> dict:
        chunks = list(self.window)
        m = {"counts": sum(ch["counts"] for ch in chunks),
             "totals": sum(ch["totals"] for ch in chunks),
             "dac": sum(ch["dac"] for ch in chunks),
             "n": sum(ch["n"] for ch in chunks), "sorted": None}
        srt = [ch["sorted"] for ch in chunks if ch["sorted"] is not None]
        if srt:
            pinned = sum(s["pinned"] for s in srt)
            pinned += sum(1.0 for a, b in zip(srt, srt[1:])
                          if b["first"] == a["last"])
            m["sorted"] = {"coverage": sum(s["coverage"] for s in srt),
                           "refs": sum(s["refs"] for s in srt),
                           "pinned": pinned}
        return m

    def price(self, m: dict) -> dict:
        """{(eps, cap): (h, io, dac, distinct)} of the merged window."""
        inp = self.inp
        rows = {e: i for i, e in enumerate(self.knobs)}
        ridx = np.asarray([rows[e] for e, _, _ in self.cells])
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
            min_caps = np.asarray([1 + math.ceil(2 * e / inp.c_ipp)
                                   for e, _, _ in self.cells])
            miss_s = np.where(caps < min_caps,
                              min(max(r_s - pinned, s_n), r_s), s_n)
            h_s = (r_s - miss_s) / max(r_s, 1.0)
            total = r_irm + r_s
            miss = (1.0 - h) * r_irm + (1.0 - h_s) * r_s
            h = np.where(total > 0, 1.0 - miss / np.maximum(total, 1.0), 0.0)
            irm = irm | (cov > 0)[None, :]
        distinct = irm.sum(-1).cpu().numpy()
        h = np.asarray([float(torch.tensor(v, dtype=self.price_dtype))
                        for v in h])
        return {(e, cap): (float(hj), (1.0 - float(hj)) * dacs[rows[e]],
                           float(dacs[rows[e]]), float(distinct[rows[e]]))
                for (e, _, cap), hj in zip(self.cells, h)}

    def rebuild_io(self, cells, knob, cap) -> float:
        inp = self.inp
        distinct = cells[(knob, cap)][3]
        return float(inp.num_pages + math.ceil(self.sizes[knob]
                                               / inp.page_bytes)
                     + min(float(cap), distinct))

    @staticmethod
    def best(cells):
        return min(cells, key=lambda key: cells[key][1])


class Gate:
    """The deployed configuration and the drift trigger's state: the TV
    distance from the deployed summary, re-arming below ``threshold -
    hysteresis``, a deepening of ``hysteresis`` past the last evaluation,
    and a cooldown in batches."""

    def __init__(self, cfg, knob, cap, baseline):
        self.cfg = cfg
        self.deploy(knob, cap, baseline)

    def deploy(self, knob, cap, baseline) -> None:
        self.knob, self.cap, self.baseline = knob, cap, baseline
        self.armed, self.last_tv = False, 0.0
        self.cooldown = self.cfg["cooldown_batches"]

    def observe(self, tv: float) -> bool:
        """One batch: whether it triggers an evaluation."""
        cfg = self.cfg
        if self.cooldown > 0:
            self.cooldown -= 1
        if not self.armed and tv < (cfg["drift_threshold"]
                                    - cfg["hysteresis"]):
            self.armed = True
        drifted = tv > cfg["drift_threshold"] and (
            self.armed or tv > self.last_tv + cfg["hysteresis"])
        return drifted and self.cooldown == 0

    def evaluated(self, tv: float) -> None:
        self.armed, self.last_tv = False, tv
        self.cooldown = self.cfg["cooldown_batches"]


def decide(ref, gate, cells, best, cap):
    """(io of the deployed configuration on the live window, rebuild I/O of
    ``best`` at ``cap``, whether the saving over the horizon repays it)."""
    entries = [key for key in cells if key[0] == gate.knob]
    io_cur = cells[min(entries, key=lambda key: abs(key[1] - gate.cap))][1]
    rebuild = ref.rebuild_io(cells, best, cap)
    saving = (io_cur - cells[(best, cap)][1]) * gate.cfg["horizon_queries"]
    return io_cur, rebuild, best != gate.knob and saving > rebuild


def follow(ref: OnlineReference, warm_batches, stream, program) -> dict:
    """The compared numbers of a program run against the reference.

    ``program``: ``initial`` (the start's answer) and ``batches``, one
    entry a batch of the window in order: ``stream_index``, ``tv``,
    ``decision`` (None, or its ``cells``, ``est_io``, ``best``, ``cap``,
    ``io_current``, ``rebuild_io``, ``switched``) and, for the first
    evaluations, ``counts`` ({eps: (P,) tensor}).  Each answer is a dict
    of plain values (the driver unpacks the program's objects).
    """
    nums = {"tv_err": 0.0, "decision_miss": 0.0, "cap_miss": 0.0,
            "profile_err": 0.0, "hit_err": 0.0, "io_err": 0.0,
            "best_io_err": 0.0, "decision_err": 0.0}

    def judge(cells, answer):
        for key, (h, io, _dac) in answer["cells"].items():
            if key not in cells:
                continue
            rh, rio, _, _ = cells[key]
            nums["hit_err"] = max(nums["hit_err"], abs(h - rh))
            nums["io_err"] = max(nums["io_err"], abs(io - rio) / rio)
        nums["cap_miss"] += len(set(answer["cells"]) ^ set(cells))
        best = min(v[1] for v in cells.values())
        nums["best_io_err"] = max(nums["best_io_err"],
                                  abs(answer["est_io"] - best) / best)
        if answer.get("counts") is not None:
            m = ref.window_merged()
            for i, e in enumerate(ref.knobs):
                got = answer["counts"].get(e)
                want = m["counts"][i]
                err = (float("inf") if got is None else float(
                    (got.to(want.device, want.dtype) - want).abs().max()
                    / want.abs().max()))
                nums["profile_err"] = max(nums["profile_err"], err)

    for i, batch in enumerate(warm_batches):
        ref.push(("warm", i), batch)
    init = program["initial"]
    judge(ref.window_cells(), init)
    gate = Gate(ref.inp.serving, init["best"], init["cap"],
                ref.window_summary())
    for b in program["batches"]:
        j = b["stream_index"]
        ref.push(("stream", j), stream[j])
        tv = ref.tv(ref.window_summary(), gate.baseline)
        nums["tv_err"] = max(nums["tv_err"], abs(tv - b["tv"]))
        d = b["decision"]
        if gate.observe(tv) != (d is not None):
            nums["decision_miss"] += 1
        if d is None:
            continue
        cells = ref.window_cells()
        judge(cells, d)
        io_cur, rebuild, switched = decide(ref, gate, cells, d["best"],
                                           d["cap"])
        nums["decision_miss"] += float(switched != d["switched"])
        nums["decision_err"] = max(
            nums["decision_err"], abs(d["io_current"] - io_cur) / io_cur,
            abs(d["rebuild_io"] - rebuild) / rebuild)
        gate.evaluated(tv)
        if d["switched"]:       # follow the program's deployment
            gate.deploy(d["best"], d["cap"], ref.window_summary())
    return nums


def run_alone(ref: OnlineReference, warm_batches, stream, n_batches: int,
              keep_counts: int) -> dict:
    """The reference's own run over ``n_batches`` of the stream, shaped as
    a program run (the control: this class at a lower precision)."""

    def answer(cells, keep):
        best = ref.best(cells)
        m = ref.window_merged() if keep else None
        return {"cells": {k: v[:3] for k, v in cells.items()},
                "est_io": cells[best][1], "best": best[0], "cap": best[1],
                "counts": None if m is None else
                {e: m["counts"][i] for i, e in enumerate(ref.knobs)}}

    for i, batch in enumerate(warm_batches):
        ref.push(("warm", i), batch)
    init = answer(ref.window_cells(), True)
    gate = Gate(ref.inp.serving, init["best"], init["cap"],
                ref.window_summary())
    out, kept = [], 0
    for j in range(n_batches):
        ref.push(("stream", j % len(stream)), stream[j % len(stream)])
        tv = ref.tv(ref.window_summary(), gate.baseline)
        d = None
        if gate.observe(tv):
            cells = ref.window_cells()
            d = answer(cells, kept < keep_counts)
            kept += 1
            d["io_current"], d["rebuild_io"], d["switched"] = decide(
                ref, gate, cells, d["best"], d["cap"])
            gate.evaluated(tv)
            if d["switched"]:
                gate.deploy(d["best"], d["cap"], ref.window_summary())
        out.append({"stream_index": j % len(stream), "tv": tv,
                    "decision": d})
    return {"initial": init, "batches": out}
