"""Attention implementations, mirroring ``repro/models/attention.py``.

* ``blockwise_attention`` — streaming softmax over KV blocks with an
  (m, l, acc) carry (a Python loop where JAX has ``lax.scan``), so the
  (S x S) score matrix never exists at once;
* ``dense_attention`` — explicit scores and causal mask (short sequences,
  test oracle);
* ``decode_attention`` — one query token of GQA against a static KV cache
  with per-sequence lengths;
* ``attention`` — the dispatch the transformer block calls.

``impl="pallas"`` names the hand-written kernels (the JAX package's Pallas
kernels become CUDA kernels in the port): prefill goes to
``kernels.flash_attention`` and decode to ``kernels.decode_attention``.
Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors or raises; nothing falls back.  The wrappers take
local tensors only: on a mesh, every ``impl`` runs on each rank's aligned
shards (``_on_shards``).  The JAX decode step
always uses the plain einsum version; the port routes decode through the
kernel under ``"pallas"`` because that kernel computes the same function.
Neither kernel has a backward: a wrapper given inputs that require grad
raises, as JAX's gradient through its Pallas flash kernel fails, so
training takes ``"blockwise"`` (the ``Recipe`` default).

Scores accumulate in float32 from float32 copies of the operands, which is
what ``preferred_element_type=float32`` gives for bfloat16 inputs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import from_shard, is_dtensor
from repro_torch.kernels import ops as kernel_ops

__all__ = ["dense_attention", "blockwise_attention", "decode_attention",
           "attention"]

_NEG_INF = -1e30


def _group_heads(q, num_kv_heads):
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv_heads, h // num_kv_heads, d)


def dense_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B,Sq,H,D), k/v: (B,Skv,Hk,D).  Test oracle / short sequences."""
    b, sq, h, d = q.shape
    hk = k.shape[2]
    qg = _group_heads(q, hk)                                   # (B,Sq,Hk,G,D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        block_kv: int = 1024):
    """Streaming-softmax attention over KV blocks with an (m, l, acc) carry —
    O(Sq * block_kv) live memory instead of O(Sq * Skv)."""
    b, sq, h, d = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    block_kv = min(block_kv, skv)
    qg = _group_heads(q, hk).float()                           # (B,Sq,Hk,G,D)
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(sq, device=q.device) + q_offset

    m = torch.full((b, hk, g, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hk, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hk, g, sq, d), dtype=torch.float32,
                      device=q.device)
    for start in range(0, skv, block_kv):
        kblk = k[:, start:start + block_kv].float()
        vblk = v[:, start:start + block_kv].float()
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kblk) * scale
        # JAX pads the last block with masked keys; once block 0 has set a
        # real running max their weight is exactly 0, so the port slices
        if causal:
            kpos = start + torch.arange(kblk.shape[1], device=q.device)
            scores = torch.where(qpos[:, None] >= kpos[None, :], scores,
                                 _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)           # (B,Hk,G,Sq,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, lengths, *,
                     impl: str = "blockwise"):
    """One-token GQA decode against a static cache.

    q: (B,1,H,D); caches: (B,Smax,Hk,D); lengths: (B,) valid prefix lengths.
    ``impl="pallas"`` goes through ``kernels.decode_attention`` (the CUDA
    kernel on CUDA tensors, its plain version on CPU tensors).
    """
    if impl == "pallas":
        if is_dtensor(q):
            # the kernel on each rank's shards; the cache's length split
            # is gathered (an all-gather a layer and step where the mesh
            # splits it)
            return _on_shards(kernel_ops.decode_attention, q, k_cache,
                              v_cache, lengths)
        return kernel_ops.decode_attention(q, k_cache, v_cache, lengths)
    if is_dtensor(q):
        return _decode_on_mesh(q, k_cache, v_cache, lengths)
    b, _, h, d = q.shape
    hk = k_cache.shape[2]
    qg = _group_heads(q, hk)[:, 0]                             # (B,Hk,G,D)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float())
    scores = scores / math.sqrt(d)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, :] < lengths[:, None]                    # (B,Smax)
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def _decode_on_mesh(q, k_cache, v_cache, lengths):
    """``decode_attention`` of a DTensor q on each rank's shards, the
    caches' length split kept (no cache moves between ranks): each rank
    scores its part of the cache, and the parts combine as flash-decode's
    splits do — the running max by an all-reduce of ``max``, the softmax
    sums and the weighted values by an all-reduce of sums over the mesh
    dims that split the length.  The caches keep their batch split (q's
    rows follow it) and their KV-head split where the Hk heads divide by
    the mesh dims (q's heads follow it); any other split of theirs is
    gathered.  The products run on local tensors: DTensor's einsum merges
    a batch and a head split into one strided dim, which does not trace
    under ``FakeTensorMode`` (the dry run)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = q.device_mesh
    b, _, h, d = q.shape
    hk = k_cache.shape[2]
    rep = [Replicate()] * mesh.ndim

    def whole(x):
        return x if is_dtensor(x) else DTensor.from_local(
            x, mesh, rep, run_check=False)

    k_cache, v_cache, lengths = (whole(x) for x in (k_cache, v_cache,
                                                    lengths))
    cache_pl = []
    for i, p in enumerate(k_cache.placements):
        keep = p in (Shard(0), Shard(1)) or (p == Shard(2)
                                             and hk % mesh.size(i) == 0)
        cache_pl.append(p if keep else Replicate())
    heads = math.prod(mesh.size(i) for i, p in enumerate(cache_pl)
                      if p == Shard(2))
    if hk % heads:                  # several mesh dims split the heads
        cache_pl = [Replicate() if p == Shard(2) else p for p in cache_pl]
    q_pl = [p if p in (Shard(0), Shard(2)) else Replicate()
            for p in cache_pl]
    row_pl = [p if p == Shard(0) else Replicate() for p in cache_pl]
    # (B, Hk, G) statistics: the batch and head splits, partial over length
    stat_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
               else None for p in cache_pl]

    kl, vl = (x.redistribute(mesh, cache_pl).to_local()
              for x in (k_cache, v_cache))
    ql = q.redistribute(mesh, q_pl).to_local()
    ll = lengths.redistribute(mesh, row_pl).to_local()
    # where this rank's part of the length starts: its chunk, major to
    # minor over the mesh dims that split it (evenly: a spec splits only
    # what divides)
    chunk, coord = 0, mesh.get_coordinate()
    for i, p in enumerate(cache_pl):
        if p == Shard(1):
            chunk = chunk * mesh.size(i) + coord[i]
    start = chunk * kl.shape[1]

    qg = _group_heads(ql, kl.shape[2])[:, 0]                   # (b,hk,G,D)
    scores = torch.einsum("bkgd,btkd->bkgt", qg.float(), kl.float())
    scores = scores / math.sqrt(d)
    kpos = start + torch.arange(kl.shape[1], device=ql.device)
    mask = kpos[None, :] < ll[:, None]
    scores = torch.where(mask[:, None, None, :], scores, _NEG_INF)
    g = h // hk

    def combine(x, op):
        shape = (b, hk, g) + tuple(x.shape[3:])
        pl = [Partial(op) if p is None and c == Shard(1) else
              p if p is not None else Replicate()
              for p, c in zip(stat_pl, cache_pl)]
        want = [Replicate() if isinstance(p, Partial) else p for p in pl]
        return from_shard(x, mesh, pl, shape).redistribute(
            mesh, want).to_local()

    m = combine(scores.amax(dim=-1), "max")                    # (b,hk,G)
    p = torch.exp(scores - m[..., None])
    l_sum = combine(p.sum(dim=-1), "sum")
    acc = combine(torch.einsum("bkgt,btkd->bkgd", p, vl.float()), "sum")
    out = (acc / l_sum[..., None]).reshape(ql.shape).to(q.dtype)
    return from_shard(out, mesh, q_pl, q.shape)


def _on_shards(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` on each rank's shards of DTensor q/k/v:
    attention is independent across batch rows and KV-head groups, so the
    shards are first aligned (k and v take q's batch split; heads stay
    split where both H and Hk divide by the mesh dim, else are whole;
    every other dim, a cache's length too, whole) and the output keeps
    q's placements.  ``rows`` (per-row tensors such as decode's lengths,
    DTensors or the same plain tensor on every rank) follow q's batch
    split.  ``fn`` then sees plain tensors (DTensor's merged-dim
    shardings of the 5-D products do not trace under ``FakeTensorMode``,
    and the CUDA kernels take local tensors), and the numbers are the
    unsharded ones."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    pl = _aligned(q, k.shape[2])
    loc = [x.redistribute(mesh, pl).to_local() for x in (q, k, v)]
    by_row = [p if p == Shard(0) else Replicate() for p in pl]
    for x in rows:
        if not is_dtensor(x):
            x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        loc.append(x.redistribute(mesh, by_row).to_local())
    return from_shard(fn(*loc), mesh, pl, q.shape)


def _aligned(q, hk: int):
    """q's placements with its shards aligned to the KV-head groups: the
    batch split kept, the heads split only where the Hk KV heads divide by
    the mesh dims that split them (so (H,) -> (Hk, G) keeps the split),
    everything else whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    pl = []
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and hk % mesh.size(i) == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    heads = math.prod(mesh.size(i) for i, p in enumerate(pl)
                      if p == Shard(2))
    if hk % heads:                  # several mesh dims split the heads
        pl = [Replicate() if p == Shard(2) else p for p in pl]
    return pl


def attention(q, k, v, *, impl: str = "blockwise", causal: bool = True,
              q_offset: int = 0, block_kv: int = 1024):
    if is_dtensor(q):
        return _on_shards(
            lambda q_, k_, v_: attention(q_, k_, v_, impl=impl, causal=causal,
                                         q_offset=q_offset,
                                         block_kv=block_kv), q, k, v)
    if impl == "dense" or q.shape[1] <= 256:
        return dense_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "pallas":
        if q_offset:
            raise ValueError("the flash-attention kernel takes q_offset 0 "
                             f"only, got {q_offset}")
        return kernel_ops.flash_attention(q, k, v, causal=causal)
    return blockwise_attention(q, k, v, causal=causal, q_offset=q_offset,
                               block_kv=block_kv)
