"""Mixture-of-Experts block: top-k routing, capacity-based scatter dispatch,
optional always-on shared experts (Qwen2-MoE style).

Mirrors ``repro/models/moe.py`` (the sort-free GShard scatter/gather
variant) with JAX's capacity semantics: capacity ``ceil(T·k·cf / E_pad)``
slots an expert, a token's slot the exclusive running count of earlier
(token, choice) pairs routed to the same expert, overflow dropped, the
padded experts never routed, and the Switch load-balance loss returned.
``.at[].add`` becomes ``index_put_(accumulate=True)``; the expert products
are batched matmuls (JAX leaves them to XLA, outside any Pallas kernel).

Under a mesh (:func:`_moe_block_mesh`) the tokens stay sharded on the batch
axes and the experts on "heads" (EP, as JAX constrains its dispatch): each
rank routes its own tokens, takes their slots from a global running count
(its own plus the per-expert counts of the token shards before it),
scatters those routed to the experts it holds into its part of the
dispatch (a partial sum over the token shards), and reads its tokens' rows
back from its experts (a sum over the expert shards).  The numbers are the
single-device ones.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import from_shard, is_dtensor
from repro_torch.models.layers import bmm_f32, matmul_f32

__all__ = ["moe_block", "route", "routing", "Routing"]


class Routing(NamedTuple):
    probs: torch.Tensor       # (T, E_logical) router softmax
    gates: torch.Tensor       # (T, k) renormalised top-k probabilities
    idx: torch.Tensor         # (T, k) chosen experts, best first
    slot: torch.Tensor        # (T*k,) place in the expert's buffer
    keep: torch.Tensor        # (T*k,) slot < capacity
    capacity: int


def route(xf, router_w, top_k: int, e_pad: int, capacity_factor: float,
          tok=None) -> Routing:
    """Top-k routing of tokens ``xf`` (T, D) and their dispatch slots
    (``tok`` as in :func:`routing`)."""
    probs = torch.softmax(matmul_f32(xf, router_w), dim=-1)
    _, idx = torch.topk(probs, top_k, dim=-1)
    return routing(probs, idx, e_pad, capacity_factor, tok)


def routing(probs, idx, e_pad: int, capacity_factor: float,
            tok=None) -> Routing:
    """The gates, slots and drops of top-k choices ``idx`` (T, k).

    A (token, choice) pair's slot is the number of earlier pairs (token
    major, choice minor) routed to the same expert; pairs at or past the
    capacity ``ceil(T·k·cf / E_pad)`` are dropped.  Under a mesh ``tok``
    is the pairs' token split (DTensor placements): ``slot`` and ``keep``
    are then this rank's pairs' (a plain tensor), each slot offset by the
    per-expert counts of the token shards before this rank's."""
    t, top_k = idx.shape
    gates = probs.gather(1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    capacity = int(max(1, -(-t * top_k * capacity_factor // e_pad)))
    flat_e = idx.reshape(-1) if tok is None else _local_pairs(idx, tok)
    onehot = F.one_hot(flat_e, e_pad)                           # (T*k, E_pad)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # slot per token
    if tok is not None:
        pos = pos + _earlier_shards(onehot.sum(0), idx.device_mesh, tok)
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    return Routing(probs, gates, idx, slot, slot < capacity, capacity)


def _local_pairs(idx, tok):
    """This rank's (token, choice) pairs of DTensor ``idx`` split ``tok``."""
    return idx.reshape(-1).redistribute(idx.device_mesh, tok).to_local()


def _earlier_shards(counts, mesh, tok):
    """The sum of ``counts`` (E,) over the token shards before this
    rank's, in the order the split ``tok`` lays them out."""
    from torch.distributed.tensor import DTensor, Shard
    every = DTensor.from_local(counts[None], mesh, tok,
                               run_check=False).full_tensor()
    coord, chunk = mesh.get_coordinate(), 0
    for i, p in enumerate(tok):
        if isinstance(p, Shard):
            chunk = chunk * mesh.size(i) + coord[i]
    return every[:chunk].sum(0)


def _load_balance(r: Routing, e_logical: int):
    """Switch's aux loss, E * sum_e f_e * p_e.  ``bincount`` has no DTensor
    rule: under a mesh the counts are a sum of comparisons."""
    t, top_k = r.idx.shape
    flat_e = r.idx.reshape(-1)
    if is_dtensor(flat_e):
        counts = (flat_e[:, None]
                  == torch.arange(e_logical, device=flat_e.device)).sum(0)
    else:
        counts = torch.bincount(flat_e, minlength=e_logical)
    return e_logical * torch.sum(r.probs.mean(0)
                                 * (counts.float() / (t * top_k)))


def _experts(dispatch, gate_w, up_w, down_w, dtype):
    """The experts' SwiGLU MLP on their (E, C, D) buffers."""
    g = bmm_f32(dispatch, gate_w)
    u = bmm_f32(dispatch, up_w)
    h = (F.silu(g) * u).to(dtype)
    return bmm_f32(h, down_w).to(dtype)


def moe_block(
    x: torch.Tensor,              # (B, S, D)
    router_w: torch.Tensor,       # (D, E_logical)
    gate_w: torch.Tensor,         # (E_pad, D, F)
    up_w: torch.Tensor,           # (E_pad, D, F)
    down_w: torch.Tensor,         # (E_pad, F, D)
    top_k: int,
    capacity_factor: float,
    ctx=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balance loss scalar)."""
    if ctx is not None and ctx.mesh is not None:
        return _moe_block_mesh(x, router_w, gate_w, up_w, down_w, top_k,
                               capacity_factor, ctx)
    b, s, d = x.shape
    e_pad = gate_w.shape[0]
    t = b * s
    xf = x.reshape(t, d)

    r = route(xf, router_w, top_k, e_pad, capacity_factor)
    aux = _load_balance(r, router_w.shape[-1])

    flat_e, keep = r.idx.reshape(-1), r.keep
    pos_c = torch.clamp(r.slot, max=r.capacity - 1)

    xk = torch.repeat_interleave(xf, top_k, dim=0)              # (T*k, D)
    contrib = torch.where(keep[:, None], xk, 0).to(x.dtype)
    dispatch = torch.zeros((e_pad, r.capacity, d), dtype=x.dtype,
                           device=x.device)
    dispatch.index_put_((flat_e, pos_c), contrib, accumulate=True)
    expert_out = _experts(dispatch, gate_w, up_w, down_w, x.dtype)

    gathered = expert_out[flat_e, pos_c]                        # (T*k, D)
    weighted = gathered * (r.gates.reshape(-1, 1) * keep[:, None]).to(x.dtype)
    out = weighted.reshape(t, top_k, d).sum(dim=1)
    return out.reshape(b, s, d), aux.float()


def _moe_block_mesh(x, router_w, gate_w, up_w, down_w, top_k: int,
                    capacity_factor: float, ctx):
    """:func:`moe_block` on DTensors under ``ctx``'s mesh: the routing is
    :func:`route`'s on the token shards; what differs is the dispatch to
    and the gather from the experts this rank holds."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ctx.mesh
    b, s, d = x.shape
    e_pad = gate_w.shape[0]
    nd = mesh.ndim
    coord = mesh.get_coordinate()
    # tokens split on the mesh dims that split the batch, else whole
    tok = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in x.placements]
    xf = x.reshape(b * s, d).redistribute(mesh, tok)
    r = route(xf, router_w, top_k, e_pad, capacity_factor, tok)
    aux = _load_balance(r, router_w.shape[-1])
    flat_e, keep = _local_pairs(r.idx, tok), r.keep
    pos_c = torch.clamp(r.slot, max=r.capacity - 1)

    # the experts this rank holds (EP: "heads" on the dispatch's dim 0)
    target = ctx.sharding((e_pad, r.capacity, d), ("heads", None, None))
    ep = [i for i, p in enumerate(target.placements)
          if isinstance(p, Shard) and not isinstance(tok[i], Shard)]
    n_e, e_idx = 1, 0
    for i in ep:
        n_e *= mesh.size(i)
        e_idx = e_idx * mesh.size(i) + coord[i]
    e_loc = e_pad // n_e
    lo = e_idx * e_loc
    mine = (flat_e >= lo) & (flat_e < lo + e_loc)
    le = torch.clamp(flat_e - lo, 0, e_loc - 1)

    # dispatch: this rank's tokens into its experts' slots, a partial sum
    # over the token shards (each expert shard sees the gradient of the
    # tokens it took, so the tokens' gradient sums over expert shards)
    xk = torch.repeat_interleave(xf.to_local(grad_placements=[
        Partial() if i in ep else tok[i] for i in range(nd)]), top_k, dim=0)
    contrib = torch.where((keep & mine)[:, None], xk, 0).to(x.dtype)
    local = torch.zeros((e_loc, r.capacity, d), dtype=x.dtype,
                        device=xk.device)
    local.index_put_((le, pos_c), contrib, accumulate=True)
    part = [Shard(0) if i in ep else
            Partial() if isinstance(tok[i], Shard) else Replicate()
            for i in range(nd)]
    dispatch = from_shard(local, mesh, part, (e_pad, r.capacity, d))
    dispatch = ctx.constrain(dispatch, "heads", None, None)  # experts -> EP

    expert_out = _experts(dispatch, gate_w, up_w, down_w, x.dtype)

    # each rank reads its tokens' rows from the experts it holds (zeros
    # for the others); the rows sum over the expert shards, and their
    # gradients over the token shards
    held = [Shard(0) if i in ep else Replicate() for i in range(nd)]
    rows = expert_out.redistribute(mesh, held).to_local(grad_placements=[
        Shard(0) if i in ep else
        Partial() if isinstance(tok[i], Shard) else Replicate()
        for i in range(nd)])
    picked = rows[le, pos_c] * mine[:, None].to(x.dtype)
    gathered = from_shard(
        picked, mesh, [Partial() if i in ep else tok[i] for i in range(nd)],
        (b * s * top_k, d)).redistribute(mesh, tok).to_local()
    g_loc = r.gates.reshape(-1).redistribute(mesh, tok).to_local()
    weighted = gathered * (g_loc[:, None] * keep[:, None]).to(x.dtype)
    out = weighted.reshape(-1, top_k, d).sum(dim=1)
    out = from_shard(out, mesh, tok, (b * s, d))
    return out.reshape(b, s, d), aux.float()
