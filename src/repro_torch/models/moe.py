"""Mixture-of-Experts block: top-k routing, capacity-based scatter dispatch,
optional always-on shared experts (Qwen2-MoE style).

Mirrors ``repro/models/moe.py`` (the sort-free GShard scatter/gather
variant) with JAX's capacity semantics: capacity ``ceil(T·k·cf / E_pad)``
slots an expert, a token's slot the exclusive running count of earlier
(token, choice) pairs routed to the same expert, overflow dropped, the
padded experts never routed, and the Switch load-balance loss returned.
``.at[].add`` becomes ``index_put_(accumulate=True)``; the expert products
are batched matmuls (JAX leaves them to XLA, outside any Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import bmm_f32, matmul_f32

__all__ = ["moe_block", "route", "routing", "Routing"]


class Routing(NamedTuple):
    probs: torch.Tensor       # (T, E_logical) router softmax
    gates: torch.Tensor       # (T, k) renormalised top-k probabilities
    idx: torch.Tensor         # (T, k) chosen experts, best first
    slot: torch.Tensor        # (T*k,) place in the expert's buffer
    keep: torch.Tensor        # (T*k,) slot < capacity
    capacity: int


def route(xf, router_w, top_k: int, e_pad: int,
          capacity_factor: float) -> Routing:
    """Top-k routing of tokens ``xf`` (T, D) and their dispatch slots."""
    probs = torch.softmax(matmul_f32(xf, router_w), dim=-1)
    _, idx = torch.topk(probs, top_k, dim=-1)
    return routing(probs, idx, e_pad, capacity_factor)


def routing(probs, idx, e_pad: int, capacity_factor: float) -> Routing:
    """The gates, slots and drops of top-k choices ``idx`` (T, k).

    A (token, choice) pair's slot is the number of earlier pairs (token
    major, choice minor) routed to the same expert; pairs at or past the
    capacity ``ceil(T·k·cf / E_pad)`` are dropped."""
    t, top_k = idx.shape
    gates = probs.gather(1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    capacity = int(max(1, -(-t * top_k * capacity_factor // e_pad)))
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, e_pad)                           # (T*k, E_pad)
    pos = torch.cumsum(onehot, dim=0) - onehot                  # slot per token
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    return Routing(probs, gates, idx, slot, slot < capacity, capacity)


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
    b, s, d = x.shape
    e_logical = router_w.shape[-1]
    e_pad = gate_w.shape[0]
    t = b * s
    xf = x.reshape(t, d)

    r = route(xf, router_w, top_k, e_pad, capacity_factor)

    # Load-balance aux loss (Switch): E * sum_e f_e * p_e.
    me = r.probs.mean(0)
    ce = torch.bincount(r.idx.reshape(-1), minlength=e_logical).float() \
        / (t * top_k)
    aux = e_logical * torch.sum(me * ce)

    flat_e, keep = r.idx.reshape(-1), r.keep
    pos_c = torch.clamp(r.slot, max=r.capacity - 1)

    xk = torch.repeat_interleave(xf, top_k, dim=0)              # (T*k, D)
    contrib = torch.where(keep[:, None], xk, 0).to(x.dtype)
    dispatch = torch.zeros((e_pad, r.capacity, d), dtype=x.dtype,
                           device=x.device)
    dispatch.index_put_((flat_e, pos_c), contrib, accumulate=True)

    g = bmm_f32(dispatch, gate_w)
    u = bmm_f32(dispatch, up_w)
    h = (F.silu(g) * u).to(x.dtype)
    expert_out = bmm_f32(h, down_w).to(x.dtype)

    gathered = expert_out[flat_e, pos_c]                        # (T*k, D)
    weighted = gathered * (r.gates.reshape(-1, 1) * keep[:, None]).to(x.dtype)
    out = weighted.reshape(t, top_k, d).sum(dim=1)
    return out.reshape(b, s, d), aux.float()
