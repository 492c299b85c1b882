"""Shared neural layers: RMSNorm, MLPs, RoPE / M-RoPE, embeddings.

Mirrors ``repro/models/layers.py`` in eager PyTorch.  Weights come in as
dict leaves.  JAX writes every product as ``jnp.einsum(...,
preferred_element_type=float32)``; :func:`matmul_f32` is its counterpart:
the operands meet in their promoted type (a bfloat16 activation against
float32 weights computes in float32, as JAX promotes) and the float32
accumulator comes back unrounded.  Both products are differentiable on
every device (see :class:`_MatmulF32`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import from_shard, is_dtensor

__all__ = ["matmul_f32", "bmm_f32", "rms_norm", "swiglu", "gelu_mlp", "rope", "mrope",
           "take_embedding", "softmax_xent"]


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of two bfloat16 card tensors (2-D, or 3-D batched) with
    the float32 accumulator returned, and its derivative.

    cuBLAS's ``out_dtype=float32`` products have no autograd formula, so
    this gives one.  The forward is the serving path's product unchanged.
    The backward runs its two products on the tensor cores too: the
    float32 cotangent is rounded to bfloat16, each product accumulates in
    float32 and is rounded once to its operand's dtype, as JAX's transpose
    of a ``preferred_element_type=float32`` dot returns the primal's dtype.
    Rounding the cotangent is what a TPU's default-precision dot does to a
    float32 operand; a float32 backward would run on the CUDA cores, at
    1/15 of the tensor-core rate, products twice the forward's size.
    """

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        mm = torch.mm if a.dim() == 2 else torch.bmm
        g = g.to(torch.bfloat16)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = mm(g, b.transpose(-1, -2), out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = mm(a.transpose(-1, -2), g, out_dtype=torch.float32).to(b.dtype)
        return da, db


def _bf16_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cuBLAS's float32 accumulator of two bfloat16 operands, through
    :class:`_MatmulF32` only where autograd needs it (its Python
    bookkeeping would slow the host-bound serve path)."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


def dtensor_mm(a, b, local_mm):
    """``local_mm`` (a product of 2-D, or 3-D batched, local tensors) of
    two DTensors on one mesh, as a DTensor.  DTensor has no sharding rule
    for the ``out_dtype`` products, and its own choices for ``torch.mm``
    (in the backward above all) can split the token dim over several mesh
    dims, a layout that does not trace under ``FakeTensorMode``; this rule
    is ``torch.mm``'s and predictable.  On each mesh dim the operands are
    first redistributed to one of five forms: both sharded on the batch
    dim (out sharded there), ``a``'s rows sharded and ``b`` whole (out on
    rows), ``b``'s columns sharded and ``a`` whole (out on columns), the
    contraction sharded on both (out ``Partial``), or both whole.
    Gradients get the placements the product implies (``Partial`` where
    the forward split the other operand's free dim)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(a, DTensor):
        a = DTensor.from_local(a, mesh, rep, run_check=False)
    if not isinstance(b, DTensor):
        b = DTensor.from_local(b, mesh, rep, run_check=False)
    nd = a.dim()
    rows, inner, cols = nd - 2, nd - 1, nd - 1   # a's rows and k, b's cols
    pa, pb, po, ga, gb = [], [], [], [], []
    for xa, xb in zip(a.placements, b.placements):
        sa = xa.dim % nd if isinstance(xa, Shard) else None
        sb = xb.dim % nd if isinstance(xb, Shard) else None
        # (a, b, out, a's gradient, b's gradient)
        if nd == 3 and 0 in (sa, sb):
            form = (Shard(0),) * 5
        elif sa == rows:
            form = (Shard(rows), Replicate(), Shard(rows), Shard(rows),
                    Partial())
        elif sb == cols:
            form = (Replicate(), Shard(cols), Shard(cols), Partial(),
                    Shard(cols))
        elif sa == inner or sb == nd - 2:
            form = (Shard(inner), Shard(nd - 2), Partial(), Shard(inner),
                    Shard(nd - 2))
        else:
            form = (Replicate(),) * 5
        for lst, p in zip((pa, pb, po, ga, gb), form):
            lst.append(p)
    la = a.redistribute(mesh, pa).to_local(grad_placements=ga)
    lb = b.redistribute(mesh, pb).to_local(grad_placements=gb)
    return from_shard(local_mm(la, lb), mesh, po,
                      (*a.shape[:-1], b.shape[-1]))


def _whole_middle(x):
    """DTensor ``x`` with no dim split but its first and last: merged into
    rows, a split middle dim (DTensor may split the sequence where GSPMD
    would) would need a layout DTensor cannot trace."""
    from torch.distributed.tensor import Replicate, Shard
    nd = x.dim()
    want = [Replicate() if isinstance(p, Shard) and 0 < p.dim % nd < nd - 1
            else p for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _rows(x):
    """A tensor (..., K) as (T, K) rows, a DTensor's middle dims whole."""
    if is_dtensor(x):
        x = _whole_middle(x)
    return x.reshape(-1, x.shape[-1])


class _RowsGrad(torch.autograd.Function):
    """Identity whose gradient, on its way back to :func:`_rows`' merged
    rows, has its middle dims whole (see :func:`_rows`)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _whole_middle(g)
        loc = g.to_local()
        if loc.is_contiguous():
            return g
        # the reshape before takes a view of it: a split of the last dim
        # leaves the local shard strided while the DTensor is contiguous
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(loc.contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (``w`` 2-D) in the promoted type of the two, accumulated
    and returned in float32.

    Two bfloat16 operands stay bfloat16 on the card (cuBLAS writing its
    float32 accumulator, ``torch.mm(..., out_dtype=float32)``, through
    :class:`_MatmulF32`); on the CPU they widen to float32, where each
    product is exact and autograd differentiates it as it stands.
    """
    if is_dtensor(x) or is_dtensor(w):
        out = dtensor_mm(_rows(x), w, _local_f32)
        return _RowsGrad.apply(out.reshape(*x.shape[:-1], w.shape[-1]))
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt != torch.float32 and x.device.type == "cuda":
        out = _bf16_f32(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt))
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (3-D operands) as :func:`matmul_f32`: the promoted
    type of the two, accumulated and returned in float32."""
    if is_dtensor(a) or is_dtensor(b):
        return dtensor_mm(a, b, _local_f32)
    return _local_f32(a, b)


def _local_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 product of two 2-D or 3-D local tensors (the body of
    :func:`bmm_f32`)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt != torch.float32 and a.device.type == "cuda":
        return _bf16_f32(a.to(dt), b.to(dt))
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a.float(), b.float())


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, ctx=None):
    g = matmul_f32(x, w_gate)
    u = matmul_f32(x, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    if ctx is not None:
        h = ctx.constrain(h, "batch", None, "heads")
    return matmul_f32(h, w_down).to(x.dtype)


def gelu_mlp(x, w_up, w_down, b_up=None, b_down=None, ctx=None):
    u = matmul_f32(x, w_up)
    if b_up is not None:
        u = u + b_up
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(u, approximate="tanh").to(x.dtype)
    if ctx is not None:
        h = ctx.constrain(h, "batch", None, "heads")
    out = matmul_f32(h, w_down)
    if b_down is not None:
        out = out + b_down
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # a Python-float base, as JAX's weakly typed ``theta ** x``: a tensor
    # built from it would be a blocking host-to-device copy every layer
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** expo)


def _apply_rot(x, cos, sin):
    """Split-halves rotation (not the interleaved one), as JAX's."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x, positions, theta: float = 1e6):
    """x: (B, S, H, D); positions: (B, S) int absolute positions."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                      # (D/2,)
    ang = positions[..., None].float() * freqs                   # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _apply_rot(x.float(), cos, sin).to(x.dtype)


def mrope(x, positions_3d, sections, theta: float = 1e6):
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, D); positions_3d: (3, B, S) — (temporal, height, width) ids.
    ``sections`` split the D/2 frequency slots among the three id channels.
    """
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} must sum to {d // 2}")
    freqs = _rope_freqs(d, theta, x.device)
    channel = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device))              # (D/2,)
    pos = positions_3d.float()[channel]                          # (D/2, B, S)
    ang = torch.movedim(pos, 0, -1) * freqs                      # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return _apply_rot(x.float(), cos, sin).to(x.dtype)


def _one_hot(idx, n: int, dtype):
    """``idx`` (...,) as (..., n) one-hot rows of ``dtype``: a comparison
    against ``arange(n)``, which DTensor shards as ``idx`` is sharded."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _splits(x, dim: int) -> bool:
    """Whether DTensor ``x`` is split along ``dim`` on some mesh dim."""
    from torch.distributed.tensor import Shard
    return any(isinstance(p, Shard) and p.dim % x.dim() == dim % x.dim()
               for p in x.placements)


def _gather_rows(table, tokens):
    """``table[tokens]`` of a DTensor table whose vocab dim is whole: each
    rank gathers its tokens' rows from its part of the table (the rows'
    dim split where the table's is and the tokens are whole), and the
    table's gradient sums over the token shards.  The same gather and
    gradient as without a mesh."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tok = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in tokens.placements]
    cols = [Shard(1) if isinstance(p, Shard) and p.dim % 2 == 1
            and not isinstance(tok[i], Shard) else Replicate()
            for i, p in enumerate(table.placements)]
    rows = table.redistribute(mesh, cols).to_local(grad_placements=[
        Partial() if isinstance(tok[i], Shard) else cols[i]
        for i in range(mesh.ndim)])
    out = rows[tokens.redistribute(mesh, tok).to_local()]
    return from_shard(out, mesh, [
        tok[i] if isinstance(tok[i], Shard) else
        Shard(out.dim() - 1) if isinstance(cols[i], Shard) else Replicate()
        for i in range(mesh.ndim)], (*tokens.shape, table.shape[1]))


def take_embedding(table, tokens, ctx=None):
    """Token embedding lookup; table (V, D) possibly vocab-sharded.

    Without a mesh, a gather.  Under a mesh with the vocab split, as JAX:
    the one-hot product keeps the contraction sharded over V (a
    partial-sum all-reduce of the small (B, S, D) output instead of an
    all-gather of the table); with the vocab whole, the gather on each
    rank's part (:func:`_gather_rows`).  The product has one nonzero term a
    row, so the values are the gather's; the gather also keeps the
    table's gradient summed as without a mesh (in bfloat16 the product's
    float32 accumulation would round it otherwise).
    """
    if ctx is None or ctx.mesh is None:
        return table[tokens]
    if not _splits(table, 0):
        out = _gather_rows(table, tokens)
        return ctx.constrain(out, "batch", *([None] * (out.dim() - 2)),
                             None)
    onehot = _one_hot(tokens, table.shape[0], table.dtype)
    onehot = ctx.constrain(onehot, "batch", *([None] * (tokens.dim() - 1)),
                           "heads")
    out = matmul_f32(onehot, table).to(table.dtype)
    return ctx.constrain(out, "batch", *([None] * (out.dim() - 2)), None)


def softmax_xent(logits, targets, ctx=None):
    """Mean next-token cross-entropy: logsumexp minus the target logit, in
    float32, averaged over every target (``targets`` (B, S), or (B, S, C)
    for the audio family's codebooks, indexing the last dim of
    ``logits``).

    Under a mesh with the logits vocab-sharded, the target logit is a
    one-hot contraction, as JAX's (exact: one nonzero term a row), and the
    log-sum-exp is written out (max, then the sum of exponentials), which
    DTensor reduces over the split vocab without gathering it.  With the
    vocab whole, the single-device ops."""
    logits = logits.float()
    if ctx is None or ctx.mesh is None or not _splits(logits, -1):
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, targets[..., None].long())[..., 0]
        return torch.mean(lse - ll)
    m = logits.detach().amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    onehot = _one_hot(targets, logits.shape[-1], torch.bfloat16)
    dims = ("batch",) + (None,) * (targets.dim() - 1) + ("heads",)
    onehot = ctx.constrain(onehot, *dims)
    ll = (logits * onehot.float()).sum(dim=-1)
    return torch.mean(lse - ll)
