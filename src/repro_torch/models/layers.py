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


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (``w`` 2-D) in the promoted type of the two, accumulated
    and returned in float32.

    Two bfloat16 operands stay bfloat16 on the card (cuBLAS writing its
    float32 accumulator, ``torch.mm(..., out_dtype=float32)``, through
    :class:`_MatmulF32`); on the CPU they widen to float32, where each
    product is exact and autograd differentiates it as it stands.
    """
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt != torch.float32 and x.device.type == "cuda":
        out = _bf16_f32(x.reshape(-1, x.shape[-1]).to(dt), w.to(dt))
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` (3-D operands) as :func:`matmul_f32`: the promoted
    type of the two, accumulated and returned in float32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    if dt != torch.float32 and a.device.type == "cuda":
        return _bf16_f32(a.to(dt), b.to(dt))
    return torch.bmm(a.float(), b.float())


def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down, ctx=None):
    g = matmul_f32(x, w_gate)
    u = matmul_f32(x, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    return matmul_f32(h, w_down).to(x.dtype)


def gelu_mlp(x, w_up, w_down, b_up=None, b_down=None, ctx=None):
    u = matmul_f32(x, w_up)
    if b_up is not None:
        u = u + b_up
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(u, approximate="tanh").to(x.dtype)
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


def take_embedding(table, tokens, ctx=None):
    """Token embedding lookup; table (V, D).  One device, so a gather."""
    return table[tokens]


def softmax_xent(logits, targets, ctx=None):
    """Mean next-token cross-entropy: logsumexp minus the target logit, in
    float32, averaged over every target (``targets`` (B, S), or (B, S, C)
    for the audio family's codebooks, indexing the last dim of
    ``logits``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None].long())[..., 0]
    return torch.mean(lse - ll)
