"""AdamW with dtype-configurable moments (fp32 / bf16 / int8).

Mirrors ``repro/train/optimizer.py``.  int8 moments ("8-bit Adam") store a
per-tensor absmax scale: ``{"q": int8 values, "s": float32 scale}``.

Where JAX's jitted step donates the parameters and moments and gets new
ones back, :func:`adamw_update` writes them in place under
``torch.no_grad()``, one layer slice of a layer-stacked leaf at a time:
an eager out-of-place update of starcoder2-3b's stacked ``w_up``
(30 x 3072 x 12288 float32, 4.5 GB) would make several temporaries of
that size.  The update's arithmetic is JAX's, in float32.

Leaves are walked in ``jax.tree.leaves``' order (dict keys sorted), which
fixes ``global_norm``'s order of summation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

from repro_torch.models.params import _STACKED

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "leaves", "layer_slices", "map_tree"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"    # float32 | bfloat16 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_schedule(cfg: AdamWConfig) -> Callable:
    """Linear warmup then cosine decay; ``lr(step)`` is a float32 0-d
    tensor on ``step``'s device (a CPU one for a Python int)."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * frac))
    return lr


# ---------------------------------------------------------------------------
# Tree walking
# ---------------------------------------------------------------------------

def _is_quant(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "s"}


def leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in ``jax.tree.leaves`` order: dict keys
    sorted.  An int8 moment ``{"q", "s"}`` is one leaf."""
    if isinstance(tree, dict) and not _is_quant(tree):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def layer_slices(path: Tuple[str, ...], x: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``x`` a layer each when ``path`` names a layer-stacked
    leaf (under ``blocks``, or a (g, k) layer of ``mamba``), else ``[x]``."""
    lead = _STACKED.get(path[0], 0) if path else 0
    return list(x.flatten(0, lead - 1).unbind(0)) if lead else [x]


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict (keys kept)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# Quantized moment storage
# ---------------------------------------------------------------------------

def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(absmax, min=1e-12) / 127.0


def _quantize_with(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # torch.round, like jnp.round, rounds half to even
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    scale = _scale_of(torch.max(torch.abs(x)))
    return {"q": _quantize_with(x, scale), "s": scale.to(torch.float32)}


def _dequantize(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    return m["q"].to(torch.float32) * m["s"]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _store(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(_DTYPES[dtype])


def _load(m, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(m)
    return m.to(torch.float32)


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.moment_dtype`` beside ``params``, and a 0-d
    int32 step, all on the parameters' device."""
    def zero_like(p):
        return _store(torch.zeros_like(p, dtype=torch.float32),
                      cfg.moment_dtype)

    dev = next(leaves(params))[1].device
    return {"m": map_tree(zero_like, params),
            "v": map_tree(zero_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf (a layer slice at a time) in ``jax.tree.leaves`` order."""
    total = 0.0
    for path, x in leaves(tree):
        for part in layer_slices(path, x):
            total = total + torch.sum(torch.square(part.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------

def _moments(g, m, v, cfg: AdamWConfig, scale):
    """The new float32 moments of one slice (JAX's expressions)."""
    g = g.to(torch.float32) * scale
    m_f = cfg.b1 * m + (1 - cfg.b1) * g
    v_f = cfg.b2 * v + (1 - cfg.b2) * g * g
    return m_f, v_f


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr_fn: Callable) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params`` and ``opt_state`` in place.

    Returns ``(params, opt_state, {"grad_norm", "lr"})``: the same trees,
    updated, with ``opt_state["step"]`` advanced by one.  An int8 moment's
    scale covers its whole leaf, so an int8 leaf takes two passes over its
    slices: the new moments' absmax first, then the update.
    """
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_fn(step)
    t = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    dt = cfg.moment_dtype
    is_q = dt == "int8"

    flat_g = [g for _, g in leaves(grads)]
    flat_m = [m for _, m in leaves(opt_state["m"])]
    flat_v = [v for _, v in leaves(opt_state["v"])]
    for (path, p), g, m, v in zip(leaves(params), flat_g, flat_m, flat_v):
        ps, gs = layer_slices(path, p), layer_slices(path, g)
        ms = layer_slices(path, m["q"] if is_q else m)
        vs = layer_slices(path, v["q"] if is_q else v)

        def new_moments(i):
            m_i, v_i = ms[i], vs[i]
            if is_q:
                m_i, v_i = {"q": m_i, "s": m["s"]}, {"q": v_i, "s": v["s"]}
            return _moments(gs[i], _load(m_i, dt), _load(v_i, dt), cfg,
                            scale)

        if is_q:
            m_max = v_max = torch.zeros((), device=p.device)
            for i in range(len(ps)):
                m_f, v_f = new_moments(i)
                m_max = torch.maximum(m_max, m_f.abs().max())
                v_max = torch.maximum(v_max, v_f.abs().max())
            m_scale, v_scale = _scale_of(m_max), _scale_of(v_max)
        for i in range(len(ps)):
            m_f, v_f = new_moments(i)
            pf = ps[i].to(torch.float32)
            upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps) \
                + cfg.weight_decay * pf
            ps[i].copy_(pf - lr * upd)
            ms[i].copy_(_quantize_with(m_f, m_scale) if is_q else m_f)
            vs[i].copy_(_quantize_with(v_f, v_scale) if is_q else v_f)
        if is_q:
            m["s"].copy_(m_scale)
            v["s"].copy_(v_scale)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
