"""The port's attention and Che kernels' plain versions, layers and
attention functions against the JAX package on shared numpy inputs (CPU).

The JAX side runs its Pallas kernels in interpret mode (``ops.*(...,
interpret=True)``) and its jnp oracles (``kernels/ref.py``); the port's
kernel wrappers take their plain PyTorch versions on CPU tensors.
Tolerances are the JAX package's own (``tests/test_kernels.py``): 1e-4 in
float32, 2e-2 in bfloat16, rtol 1e-4 / atol 1e-3 on Che sums; layers and
attention functions in float32 to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bfloat16" else 1e-4


def _pair(rng, shape, dtype="float32"):
    """The same normal draws as a JAX array and a torch tensor."""
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(td)


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# kernels: flash attention, decode attention, Che sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,sq,h,hk,d", [
    (1, 64, 4, 4, 32),        # MHA
    (2, 128, 4, 2, 64),       # GQA 2:1
    (2, 96, 8, 1, 64),        # MQA, ragged seq vs 64-blocks
    (1, 256, 4, 2, 128),      # full head dim
    (1, 300, 14, 2, 128),     # GQA 7:1 (yi-34b's group), ragged
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(b, sq, h, hk, d, dtype, causal):
    rng = np.random.default_rng(b * sq + h + d)
    jq, tq = _pair(rng, (b, sq, h, d), dtype)
    jk, tk = _pair(rng, (b, sq, hk, d), dtype)
    jv, tv = _pair(rng, (b, sq, hk, d), dtype)
    out = tops.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    jout = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_kv=64, interpret=True)
    _close(out, jout, _tol(dtype))
    _close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal),
           _tol(dtype))


def test_flash_attention_refuses_causal_with_offset_lengths():
    q = torch.zeros((1, 8, 2, 32))
    kv = torch.zeros((1, 12, 2, 32))
    with pytest.raises(ValueError, match="Sq == Skv"):
        tops.flash_attention(q, kv, kv, causal=True)
    out = tops.flash_attention(q, kv, kv, causal=False)
    assert out.shape == q.shape


@pytest.mark.parametrize("b,s,h,hk,d", [
    (2, 256, 4, 2, 64),
    (3, 130, 8, 8, 32),
    (1, 512, 8, 2, 128),
    (2, 300, 14, 2, 128),     # GQA 7:1
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_attention_matches_jax(b, s, h, hk, d, dtype):
    rng = np.random.default_rng(b * s + h)
    jq, tq = _pair(rng, (b, 1, h, d), dtype)
    jk, tk = _pair(rng, (b, s, hk, d), dtype)
    jv, tv = _pair(rng, (b, s, hk, d), dtype)
    lens = np.asarray([max(1, s // (i + 2)) for i in range(b)], np.int32)
    out = tops.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    jout = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_kv=64,
                                 interpret=True)
    _close(out, jout, _tol(dtype))
    _close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           _tol(dtype))


def test_decode_attention_empty_and_overlong_lengths_match_oracle():
    """A length of 0 averages V over the whole cache (every score is the
    -1e30 fill); a length past the cache reads all of it."""
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng, (3, 1, 8, 32))
    jk, tk = _pair(rng, (3, 40, 2, 32))
    jv, tv = _pair(rng, (3, 40, 2, 32))
    lens = np.asarray([0, 17, 55], np.int32)
    out = tops.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    _close(out, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           1e-5)
    _close(out, jattn.decode_attention(jq, jk, jv, jnp.asarray(lens)), 1e-5)
    torch.testing.assert_close(out[0, 0, :4], tv[0, :, 0].mean(0)[None]
                               .expand(4, -1), atol=1e-6, rtol=1e-5)


# The split-cache algebra of the decode kernel: per-split (m, l, acc), then
# a merge in split order, at the split counts the chooser returns.
@pytest.mark.parametrize("b,hk,g,s,sms", [
    (4, 8, 7, 1064, 132),     # yi-34b's decode step: 12 splits
    (1, 1, 1, 4097, 132),     # one (batch, KV head): 64 splits
    (2, 2, 16, 700, 8),       # g = 16, 6 splits
    (3, 2, 4, 130, 132),      # 2 splits, the last one longer
    (32, 8, 2, 300, 132),     # B * Hk = 256: 1 split
    (16, 8, 2, 300, 132),     # B * Hk = 128: 3 splits
    (2, 1, 3, 40, 132),       # S < 64: one short split
])
def test_decode_split_algebra_matches_ref_and_jax(b, hk, g, s, sms):
    from repro_torch.kernels.decode_attention import decode_splits

    n_splits, split_len = decode_splits(b, hk, s, sms)
    rng = np.random.default_rng(b * s + g)
    jq, tq = _pair(rng, (b, 1, hk * g, 32))
    jk, tk = _pair(rng, (b, s, hk, 32))
    jv, tv = _pair(rng, (b, s, hk, 32))
    ragged = rng.integers(1, s + 1, b).astype(np.int32)
    # sequence 0 empty, one position, on a split boundary, past the cache;
    # the others ragged
    for first in (0, 1, min(split_len, s), s + 7):
        lens = ragged.copy()
        lens[0] = first
        out = tref.decode_attention_split_ref(
            tq, tk, tv, torch.as_tensor(lens), n_splits, split_len)
        _close(out, tref.decode_attention_ref(
            tq, tk, tv, torch.as_tensor(lens)).numpy(), 1e-5)
        _close(out, jattn.decode_attention(jq, jk, jv, jnp.asarray(lens)),
               1e-5)


@pytest.mark.parametrize("b,hk,s,sms", [
    (1, 1, 1, 132), (1, 1, 63, 132), (1, 1, 64, 132), (1, 1, 4097, 132),
    (4, 8, 1064, 132), (32, 8, 1064, 132), (64, 8, 4096, 132),
    (3, 5, 1000, 7), (1, 2, 200_000, 132),
])
def test_decode_splits_fill_the_card_without_short_splits(b, hk, s, sms):
    from repro_torch.kernels import decode_attention as tda

    n, split_len = tda.decode_splits(b, hk, s, sms)
    assert 1 <= n <= tda.MAX_SPLITS
    # every split, the last (which takes the remainder) included, is at
    # least MIN_SPLIT long, unless one split covers a shorter cache
    assert split_len >= min(tda.MIN_SPLIT, s)
    assert s - (n - 1) * split_len >= split_len
    assert n == 1 or b * hk * n <= tda.CTAS_PER_SM * sms
    # no more splits would fit both rules
    assert (n + 1 > s // tda.MIN_SPLIT or b * hk * (n + 1)
            > tda.CTAS_PER_SM * sms or n + 1 > tda.MAX_SPLITS)
    if (b, hk, s, sms) == (4, 8, 1064, 132):
        assert (n, split_len) == (12, 88)     # 384 CTAs at the serve shape


def test_vector_load_alignment_check_refuses_misaligned_views():
    from repro_torch.kernels._build import check_aligned

    buf = torch.zeros((2, 10, 3, 129), dtype=torch.bfloat16)
    check_aligned("k", "x", torch.zeros((2, 10, 3, 128),
                                        dtype=torch.bfloat16))
    check_aligned("k", "x", torch.zeros((1, 1, 1, 32)).expand(3, 5, 2, 32)
                  [:, :, :, :])
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned("k", "x", buf[..., :128])        # row stride 258 B
    with pytest.raises(ValueError, match="16-byte"):
        check_aligned("k", "x", torch.zeros(
            (2, 10, 3, 136), dtype=torch.bfloat16)[..., 1:129])   # base


@pytest.mark.parametrize("n", [1, 100, 5000, 70000])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_che_sums_matches_jax(n, k):
    rng = np.random.default_rng(n)
    p = rng.zipf(1.3, n).astype(np.float64)
    p = (p / p.sum()).astype(np.float32)
    ts = np.logspace(0, 6, k).astype(np.float32)
    out = tops.che_sums(torch.as_tensor(p), torch.as_tensor(ts))
    assert out.dtype == torch.float32 and out.shape == (k,)
    jout = jops.che_sums(jnp.asarray(p), jnp.asarray(ts), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.che_sums_ref(jnp.asarray(p),
                                                  jnp.asarray(ts))),
        rtol=1e-4, atol=1e-3)


def test_che_solve_matches_jax_and_bisection():
    from repro.core.cache_models import solve_che_time

    rng = np.random.default_rng(3)
    p = rng.zipf(1.2, 20000).astype(np.float64)
    p = (p / p.sum()).astype(np.float32)
    tp = torch.as_tensor(p)
    for cap in (100.0, 2000.0, 15000.0):
        t_port = tops.che_solve(tp, cap, iters=14)
        assert t_port.dtype == torch.float32 and t_port.dim() == 0
        consistency = float(torch.sum(-torch.expm1(-tp * t_port)))
        assert abs(consistency - cap) / cap < 1e-2
        t_jax = float(jops.che_solve(jnp.asarray(p), cap, iters=14,
                                     interpret=True))
        assert abs(float(t_port) - t_jax) <= 1e-4 * t_jax
        t_ref = float(solve_che_time(jnp.asarray(p), cap))
        assert abs(float(t_port) - t_ref) / t_ref < 5e-2


# ---------------------------------------------------------------------------
# models/layers.py, function by function (float32, 1e-5)
# ---------------------------------------------------------------------------

def test_rms_norm_swiglu_gelu_match_jax():
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, (2, 5, 16))
    js, ts = _pair(rng, (16,))
    _close(tlayers.rms_norm(tx, ts, 1e-5), jlayers.rms_norm(jx, js, 1e-5),
           1e-5)
    (jg, tg), (ju, tu), (jd, td) = (_pair(rng, (16, 24)), _pair(rng, (16, 24)),
                                    _pair(rng, (24, 16)))
    _close(tlayers.swiglu(tx, tg, tu, td), jlayers.swiglu(jx, jg, ju, jd),
           1e-5)
    (jbu, tbu), (jbd, tbd) = _pair(rng, (24,)), _pair(rng, (16,))
    _close(tlayers.gelu_mlp(tx, tu, td, tbu, tbd),
           jlayers.gelu_mlp(jx, ju, jd, jbu, jbd), 1e-5)
    _close(tlayers.gelu_mlp(tx, tu, td), jlayers.gelu_mlp(jx, ju, jd), 1e-5)


def test_mixed_dtype_products_promote_as_jax():
    """bfloat16 activations against float32 weights compute in float32."""
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, (3, 16), "bfloat16")
    jw, tw = _pair(rng, (16, 8))
    out = tlayers.matmul_f32(tx, tw)
    assert out.dtype == torch.float32
    _close(out, jnp.einsum("sd,df->sf", jx, jw,
                           preferred_element_type=jnp.float32), 1e-5)
    _close(tlayers.swiglu(tx, tw, tw, tw.T), jlayers.swiglu(jx, jw, jw, jw.T),
           2e-2)


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope_and_mrope_match_jax(theta):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, (2, 7, 3, 32))
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    _close(tlayers.rope(tx, torch.as_tensor(pos), theta),
           jlayers.rope(jx, jnp.asarray(pos), theta), 1e-5)
    pos3 = rng.integers(0, 64, (3, 2, 7)).astype(np.int32)
    _close(tlayers.mrope(tx, torch.as_tensor(pos3), (4, 6, 6), theta),
           jlayers.mrope(jx, jnp.asarray(pos3), (4, 6, 6), theta), 1e-5)
    jb, tb = _pair(rng, (2, 7, 3, 32), "bfloat16")
    out = tlayers.rope(tb, torch.as_tensor(pos), theta)
    assert out.dtype == torch.bfloat16
    _close(out, jlayers.rope(jb, jnp.asarray(pos), theta), 2e-2)


def test_take_embedding_matches_jax():
    rng = np.random.default_rng(3)
    jt, tt = _pair(rng, (50, 8))
    toks = rng.integers(0, 50, (2, 9)).astype(np.int32)
    _close(tlayers.take_embedding(tt, torch.as_tensor(toks).long()),
           jlayers.take_embedding(jt, jnp.asarray(toks)), 0.0)


# ---------------------------------------------------------------------------
# models/attention.py, function by function (float32, 1e-5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_offset", [0, 5])
def test_dense_and_blockwise_attention_match_jax(causal, q_offset):
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (2, 70, 6, 32))
    jk, tk = _pair(rng, (2, 75, 2, 32))
    jv, tv = _pair(rng, (2, 75, 2, 32))
    _close(tattn.dense_attention(tq, tk, tv, causal=causal, q_offset=q_offset),
           jattn.dense_attention(jq, jk, jv, causal=causal,
                                 q_offset=q_offset), 1e-5)
    for block_kv in (16, 32, 1024):
        _close(tattn.blockwise_attention(tq, tk, tv, causal=causal,
                                         q_offset=q_offset,
                                         block_kv=block_kv),
               jattn.blockwise_attention(jq, jk, jv, causal=causal,
                                         q_offset=q_offset,
                                         block_kv=block_kv), 1e-5)


def test_decode_attention_plain_matches_jax():
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng, (3, 1, 8, 32))
    jk, tk = _pair(rng, (3, 50, 2, 32))
    jv, tv = _pair(rng, (3, 50, 2, 32))
    lens = np.asarray([1, 20, 50], np.int32)
    jout = jattn.decode_attention(jq, jk, jv, jnp.asarray(lens))
    for impl in ("blockwise", "pallas"):
        _close(tattn.decode_attention(tq, tk, tv, torch.as_tensor(lens),
                                      impl=impl), jout, 1e-5)


@pytest.mark.parametrize("impl", ["dense", "blockwise", "pallas"])
@pytest.mark.parametrize("seq", [64, 288])
def test_attention_dispatch_matches_jax(impl, seq):
    """Up to 256 query tokens every impl takes the dense path; past it
    ``"pallas"`` takes the flash kernel (interpret mode in JAX, the plain
    version in the port) and ``"blockwise"`` the streaming loop."""
    rng = np.random.default_rng(seq)
    jq, tq = _pair(rng, (1, seq, 4, 32))
    jk, tk = _pair(rng, (1, seq, 2, 32))
    jv, tv = _pair(rng, (1, seq, 2, 32))
    _close(tattn.attention(tq, tk, tv, impl=impl, block_kv=128),
           jattn.attention(jq, jk, jv, impl=impl, block_kv=128), 1e-5)
