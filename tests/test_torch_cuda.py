"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU (a CUDA kernel has
no CPU mode).  This file imports no JAX, so it runs where the port runs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first kernel call builds ``src/repro_torch/kernels/csrc`` with nvcc.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import price_grid as tpg
from repro_torch.kernels import profile_grid as tprof

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _price_args(dev, policy, has_sorted, has_write, k=5, p=777, c=4):
    rng = np.random.default_rng(k * p + c)
    counts = rng.integers(0, 6, (k, p)).astype(np.float32)
    counts[:, rng.random(p) < 0.3] = 0.0
    sample = counts.sum(1)
    probs = counts / sample[:, None]
    w = np.floor(counts * rng.random((k, p))).astype(np.float32) / sample[:, None]
    nd = (counts > 0).sum(1)
    caps = np.stack([[n // 3, n // 2, n + 2, -1][:c] for n in nd]).astype(
        np.int32)
    f32s = np.zeros((k, 16), np.float32)
    i32s = np.zeros((k, 8), np.int32)
    f32s[:, 0], f32s[:, 1], f32s[:, 2] = sample, 2 * sample, nd
    f32s[:, 3] = np.where(probs > 0, probs, np.inf).min(1)
    f32s[:, 8] = 1.0
    i32s[:, 0] = nd
    i32s[:, 3] = np.arange(k) % 3
    cov = rng.integers(0, 3, (k, p)).astype(np.float32)
    if has_sorted:
        f32s[:, 4] = cov.sum(1)
        f32s[:, 5] = f32s[:, 4]
        f32s[:, 6] = i32s[:, 1] = (cov > 0).sum(1)
        i32s[:, 2] = 3
    order = np.argsort(-probs, axis=1, kind="stable")
    arrays = [probs, -np.sort(-probs, axis=1), -np.sort(-cov, axis=1), f32s,
              i32s, caps.astype(np.float32), caps,
              np.arange(k * c, dtype=np.int32).reshape(k, c),
              w if has_write else None,
              np.take_along_axis(w, order, axis=1) if has_write else None]
    return [None if a is None else torch.as_tensor(
        np.ascontiguousarray(a), device=dev) for a in arrays]


@pytest.mark.parametrize("policy", ("lru", "fifo", "lfu", "multi"))
@pytest.mark.parametrize("has_sorted", (False, True))
@pytest.mark.parametrize("has_write", (False, True))
def test_price_grid_kernel_matches_plain(dev, policy, has_sorted, has_write):
    args = _price_args(dev, policy, has_sorted, has_write)
    before = tpg.launches
    h, bv, bi = tpg.price_grid(policy, *args, has_sorted=has_sorted,
                               has_write=has_write)
    torch.cuda.synchronize()
    assert tpg.launches == before + 1
    hr, bvr, bir = tpg.price_grid_ref(policy, *args, has_sorted=has_sorted,
                                      has_write=has_write)
    assert float((h - hr).abs().max()) < 2e-6
    assert abs(float(bv) - float(bvr)) <= 1e-5 * abs(float(bvr)) + 2e-6
    assert int(bi) == int(bir) or abs(float(bv) - float(bvr)) < 2e-6


def test_profile_grid_kernel_matches_plain(dev):
    rng = np.random.default_rng(12)
    c_ipp, num_pages, q = 128, 64, 4000
    for integer_mass in (True, False):
        if integer_mass:
            positions = rng.integers(0, num_pages, q) * c_ipp \
                + rng.integers(16, 112, q)
            eps_rows = rng.choice([1, 2, 4], size=(3, q))
        else:
            positions = rng.integers(0, num_pages * c_ipp, q)
            eps_rows = rng.choice([1, 16, 256], size=(3, q))
        before = tprof.launches
        cg, tg = tprof.point_page_refs_mixed_eps_grid(
            positions, eps_rows, c_ipp, num_pages, device=dev)
        torch.cuda.synchronize()
        assert tprof.launches == before + 1
        cc, tc = tprof.point_page_refs_mixed_eps_grid(
            positions, eps_rows, c_ipp, num_pages, device="cpu")
        if integer_mass:
            assert torch.equal(cg.cpu(), cc) and np.array_equal(tg, tc)
        else:
            scale = max(1.0, float(cc.abs().max()))
            assert float((cg.cpu() - cc).abs().max()) / scale < 2e-6


# ---------------------------------------------------------------------------
# attention and Che kernels
# ---------------------------------------------------------------------------

def _tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 1e-4


def _one_ulp(dtype):
    """(atol, rtol) holding a bf16 output elementwise to one ulp of the
    plain version's (the float32 bound is unchanged)."""
    return (1e-3, 2**-7) if dtype == torch.bfloat16 else (1e-4, 1e-4)


def _normal(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


@pytest.mark.parametrize("b,s,h,hk,d", [
    (1, 64, 4, 4, 32),       # MHA
    (2, 128, 4, 2, 64),      # GQA 2:1
    (2, 96, 8, 1, 64),       # MQA 8:1, ragged against the 64-row tiles
    (1, 300, 14, 2, 128),    # GQA 7:1 (yi-34b's group), ragged
    (1, 256, 8, 1, 128),     # 8:1, full head dim
])
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("causal", (True, False))
def test_flash_attention_kernel_matches_plain(dev, b, s, h, hk, d, dtype,
                                              causal):
    from repro_torch.kernels import flash_attention as tfa

    rng = np.random.default_rng(b * s + h + d)
    q = _normal(rng, (b, s, h, d), dtype, dev)
    k = _normal(rng, (b, s, hk, d), dtype, dev)
    v = _normal(rng, (b, s, hk, d), dtype, dev)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    ref = tfa.flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


def test_flash_attention_kernel_reads_strided_views(dev):
    """q/k/v as head-dim-contiguous views of a fused QKV buffer."""
    from repro_torch.kernels import flash_attention as tfa

    rng = np.random.default_rng(5)
    qkv = _normal(rng, (2, 130, 8 + 2 + 2, 64), torch.float32, dev)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = tfa.flash_attention(q, k, v, causal=True)
    ref = tfa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,s,h,hk,d", [
    (2, 256, 4, 2, 64),
    (3, 130, 8, 8, 32),
    (1, 512, 8, 2, 128),
    (4, 1064, 56, 8, 128),   # yi-34b's decode step
])
@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_decode_attention_kernel_matches_plain(dev, b, s, h, hk, d, dtype,
                                               cache_dtype):
    from repro_torch.kernels import decode_attention as tda

    rng = np.random.default_rng(b * s + h)
    q = _normal(rng, (b, 1, h, d), dtype, dev)
    kc = _normal(rng, (b, s, hk, d), cache_dtype, dev)
    vc = _normal(rng, (b, s, hk, d), cache_dtype, dev)
    # ragged, including an empty and an over-long sequence
    lens = [max(1, s // (i + 2)) for i in range(b)]
    lens[-1] = 0 if b > 1 else s
    if b > 2:
        lens[0] = s + 7
    lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    before = tda.launches
    out = tda.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert tda.launches == before + 1
    ref = tda.decode_attention_ref(q, kc, vc, lengths)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("b,sq,skv,h,hk,d,causal", [
    (1, 1, 1, 4, 4, 128, True),          # one row
    (2, 63, 63, 14, 2, 128, True),       # GQA 7:1, one ragged Q tile
    (1, 65, 65, 14, 2, 64, True),        # one row past the first Q tile
    (1, 127, 127, 8, 1, 32, True),
    (2, 129, 129, 14, 2, 128, True),     # ragged K/V tile, first causal row
    (1, 1000, 1000, 14, 2, 128, True),
    (1, 1000, 1000, 7, 1, 64, False),
    (2, 65, 200, 14, 2, 128, False),     # non-causal Sq != Skv
    (1, 1, 777, 8, 2, 64, False),
    (1, 300, 129, 4, 4, 32, False),
    (1, 129, 63, 14, 2, 128, False),
])
def test_flash_attention_tensor_core_edges(dev, b, sq, skv, h, hk, d, causal):
    """The bf16 route (mma.sync) at ragged query and key edges, each
    output within one bf16 ulp of the plain version's."""
    from repro_torch.kernels import flash_attention as tfa

    rng = np.random.default_rng(b * sq + skv + h + d)
    q = _normal(rng, (b, sq, h, d), torch.bfloat16, dev)
    k = _normal(rng, (b, skv, hk, d), torch.bfloat16, dev)
    v = _normal(rng, (b, skv, hk, d), torch.bfloat16, dev)
    before = tfa.launches
    out = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    ref = tfa.flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    atol, rtol = _one_ulp(torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=rtol)


def test_attention_kernels_refuse_misaligned_bf16_views(dev):
    """16-byte loads need aligned bases and strides: such views raise, and
    nothing is launched (no fallback)."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa

    qkv = torch.zeros((1, 70, 3, 68), dtype=torch.bfloat16, device=dev)
    q, k, v = (qkv[:, :, i:i + 1, :64] for i in range(3))   # 408-byte rows
    before = tfa.launches
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention(q, k, v, causal=True)
    cache = torch.zeros((2, 40, 1, 36), dtype=torch.bfloat16, device=dev)
    kc = cache[..., 1:33]                                    # base + 2 bytes
    lens = torch.full((2,), 40, dtype=torch.int32, device=dev)
    q1 = torch.zeros((2, 1, 4, 32), dtype=torch.bfloat16, device=dev)
    d_before = tda.launches
    with pytest.raises(ValueError, match="16-byte"):
        tda.decode_attention(q1, kc, kc, lens)
    assert (tfa.launches, tda.launches) == (before, d_before)


# (B, Hk, g, S): S across split boundaries, g 1 / 7 / 16, B * Hk 1 to 256
DECODE_EDGES = [
    (1, 1, 1, 1), (1, 1, 7, 63), (1, 1, 16, 64), (2, 1, 7, 65),
    (1, 2, 1, 127), (2, 4, 16, 129), (1, 1, 7, 4097), (4, 8, 7, 1064),
    (32, 8, 1, 1064), (32, 8, 7, 100), (64, 4, 2, 700),
]


def test_decode_edge_cases_cover_one_and_many_splits(dev):
    from repro_torch.kernels import decode_attention as tda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {tda.decode_splits(b, hk, s, sms)[0]
              for b, hk, g, s in DECODE_EDGES}
    assert 1 in splits and max(splits) > 8


@pytest.mark.parametrize("b,hk,g,s", DECODE_EDGES)
@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_decode_attention_split_edges(dev, b, hk, g, s, dtype, cache_dtype):
    """Lengths 0, 1, on a split boundary and past the cache, beside ragged
    ones, through the split-cache kernel and its combine pass; bf16
    outputs within one ulp of the plain version's."""
    from repro_torch.kernels import decode_attention as tda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, split_len = tda.decode_splits(b, hk, s, sms)
    rng = np.random.default_rng(b * s + g + hk)
    d = 128 if s > 500 else 64
    q = _normal(rng, (b, 1, hk * g, d), dtype, dev)
    kc = _normal(rng, (b, s, hk, d), cache_dtype, dev)
    vc = _normal(rng, (b, s, hk, d), cache_dtype, dev)
    ragged = rng.integers(1, s + 1, b)
    for first in (0, 1, min(split_len, s), s + 7):
        lens = ragged.copy()
        lens[0] = first
        lengths = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        before = tda.launches
        out = tda.decode_attention(q, kc, vc, lengths)
        torch.cuda.synchronize()
        assert tda.launches == before + 1
        ref = tda.decode_attention_ref(q, kc, vc, lengths)
        assert out.dtype == dtype and out.shape == q.shape
        atol, rtol = _one_ulp(dtype)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_decode_attention_kernel_is_deterministic(dev, dtype, cache_dtype):
    """Splits merge in a fixed order: two calls are bit-equal."""
    from repro_torch.kernels import decode_attention as tda

    rng = np.random.default_rng(7)
    q = _normal(rng, (4, 1, 56, 128), dtype, dev)
    kc = _normal(rng, (4, 1064, 8, 128), cache_dtype, dev)
    vc = _normal(rng, (4, 1064, 8, 128), cache_dtype, dev)
    lengths = torch.as_tensor([1025, 0, 1, 1071], dtype=torch.int32,
                              device=dev)
    a = tda.decode_attention(q, kc, vc, lengths)
    b = tda.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", (1, 1000, 100_003))
@pytest.mark.parametrize("k", (1, 8))
def test_che_sums_kernel_matches_plain(dev, n, k):
    from repro_torch.kernels import che_solver as tche

    rng = np.random.default_rng(n + k)
    p = rng.zipf(1.3, n).astype(np.float64)
    probs = torch.as_tensor((p / p.sum()).astype(np.float32), device=dev)
    ts = torch.as_tensor(np.logspace(0, 6, k).astype(np.float32), device=dev)
    before = tche.launches
    out = tche.che_sums(probs, ts)
    torch.cuda.synchronize()
    assert tche.launches == before + 1
    torch.testing.assert_close(out, tche.che_sums_ref(probs, ts), rtol=1e-4,
                               atol=1e-3)


def test_hit_rate_lru_kernel_path_matches_bisection(dev):
    from repro_torch.core import cache_models as tcm
    from repro_torch.kernels import che_solver as tche

    rng = np.random.default_rng(3)
    p = rng.zipf(1.2, 20000).astype(np.float64)
    probs = torch.as_tensor((p / p.sum()).astype(np.float32), device=dev)
    for cap in (100.0, 2000.0, 15000.0):
        before = tche.launches
        h_kernel = float(tcm.hit_rate_lru(probs, cap, use_kernel=True))
        assert tche.launches == before + 16
        h_bisect = float(tcm.hit_rate_lru(probs, cap))
        assert abs(h_kernel - h_bisect) <= 1e-4 * h_bisect


@pytest.mark.parametrize("arch", ("yi-34b", "starcoder2-3b"))
def test_serve_engine_pallas_path_launches_both_attention_kernels(dev, arch):
    """A reduced dense model served through the kernels gives the tokens of
    the plain (blockwise) path; prefill of a 288-token prompt takes the
    flash kernel once a layer, each decode step the decode kernel."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 288)).astype(np.int32)
    results = {}
    for impl in ("pallas", "blockwise"):
        eng = ServeEngine(cfg, params, recipe=Recipe(remat="none",
                                                     attn_impl=impl),
                          max_seq=300, device=dev)
        f0, d0 = tfa.launches, tda.launches
        results[impl] = eng.generate(prompts, max_new_tokens=4)
        launched = (tfa.launches - f0, tda.launches - d0)
        expect = ((cfg.num_layers, 4 * cfg.num_layers) if impl == "pallas"
                  else (0, 0))
        assert launched == expect, (impl, launched)
    a, b = results["pallas"], results["blockwise"]
    torch.testing.assert_close(a.prefill_logits, b.prefill_logits,
                               atol=1e-4, rtol=1e-4)
    assert np.array_equal(a.tokens, b.tokens)
