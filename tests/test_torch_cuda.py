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
    caps = np.stack([np.resize([n // 3, n // 2, n + 2, -1, 1, n - 1, n // 7,
                                0, 2 * n], c) for n in nd]).astype(np.int32)
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


@pytest.mark.parametrize("k,p,c", [
    (1, 777, 4),          # one row
    (3, 78_131, 1),       # ragged against the 16-CTA slices
    (2, 78_125, 3),
    (2, 78_125, 9),       # two cell groups
    (2, 600_001, 4),      # slices spill past the staged shared memory
])
@pytest.mark.parametrize("policy,has_sorted,has_write", [
    ("lru", False, False), ("fifo", False, True), ("multi", True, True),
    ("lfu", True, True)])
def test_price_grid_kernel_shapes(dev, k, p, c, policy, has_sorted,
                                  has_write):
    """Cluster slices, cell groups, spilled slices: 1e-5 on h, the main
    path's gate (sums over up to 6e5 pages in another order)."""
    args = _price_args(dev, policy, has_sorted, has_write, k=k, p=p, c=c)
    steps = torch.full((k, c), -1, dtype=torch.int32, device=dev)
    h, bv, bi = tpg.price_grid(policy, *args, has_sorted=has_sorted,
                               has_write=has_write, steps=steps)
    torch.cuda.synchronize()
    hr, bvr, bir = tpg.price_grid_ref(policy, *args, has_sorted=has_sorted,
                                      has_write=has_write)
    assert float((h - hr).abs().max()) < 1e-5
    assert abs(float(bv) - float(bvr)) <= 1e-5 * abs(float(bvr)) + 1e-5
    assert int(bi) == int(bir) or abs(float(bv) - float(bvr)) < 1e-5
    caps, n_i = args[6], args[4][:, 0:1]
    bisects = (caps >= 1) & (caps < n_i)
    if policy == "lfu":
        bisects &= False
    elif policy == "multi":
        bisects &= args[4][:, 3:4] != 2
    assert bool((steps[~bisects] == 0).all())
    assert bool((steps[bisects] >= 1).all())
    assert bool((steps <= 64).all())


def test_price_grid_kernel_is_deterministic(dev):
    for policy in ("lru", "multi"):
        args = _price_args(dev, policy, True, True, k=7, p=78_125, c=9)
        a = tpg.price_grid(policy, *args, has_sorted=True, has_write=True)
        b = tpg.price_grid(policy, *args, has_sorted=True, has_write=True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _profile_case(dev, positions, eps_rows, c_ipp, num_pages, integer_mass):
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


@pytest.mark.parametrize("integer_mass", (True, False))
@pytest.mark.parametrize("traffic", ("zipf_hot_page", "hotspot_windows"))
def test_profile_grid_kernel_skewed_traffic(dev, integer_mass, traffic):
    """A Zipf-skewed hot key (one page takes ~a quarter of the queries, the
    main path's w4 shape) and hotspot windows (dense page ranges): exact
    for integer mass, 2e-6 normalized otherwise."""
    rng = np.random.default_rng(40 + integer_mass)
    c_ipp, num_pages, q = 256, 5000, 200_000
    if integer_mass:
        slots = rng.integers(64, c_ipp - 64, q)
        eps_choices = [1, 4, 16, 32]
    else:
        slots = rng.integers(0, c_ipp, q)
        eps_choices = [1, 16, 256, 1024, 8192]
    if traffic == "zipf_hot_page":
        page = rng.integers(0, num_pages, q)
        hot = rng.random(q) < 0.3
        page[hot] = np.minimum(rng.zipf(1.3, hot.sum()) - 1, num_pages - 1)
        slots[page == 0] = slots[0]              # the hot key: one slot
    else:
        centers = rng.integers(0, num_pages, 6)
        page = np.clip(centers[rng.integers(0, 6, q)]
                       + rng.integers(-40, 40, q), 0, num_pages - 1)
    positions = page * c_ipp + slots
    eps_rows = rng.choice(eps_choices, size=(5, q)).astype(np.int64)
    _profile_case(dev, positions, eps_rows, c_ipp, num_pages, integer_mass)


def test_profile_grid_kernel_counts_flushes(dev):
    rng = np.random.default_rng(8)
    keys = torch.as_tensor(rng.integers(-1, 256, (2, 30_000)).astype(
        np.int32), device=dev)
    pages = torch.as_tensor(rng.integers(0, 900, 30_000).astype(np.int32),
                            device=dev)
    lut = torch.as_tensor(rng.integers(0, 2, (256, 5)).astype(np.float32),
                          device=dev)
    bands = torch.as_tensor([[0, 4]], dtype=torch.int32, device=dev)
    sq = tprof.sort_queries(keys, pages, lut, bands, c_ipp=256, pad=905)
    flushes = torch.zeros(1, dtype=torch.int64, device=dev)
    out = tprof.launch_sorted(sq, flushes)
    ref = tprof.profile_grid_ref(keys, pages, lut, bands, c_ipp=256, pad=905)
    assert torch.equal(out, ref)
    # at least one flush per nonzero output bin, at most one per window bin
    n_tiles = sq.starts.numel() - 1
    assert int((ref != 0).sum()) <= int(flushes) <= 2 * n_tiles * tprof.BINS


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
    (2, 200, 8, 8, 80),      # zamba2's head dim, ragged
    (1, 130, 12, 4, 80),     # D 80 under GQA 3:1
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
    (4, 1064, 32, 32, 80),   # zamba2's decode step
    (3, 300, 16, 2, 80),     # D 80 under GQA 8:1
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
    (1, 1, 1, 4, 4, 80, True),           # D 80: one row
    (2, 129, 129, 32, 32, 80, True),     # zamba2's heads, ragged K/V tile
    (1, 1000, 1000, 8, 2, 80, True),
    (2, 65, 200, 8, 8, 80, False),
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


@pytest.mark.parametrize("b,hk,g,s", DECODE_EDGES)
@pytest.mark.parametrize("dtype,cache_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
def test_decode_attention_split_edges_head_dim_80(dev, b, hk, g, s, dtype,
                                                  cache_dtype):
    """The split edges at D 80, whose 10 (bf16) or 20 (float32) 16-byte
    slices a row run on 16 or 32 threads with a masked tail."""
    from repro_torch.kernels import decode_attention as tda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, split_len = tda.decode_splits(b, hk, s, sms)
    rng = np.random.default_rng(b * s + g + hk + 80)
    q = _normal(rng, (b, 1, hk * g, 80), dtype, dev)
    kc = _normal(rng, (b, s, hk, 80), cache_dtype, dev)
    vc = _normal(rng, (b, s, hk, 80), cache_dtype, dev)
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
        atol, rtol = _one_ulp(dtype)
        torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_attention_kernels_refuse_unsupported_head_dims(dev, dtype):
    """D 96 (and 16, the reduced hybrid's) raise ValueError on CUDA
    tensors, and nothing is launched: no fallback to the plain version."""
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa

    for d in (96, 16):
        q = torch.zeros((1, 64, 4, d), dtype=dtype, device=dev)
        lens = torch.full((1,), 64, dtype=torch.int32, device=dev)
        before = (tfa.launches, tda.launches)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention(q, q, q, causal=True)
        with pytest.raises(ValueError, match="head_dim"):
            tda.decode_attention(q[:, :1], q, q, lens)
        assert (tfa.launches, tda.launches) == before


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


@pytest.mark.parametrize("n", (1, 1000, 78_125, 100_003, 1_000_003))
@pytest.mark.parametrize("k", (3, 8, 16))
def test_che_sums_kernel_one_launch_bit_equal(dev, n, k):
    """One launch a call (the last block reduces the partials), the same
    bits from call to call, within the plain version's tolerance."""
    from repro_torch.kernels import che_solver as tche

    rng = np.random.default_rng(7 * n + k)
    p = rng.zipf(1.3, n).astype(np.float64)
    probs = torch.as_tensor((p / p.sum()).astype(np.float32), device=dev)
    ts = torch.as_tensor(np.logspace(0, 7, k).astype(np.float32), device=dev)
    before = tche.launches
    a = tche.che_sums(probs, ts)
    b = tche.che_sums(probs, ts)
    torch.cuda.synchronize()
    assert tche.launches == before + 2
    assert torch.equal(a, b)
    torch.testing.assert_close(a, tche.che_sums_ref(probs, ts), rtol=1e-4,
                               atol=1e-3)


def _che_probs(n, seed, dev, zeros=0.0):
    rng = np.random.default_rng(seed)
    p = rng.zipf(1.2, n).astype(np.float64)
    p[rng.random(n) < zeros] = 0.0
    if not p.any():
        p[0] = 1.0
    return torch.as_tensor((p / p.sum()).astype(np.float32), device=dev)


@pytest.mark.parametrize("n", (1, 1000, 78_125, 100_003, 1_000_003,
                               4_000_037))
@pytest.mark.parametrize("k,iters", ((8, 16), (8, 20), (1, 14), (5, 16),
                                     (16, 16)))
def test_che_solve_kernel_matches_plain(dev, n, k, iters):
    """The fused solve against the plain host loop on the same card
    tensors (T within 1e-4; at 4,000,037 the slices of a 132-SM grid spill
    past shared memory), its h against bisection (1e-4) and against h
    recomputed from its own T (2e-6), and two calls bit-equal; one launch
    a solve."""
    from repro_torch.core import cache_models as tcm
    from repro_torch.kernels import che_solver as tche

    probs = _che_probs(n, n + k, dev, zeros=0.1)
    nnz = int((probs > 0).sum())
    if n > 3_000_000:
        plan = tche.solve_plan(n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        assert plan.spilled
    # capacities well inside (0, nnz): near nnz, T is set by the rounding
    # of a saturated sum, which the summation order moves
    for cap in sorted({max(nnz // 50, 1), max(nnz // 3, 1),
                       max(nnz // 2, 1)}):
        s0, c0 = tche.solve_launches, tche.launches
        t, h = tche.che_hit_rate(probs, cap, k=k, iters=iters)
        t2, h2 = tche.che_hit_rate(probs, cap, k=k, iters=iters)
        torch.cuda.synchronize()
        assert (tche.solve_launches, tche.launches) == (s0 + 2, c0)
        assert torch.equal(t, t2) and torch.equal(h, h2)
        t_ref = float(tche.che_solve_ref(probs, cap, k=k, iters=iters))
        assert abs(float(t) - t_ref) <= 1e-4 * t_ref, (cap, float(t), t_ref)
        h_own = float(torch.sum(probs * -torch.expm1(-probs * t)))
        assert abs(float(h) - h_own) <= 2e-6 * max(h_own, 1e-30)
        if iters == 16 and k == 8:
            h_bisect = float(tcm.hit_rate_lru(probs, cap))
            assert abs(float(h) - h_bisect) <= 1e-4 * h_bisect
        assert float(tche.che_solve(probs, cap, k=k, iters=iters)) == float(t)


def test_che_solve_kernel_reads_a_card_capacity(dev):
    """A capacity given as a CUDA tensor is read by the kernel (no host
    copy) and solves as the same number given on the host."""
    from repro_torch.kernels import che_solver as tche

    probs = _che_probs(5000, 11, dev)
    for cap in (1.0, 37.0, 1200.0):
        a = tche.che_hit_rate(probs, cap)
        b = tche.che_hit_rate(probs, torch.tensor(cap, device=dev))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_hit_rate_lru_kernel_path_matches_bisection(dev):
    """``hit_rate_lru(use_kernel=True)`` is one fused launch a solve and
    launches no ``che_sums``."""
    from repro_torch.core import cache_models as tcm
    from repro_torch.kernels import che_solver as tche

    rng = np.random.default_rng(3)
    p = rng.zipf(1.2, 20000).astype(np.float64)
    probs = torch.as_tensor((p / p.sum()).astype(np.float32), device=dev)
    for cap in (100.0, 2000.0, 15000.0):
        before, solves = tche.launches, tche.solve_launches
        h_kernel = float(tcm.hit_rate_lru(probs, cap, use_kernel=True))
        assert (tche.launches, tche.solve_launches) == (before, solves + 1)
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


@pytest.mark.parametrize("arch", ("qwen2-moe-a2.7b", "qwen2-vl-7b",
                                  "musicgen-medium", "zamba2-2.7b",
                                  "rwkv6-3b"))
def test_serve_engine_pallas_path_serves_every_family(dev, arch):
    """A reduced model of each family (the hybrid at zamba2's head_dim 80)
    served through the kernels gives the tokens of the plain (blockwise)
    path; flash runs once an attention layer in prefill, decode once an
    attention layer a step, and RWKV launches neither."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, head_dim=80)
    attn_layers = {"hybrid": cfg.num_layers // max(cfg.shared_attn_every, 1),
                   "rwkv": 0}.get(cfg.family, cfg.num_layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    shape = (2, 288) + ((cfg.num_codebooks,) if cfg.family == "audio"
                        else ())
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    results = {}
    for impl in ("pallas", "blockwise"):
        eng = ServeEngine(cfg, params, recipe=Recipe(remat="none",
                                                     attn_impl=impl),
                          max_seq=300, device=dev)
        f0, d0 = tfa.launches, tda.launches
        results[impl] = eng.generate(prompts, max_new_tokens=4)
        launched = (tfa.launches - f0, tda.launches - d0)
        expect = ((attn_layers, 4 * attn_layers) if impl == "pallas"
                  else (0, 0))
        assert launched == expect, (impl, launched)
    a, b = results["pallas"], results["blockwise"]
    torch.testing.assert_close(a.prefill_logits, b.prefill_logits,
                               atol=1e-4, rtol=1e-4)
    assert np.array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_int8_cache_decode_reaches_the_decode_kernel(dev, dtype):
    """The int8 cache dequantized to the activations' type goes through
    the decode kernel once a layer under ``"pallas"`` and matches the plain
    path's step: logits within 1e-4 / 2e-2, the written int8 values one
    step apart at most (a value on a rounding boundary) and the scales
    within the same tolerance."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import Recipe, ShardingCtx
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.models import model as model_mod
    from repro_torch.models.params import init_params

    cfg = dataclasses.replace(reduced(ARCHS["musicgen-medium"]), dtype=dtype)
    wdt = torch.float32 if dtype == "float32" else torch.bfloat16
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=wdt, device=dev)
    specs = model_mod.cache_specs(cfg, ShapeSpec("t", "decode", 64, 2),
                                  kv_dtype=torch.int8)
    rng = np.random.default_rng(0)
    base = {n: torch.as_tensor(rng.integers(-127, 128, s.shape).astype(
        np.int8), device=dev) if s.dtype == torch.int8 else
        torch.as_tensor(rng.random(s.shape).astype(np.float32) / 127,
                        device=dev) for n, s in specs.items()}
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1, 4)),
                           device=dev)
    batch = {"tokens": toks,
             "lengths": torch.tensor([17, 40], dtype=torch.int32,
                                     device=dev)}
    out = {}
    for impl in ("pallas", "blockwise"):
        cache = {n: t.clone() for n, t in base.items()}
        before = tda.launches
        with torch.inference_mode():
            out[impl] = model_mod.decode_fn(
                params, cfg, batch, cache,
                ShardingCtx(None, Recipe(remat="none", attn_impl=impl)))
        torch.cuda.synchronize()
        assert tda.launches - before == (cfg.num_layers if impl == "pallas"
                                         else 0)
    (lp, cp), (lb, cb) = out["pallas"], out["blockwise"]
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert float((lp - lb).abs().max()) <= tol * float(lb.abs().max())
    for n in ("k", "v"):          # the written values: one step apart at
        assert int((cp[n].int() - cb[n].int()).abs().max()) <= 1   # most
    for n in ("k_scale", "v_scale"):
        torch.testing.assert_close(cp[n], cb[n], rtol=tol, atol=0)


@pytest.mark.parametrize("policy", ("lru", "fifo", "lfu"))
def test_price_grid_on_join_curve_rows(dev, policy):
    """The join's curve table: a zero-histogram row with a sorted part
    (``total`` 0) and an INLJ row, each at several capacities, priced
    through the DeviceExecutor on the card and held against the plain
    version on the recorded operands at 1e-5."""
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.workloads import WorkloadSpec, join_outer_keys
    from repro_torch.engine import PricingEngine
    from repro_torch.index.adapters import PGMAdapter
    from repro_torch.join.session import JoinSession, curve_price_table

    keys = make_dataset("books", 100_000, seed=5)
    outer = join_outer_keys(keys, 8_000, WorkloadSpec("w4", seed=9))
    inner = PGMAdapter.build(keys, eps=32)
    sess = JoinSession(inner, System(CamGeometry(),
                                     (1 << 20) + inner.size_bytes, policy),
                       inner_keys=keys)
    states = [("a", sess._curve_state(outer)),
              ("b", sess._curve_state(outer[:3000]))]
    caps = np.array([2, 16, 64, 200, 390])
    table = curve_price_table(states, caps, device=dev)
    prof = table.profiles
    assert prof.counts.device.type == "cuda"
    zero_sorted = [i for i, kn in enumerate(prof.knobs) if kn[1] == "sorted"]
    assert zero_sorted and all(prof.totals[i] == 0.0 for i in zero_sorted)
    assert all(float(prof.counts[i].abs().sum()) == 0.0 for i in zero_sorted)
    calls = []
    real = tpg.price_grid

    def grab(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)

    tpg.price_grid = grab
    try:
        before = tpg.launches
        sol = PricingEngine(sess._cost_session,
                            executor="device").price(table)
        torch.cuda.synchronize()
    finally:
        tpg.price_grid = real
    assert tpg.launches == before + 1 and len(calls) == 1
    assert sol.executor == "device"
    a, kw = calls[0]
    assert kw["has_sorted"]
    h, bv, bi = tpg.price_grid(*a, **kw)
    hr, bvr, bir = tpg.price_grid_ref(*a, **kw)
    assert float((h - hr).abs().max()) <= 1e-5
    assert abs(float(bv) - float(bvr)) <= 1e-5 * abs(float(bvr)) + 1e-5
    host = PricingEngine(sess._cost_session, executor="host").price(table)
    assert np.abs(sol.hit_rates - host.hit_rates).max() <= 1e-5


def _write_report(dev, executor):
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import GridCandidate, System
    from repro_torch.serving.trace import synthetic_drifting_trace
    from repro_torch.write import CamMergeScheduler, WriteConfig, WriteSession

    keys = np.sort(np.random.default_rng(21).uniform(0, 1e9, 30_000))
    geom = CamGeometry(c_ipp=64, page_bytes=4096)
    trace = synthetic_drifting_trace(keys, [
        {"events": 1000, "mix": (0.85, 0.05, 0.0, 0.1, 0.0, 0.0),
         "hot_width": 0.08, "hot_frac": 0.95},
        {"events": 1400, "mix": (0.25, 0.0, 0.0, 0.55, 0.15, 0.05),
         "hot_center": 0.7, "hot_width": 0.25, "hot_frac": 0.8},
        {"events": 1200, "mix": (0.92, 0.03, 0.0, 0.05, 0.0, 0.0),
         "hot_width": 0.08, "hot_frac": 0.95}], seed=9)
    sess = WriteSession(
        keys, System(geom, 80 * geom.page_bytes, "lru", torch_device=dev),
        CamMergeScheduler(),
        candidate=GridCandidate(knob="live", eps=64, size_bytes=4096.0),
        config=WriteConfig(batch_size=200, delta_capacity_entries=6000,
                           delta_entry_bytes=256.0, horizon_batches=12.0,
                           price_executor=executor))
    dacs, real = [], sess.engine.price

    def price(table, **kw):
        dacs.append(np.asarray(table.profiles.dacs)[table.rows])
        return real(table, **kw)

    sess.engine.price = price
    return sess.run(trace), dacs


def test_write_session_on_the_card_matches_host_executor(dev):
    """A small WriteSession on the card: the device executor launches
    ``price_grid`` once per decision event and makes the host executor's
    merge decisions, its I/O within rtol 1e-5 (or the 2e-6 hit-rate bound
    through E[DAC] where h is within a few ulps of 1)."""
    before = tpg.launches
    got, _ = _write_report(dev, "device")
    torch.cuda.synchronize()
    assert tpg.launches - before == got.engine_calls == got.decision_events
    want, dacs = _write_report(dev, "host")
    assert [(r.merged, r.reason) for r in got.records] \
        == [(r.merged, r.reason) for r in want.records]
    events = [(g, w) for g, w in zip(got.records, want.records)
              if w.reason != "no_reads_yet"]
    assert len(events) == len(dacs)
    for (g, w), dac in zip(events, dacs):
        for f, cell in (("io_defer", 0), ("io_merged", 1)):
            assert getattr(g, f) == pytest.approx(
                getattr(w, f), rel=1e-5, abs=2e-6 * dac[cell]), f
    assert got.total_io == pytest.approx(want.total_io, rel=1e-4)


def test_sharding_solve_on_the_card_matches_host_executor(dev):
    """A 4-shard fleet solve on the card: one ``price_grid`` launch, and
    the host executor's boundaries, shares and knobs, I/O at rtol 1e-5."""
    from repro_torch.core.cam import CamGeometry
    from repro_torch.core.session import System
    from repro_torch.core.workload import Workload
    from repro_torch.engine import PricingEngine
    from repro_torch.sharding import ShardingSession
    from repro_torch.tuning.session import AnalyticSizeModel, PGMBuilder

    n = 8192
    keys = np.sort(np.random.default_rng(0).uniform(0, 1e6, n))
    rng = np.random.default_rng(13)
    hot = rng.integers(0, 1920, 3680)
    pos = np.concatenate([hot, rng.integers(0, n, 320)])
    rng.shuffle(pos)
    wl = Workload.point(pos, n=n)
    plans = {}
    for executor in ("device", "host"):
        sess = ShardingSession(
            System(CamGeometry(c_ipp=64, page_bytes=4096), 8 * 1024, "lru",
                   torch_device=dev), PGMBuilder(keys), 4, grid=8,
            overrides={"eps": (4, 64)},
            size_model=AnalyticSizeModel(lambda eps: n * 8.0 / eps + 64.0))
        sess.cost._engine = PricingEngine(sess.cost, executor=executor)
        before = tpg.launches
        plans[executor] = sess.solve(wl)
        torch.cuda.synchronize()
        assert tpg.launches - before == (executor == "device")
    got, want = plans["device"], plans["host"]
    assert (got.boundaries, got.fractions) == (want.boundaries,
                                               want.fractions)
    assert [(s.knob, s.capacity_pages) for s in got.shards] \
        == [(s.knob, s.capacity_pages) for s in want.shards]
    assert got.io_per_query == pytest.approx(want.io_per_query, rel=1e-5)
    np.testing.assert_allclose(got.boundary_totals, want.boundary_totals,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# Training on the card: the bf16 products' backward, a train step against
# the CPU, and the attention kernels' refusal of gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_bf16_products_have_a_backward(dev, batched):
    """``matmul_f32``/``bmm_f32`` of bfloat16 card tensors: the forward is
    cuBLAS's float32 accumulator, and the gradients come back in bfloat16
    within 2e-2 of their max-abs of float32 autograd on the same values."""
    from repro_torch.models.layers import bmm_f32, matmul_f32

    g = torch.Generator(device=dev).manual_seed(3)
    shapes = ((4, 96, 160), (4, 160, 72)) if batched else ((2, 48, 160),
                                                           (160, 72))
    a, b = (torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
            .requires_grad_() for s in shapes)
    fn = bmm_f32 if batched else matmul_f32
    out = fn(a, b)
    assert out.dtype == torch.float32
    cot = torch.randn(out.shape, generator=g, device=dev)
    out.backward(cot)
    a32, b32 = (x.detach().float().requires_grad_() for x in (a, b))
    ref = torch.matmul(a32, b32)
    ref.backward(cot)
    assert float((out - ref).abs().max()) <= 1e-3 * float(ref.abs().max())
    for x, x32 in ((a, a32), (b, b32)):
        assert x.grad.dtype == torch.bfloat16
        err = (x.grad.float() - x32.grad).abs().max()
        assert float(err) <= 2e-2 * float(x32.grad.abs().max())


@pytest.mark.parametrize("arch,dtype", [
    ("starcoder2-3b", "float32"), ("starcoder2-3b", "bfloat16"),
    ("qwen2-moe-a2.7b", "float32"), ("rwkv6-3b", "float32"),
    ("zamba2-2.7b", "float32")])
def test_train_step_on_the_card_matches_the_cpu(dev, arch, dtype):
    """One reduced train step on the card and on the CPU from the same
    weights and batch: loss and grad norm within 1e-4 (float32) or 2e-2
    (bfloat16 compute), and the parameters.  Adam's first step moves an
    entry by about lr times the sign of its gradient, so an entry whose
    gradient is rounding noise (a key bias's is 0 in exact arithmetic;
    zamba2's float32 rounding grows through its blocks) may move either
    way on either device: at most 1% of a leaf's entries may lie further
    than the tolerance times the leaf's max-abs, none further than that
    plus two opposite updates.  Every leaf initialised to a constant
    (norms, biases, mixes) is moved by 0.1 N(0, 1), as the JAX parity
    tests do, so that no leaf is only its update."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype)
    recipe = Recipe(remat="block")
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = ts_mod.make_train_step(cfg, recipe, None, opt_cfg)
    gen = torch.Generator().manual_seed(0)
    base = opt_mod.map_tree(
        lambda x: x + 0.1 * torch.randn(x.shape, generator=gen)
        if x.numel() > 1 and bool((x == x.flatten()[0]).all()) else x,
        init_params(cfg, gen, device="cpu"))
    batch = TokenPipeline(cfg.vocab_size, 4, 64, seed=1).batch_for_step(0)
    out = {}
    for d in ("cpu", dev):
        # a copy on each device: the step updates its params in place
        params = opt_mod.map_tree(lambda x: x.to(d, copy=True), base)
        state = ts_mod.init_opt_state(params, cfg, recipe, opt_cfg)
        p, _, m = step(params, state, {k: torch.as_tensor(v, device=d)
                                       for k, v in batch.items()})
        out[str(d)] = (p, m)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    (pc, mc), (pg, mg) = out["cpu"], out[str(dev)]
    for name in ("loss", "grad_norm"):
        assert abs(float(mg[name]) - float(mc[name])) <= tol * abs(
            float(mc[name])), name
    gl = dict(opt_mod.leaves(pg))
    for path, x in opt_mod.leaves(pc):
        y = gl[path].cpu()
        assert y.dtype == x.dtype
        d, near = (y - x).abs(), tol * float(x.abs().max())
        assert float((d > near).float().mean()) <= 1e-2, path
        assert float(d.max()) <= near + 2 * opt_cfg.lr, path


def test_attention_kernels_refuse_gradients_on_the_card(dev):
    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, 512, 4, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    q.requires_grad_()
    with pytest.raises(ValueError, match="no backward kernel"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no backward kernel"):
        attention(q, k, v, impl="pallas")
    lengths = torch.full((1,), 100, device=dev)
    with pytest.raises(ValueError, match="no backward kernel"):
        ops.decode_attention(q[:, :1], k, v, lengths)
    with torch.no_grad():
        ops.flash_attention(q, k, v)
        ops.decode_attention(q[:, :1], k, v, lengths)


@pytest.fixture
def card_mesh(dev, tmp_path):
    """A (1, 1) ("data", "model") mesh of a one-rank NCCL world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ("starcoder2-3b", "qwen2-moe-a2.7b"))
def test_mesh_train_step_on_the_card_matches_meshless(dev, card_mesh, arch):
    """Two reduced bf16 train steps on DTensor params of a one-rank NCCL
    mesh (the bf16 products through ``dtensor_mm``, the embedding's
    gather, the MoE's sharded dispatch) give the mesh-less steps' losses,
    grad norms and parameters to the bit."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed.sharding import Recipe
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    cfg = dataclasses.replace(reduced(ARCHS[arch]), dtype="bfloat16")
    recipe = Recipe(remat="block")
    opt_cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    pipe = TokenPipeline(cfg.vocab_size, 4, 64, seed=1)
    out = []
    for mesh in (None, card_mesh):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        state = {"params": params, "opt_state": ts_mod.init_opt_state(
            params, cfg, recipe, opt_cfg)}
        if mesh is not None:
            state = ts_mod.shard_state(state, cfg, recipe, mesh, "float32")
        step = ts_mod.make_train_step(cfg, recipe, mesh, opt_cfg)
        ms = []
        for i in range(2):
            p, o, m = step(state["params"], state["opt_state"],
                           {k: torch.as_tensor(v, device=dev)
                            for k, v in pipe.batch_for_step(i).items()})
            state = {"params": p, "opt_state": o}
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        out.append((ms, {"/".join(k): x.full_tensor() if mesh is not None
                         else x for k, x in opt_mod.leaves(state["params"])}))
    assert out[1][0] == out[0][0]
    for k, x in out[0][1].items():
        assert torch.equal(out[1][1][k], x), k


def test_attention_kernels_refuse_dtensors_on_the_card(dev, card_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import ops
    from repro_torch.models.attention import attention

    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (DTensor.from_local(
        torch.randn(1, 512, 4, 64, generator=g, device=dev)
        .to(torch.bfloat16), card_mesh, [Replicate()] * 2)
        for _ in range(3))
    lengths = torch.full((1,), 100, device=dev)
    with torch.no_grad():
        with pytest.raises(ValueError, match="not DTensors"):
            ops.flash_attention(q, k, v)
        with pytest.raises(ValueError, match="not DTensors"):
            ops.decode_attention(q[:, :1], k, v, lengths)
        # the model's dispatch hands the kernels each rank's local shards
        from repro_torch.kernels import decode_attention as tda
        from repro_torch.kernels import flash_attention as tfa
        from repro_torch.models.attention import decode_attention
        before = (tfa.launches, tda.launches)
        out = attention(q, k, v, impl="pallas")
        dec = decode_attention(q[:, :1], k, v, lengths, impl="pallas")
        assert (tfa.launches, tda.launches) == (before[0] + 1, before[1] + 1)
        assert torch.equal(out.to_local(), ops.flash_attention(
            q.to_local(), k.to_local(), v.to_local()))
        assert torch.equal(dec.to_local(), ops.decode_attention(
            q.to_local()[:, :1], k.to_local(), v.to_local(), lengths))


# ---------------------------------------------------------------------------
# The paper-experiment twins and the tuner shims on the card
# ---------------------------------------------------------------------------

#: twin -> the CAM kernels its ``--smoke`` run must launch (a single
#: ``CostSession.estimate`` prices with torch ops on the card, as JAX's
#: prices with jnp: quickstart and the accuracy tables launch none)
PAPER_TWIN_KERNELS = {
    "bench_tuning_e2e": ("price_grid", "profile_grid"),
    "quickstart": (),
    "tune_pgm": ("price_grid",),
    "bench_engine": ("price_grid",),
    "bench_profile_grid": ("profile_grid",),
    "bench_estimate_grid": ("price_grid", "profile_grid"),
    "bench_pgm_tuning_curve": ("price_grid",),
    "bench_rmi_tuning_curve": ("price_grid", "profile_grid"),
    "bench_point_accuracy": (),
    "bench_range_accuracy": (),
    "bench_io_size": (),
    "bench_covariance": (),
    "bench_fetch_strategy": (),
    "bench_kernels": ("che_solve",),
    "bench_join": ("price_grid",),
    "hybrid_join": (),              # choose under LRU: one estimate
    "join_tree": ("price_grid",),
    "serve_adaptive": ("price_grid",),
    "shard_fleet": ("price_grid",),
    "update_heavy": ("price_grid",),
    "bench_kv_planner": (),
}


@pytest.mark.parametrize("name", sorted(PAPER_TWIN_KERNELS))
def test_paper_twin_smoke_on_the_card(dev, name, capsys):
    """Each twin's ``--smoke`` run on the card: its gates hold (the twins
    raise otherwise), its record says where it ran, and it launched the
    kernels of its path (the device executor is the card's default)."""
    import importlib

    from repro_torch.kernels import che_solver as tche

    mod = importlib.import_module(f"repro_torch.launch.{name}")
    count = {"price_grid": lambda: tpg.launches,
             "profile_grid": lambda: tprof.launches,
             "che_solve": lambda: tche.solve_launches}
    before = {k: f() for k, f in count.items()}
    record = mod.main(["--smoke", "--device", "cuda"])
    torch.cuda.synchronize()
    capsys.readouterr()
    assert record["torch_device"] == "cuda"
    for kernel in PAPER_TWIN_KERNELS[name]:
        assert count[kernel]() > before[kernel], kernel
    if "gates" in record:
        assert all(v for k, v in record["gates"].items() if "warm" not in k)
        assert isinstance(record["gates"]["fused_2.0x_warm"], bool)
    if name == "bench_kernels":
        assert count["che_solve"]() - before["che_solve"] == 2
        assert record["consistency_err"] <= 1e-4


def test_mesh_serve_on_the_card_matches_meshless(dev, card_mesh):
    """``ServeEngine.generate`` of a reduced float32 model on a one-rank
    NCCL mesh under ``attn_impl="pallas"`` (a 300-token prompt, so prefill
    reaches the flash kernel): the mesh-less tokens, prefill logits within
    1e-5 of their max-abs, and in each run one flash launch a layer and
    one decode launch a layer and step."""
    import dataclasses

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.distributed.sharding import Recipe, is_dtensor
    from repro_torch.kernels import decode_attention as tda
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.models.params import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(reduced(ARCHS["starcoder2-3b"]),
                              dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 300)).astype(np.int32)
    recipe = Recipe(remat="none", attn_impl="pallas")
    runs = []
    for mesh in (None, card_mesh):
        eng = ServeEngine(cfg, params, mesh=mesh, recipe=recipe,
                          max_seq=320, device=dev)
        assert all(is_dtensor(x) == (mesh is not None)
                   for x in eng.params["blocks"].values())
        tfa.launches = tda.launches = 0
        res = eng.generate(prompts, 6)
        runs.append((res, tfa.launches, tda.launches))
    (a, fa, da), (b, fb, db) = runs
    np.testing.assert_array_equal(b.tokens, a.tokens)
    assert float((b.prefill_logits - a.prefill_logits).abs().max()) <= \
        1e-5 * float(a.prefill_logits.abs().max())
    assert (fa, da) == (fb, db) == (cfg.num_layers, cfg.num_layers * 6)


def test_tuner_shims_on_the_card_match_the_cpu(dev):
    """The deprecated shims on the card choose what they choose on the CPU,
    with I/O within rtol 1e-5 or 2e-6 E[DAC]."""
    import warnings

    from repro_torch.core.cam import CamGeometry
    from repro_torch.data.datasets import make_dataset
    from repro_torch.data.workloads import WorkloadSpec, point_workload
    from repro_torch.tuning import pgm_tuner, rmi_tuner

    keys = make_dataset("books", 200_000, seed=1)
    qk, qpos = point_workload(keys, 20_000, WorkloadSpec("w4", seed=3))
    geom, budget = CamGeometry(), 1 << 20
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for where in ("cuda", "cpu"):
            out[where] = (
                pgm_tuner.cam_tune_pgm(keys, qpos, budget, geom, "lfu",
                                       eps_grid=(16, 64, 256),
                                       torch_device=where),
                rmi_tuner.cam_tune_rmi(keys, qpos, qk, budget, geom, "lru",
                                       branch_grid=(256, 1024, 4096),
                                       torch_device=where))
    for got, want, knob in zip(out["cuda"], out["cpu"],
                               ("best_eps", "best_branch")):
        assert getattr(got, knob) == getattr(want, knob)
        best = want.estimates[getattr(want, knob)]
        assert abs(got.est_io - want.est_io) <= max(
            1e-5 * want.est_io, 2e-6 * best.dac)
