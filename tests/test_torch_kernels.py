"""Port kernels vs the JAX Pallas kernels (interpret mode) on the CPU.

* ``price_grid_ref`` (the plain torch version of the CUDA price kernel) vs
  ``repro.kernels.price_grid.price_grid(interpret=True)`` for every
  ``policy`` x ``has_sorted`` x ``has_write`` variant, with padded cells,
  ragged page counts and exact objective ties: h <= 2e-6 (float32
  summation order), argmin agreement up to objective ties at rtol 1e-5.
* ``profile_grid_ref`` vs ``repro.kernels.profile_grid.profile_grid`` and
  the port's ``point_page_refs_mixed_eps_grid`` vs both JAX mixed-eps
  paths, mirroring tests/test_kernels.py: integer mass exact, general mass
  <= 2e-6 normalized, non-pow2 eps, eps=0 clamped to 1, ragged shapes.
* The wrappers take their plain versions on CPU tensors only (no launch
  counted); the kernels themselves run on the card
  (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import page_ref as jpage_ref
from repro.kernels import price_grid as jpg
from repro.kernels import profile_grid as jprof
from repro_torch.kernels import price_grid as tpg
from repro_torch.kernels import profile_grid as tprof


# ---------------------------------------------------------------------------
# price_grid
# ---------------------------------------------------------------------------

def _price_inputs(policy, has_sorted, has_write, seed=0, k=5, p=301, c=6):
    """A padded (K x C) table over random histograms, packed exactly as
    the DeviceExecutor packs it.  Rows 0 and 1 are bit-identical with
    identical cells, so the best cell is tied between them."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, (k, p)).astype(np.float32)
    counts[:, rng.random(p) < 0.3] = 0.0                 # absent pages
    counts[1] = counts[0]
    w_counts = np.zeros_like(counts)
    if has_write:
        w_counts = np.floor(counts * rng.random((k, p))).astype(np.float32)
        w_counts[1] = w_counts[0]
    sample = counts.sum(1)
    if k > 3:                                            # no-sample row
        sample[3] = 0.0
        counts[3] = 0.0
        w_counts[3] = 0.0
    probs = (counts / np.maximum(sample[:, None], 1e-30)).astype(np.float32)
    wprobs = (w_counts / np.maximum(sample[:, None], 1e-30)).astype(np.float32)
    nd = (counts > 0).sum(1)
    pos = np.where(probs > 0, probs, np.inf).min(1)
    pmin = np.maximum(np.where(np.isfinite(pos), pos, np.inf), 1e-30)

    caps_i = np.stack([rng.permutation(
        [int(nd[r]) // 3, int(nd[r]) // 2, int(nd[r]) + 5, -1, 0, 1][:c])
        for r in range(k)]).astype(np.int32)
    caps_i[1] = caps_i[0]
    ids = np.arange(k * c, dtype=np.int32).reshape(k, c)
    if k > 2:                                            # padded slots
        ids[2, 4:] = tpg.PAD_ID
        caps_i[2, 4:] = -1
    ids[1] = ids[0] + c                                  # tie: higher ids

    f32s = np.zeros((k, 16), np.float32)
    i32s = np.zeros((k, 8), np.int32)
    f32s[:, 0] = sample
    f32s[:, 1] = sample * 1.5
    f32s[:, 2] = nd
    f32s[:, 3] = pmin
    f32s[:, 8] = rng.uniform(1.0, 3.0, k).astype(np.float32)
    f32s[1, 8] = f32s[0, 8]
    i32s[:, 0] = nd
    i32s[:, 3] = rng.integers(0, 3, k)
    i32s[1, 3] = i32s[0, 3]
    cov = np.zeros((k, p), np.float32)
    if has_sorted:
        cov = rng.integers(0, 4, (k, p)).astype(np.float32)
        cov[1] = cov[0]
        s_nd = (cov > 0).sum(1)
        f32s[:, 4] = cov.sum(1)
        f32s[:, 5] = f32s[:, 4] * 1.5
        f32s[:, 6] = s_nd
        f32s[:, 7] = rng.integers(0, 20, k)
        f32s[1, 7] = f32s[0, 7]
        i32s[:, 1] = s_nd
        i32s[:, 2] = rng.integers(1, 8, k)
        i32s[1, 2] = i32s[0, 2]
    sorted_probs = -np.sort(-probs, axis=1)
    cov_desc = -np.sort(-cov, axis=1)
    wprobs_q = np.take_along_axis(wprobs, np.argsort(-probs, axis=1,
                                                     kind="stable"), axis=1)
    return dict(probs=probs, sorted_probs=sorted_probs, cov_desc=cov_desc,
                f32s=f32s, i32s=i32s, caps_f=caps_i.astype(np.float32),
                caps_i=caps_i, ids=ids,
                wprobs=wprobs if has_write else None,
                wprobs_q=wprobs_q if has_write else None)


def _run_price(policy, has_sorted, has_write, inputs):
    names = ("probs", "sorted_probs", "cov_desc", "f32s", "i32s", "caps_f",
             "caps_i", "ids", "wprobs", "wprobs_q")
    args_j = [None if inputs[n] is None else jnp.asarray(inputs[n])
              for n in names]
    args_t = [None if inputs[n] is None else torch.as_tensor(inputs[n])
              for n in names]
    hj, bvj, bij = jpg.price_grid(policy, *args_j, has_sorted=has_sorted,
                                  has_write=has_write, interpret=True)
    ht, bvt, bit = tpg.price_grid_ref(policy, *args_t, has_sorted=has_sorted,
                                      has_write=has_write)
    return (np.asarray(hj), float(np.asarray(bvj)[0, 0]),
            int(np.asarray(bij)[0, 0]), ht.numpy(), float(bvt[0, 0]),
            int(bit[0, 0]))


@pytest.mark.parametrize("policy", ("lru", "fifo", "lfu", "multi"))
@pytest.mark.parametrize("has_sorted", (False, True))
@pytest.mark.parametrize("has_write", (False, True))
def test_price_grid_ref_matches_pallas(policy, has_sorted, has_write):
    inputs = _price_inputs(policy, has_sorted, has_write)
    hj, bvj, bij, ht, bvt, bit = _run_price(policy, has_sorted, has_write,
                                            inputs)
    assert ht.shape == hj.shape
    assert np.max(np.abs(hj - ht)) < 2e-6
    # objective argmin agrees up to ties; the tied rows 0/1 resolve to the
    # lower id in both
    obj = np.where(inputs["ids"] < tpg.PAD_ID,
                   (1.0 - hj) * inputs["f32s"][:, 8:9], np.inf)
    flat_ids = inputs["ids"].ravel()
    at = {int(i): v for i, v in zip(flat_ids, obj.ravel())}
    assert np.isclose(at[bit], at[bij], rtol=1e-5, atol=1e-12)
    assert np.isclose(bvt, bvj, rtol=1e-5, atol=1e-12)
    if bij in inputs["ids"][0] or bij in inputs["ids"][1]:
        assert bit == bij


def test_price_grid_tie_goes_to_lowest_id():
    """Two bit-identical best cells: the lower id wins in both kernels."""
    inputs = _price_inputs("lru", False, False, seed=3, k=2, c=3)
    inputs["ids"] = np.asarray([[7, 8, 9], [1, 2, 3]], np.int32)
    _, _, bij, _, _, bit = _run_price("lru", False, False, inputs)
    assert bit == bij
    assert bit in (1, 2, 3)


def test_price_grid_all_padded_returns_pad_id():
    inputs = _price_inputs("fifo", True, False, seed=4, k=2, c=2)
    inputs["ids"][:] = tpg.PAD_ID
    _, bvj, bij, _, bvt, bit = _run_price("fifo", True, False, inputs)
    assert bij == bit == tpg.PAD_ID
    assert np.isinf(bvj) and np.isinf(bvt)


def test_price_grid_wrapper_takes_plain_version_on_cpu():
    inputs = _price_inputs("multi", True, True, seed=2)
    args = {n: None if v is None else torch.as_tensor(v)
            for n, v in inputs.items()}
    before = tpg.launches
    h, bv, bi = tpg.price_grid("multi", **args, has_sorted=True,
                               has_write=True)
    hr, bvr, bir = tpg.price_grid_ref("multi", **args, has_sorted=True,
                                      has_write=True)
    assert tpg.launches == before
    assert torch.equal(h, hr) and torch.equal(bi, bir)
    with pytest.raises(ValueError):
        tpg.price_grid("arc", **args, has_sorted=True)
    with pytest.raises(ValueError):
        tpg.price_grid("lru", **dict(args, wprobs=None), has_sorted=True,
                       has_write=True)


# ---------------------------------------------------------------------------
# profile_grid
# ---------------------------------------------------------------------------

C_IPP = 128


def _occupancy_trio(positions, eps_rows, num_pages):
    """JAX host, JAX device (interpret) and port mixed-eps histograms."""
    ch, th = jpage_ref.point_page_refs_mixed_eps_grid(
        positions, eps_rows, C_IPP, num_pages)
    cd, td = jprof.point_page_refs_mixed_eps_grid(
        positions, eps_rows, C_IPP, num_pages, interpret=True)
    ct, tt = tprof.point_page_refs_mixed_eps_grid(
        positions, eps_rows, C_IPP, num_pages, device="cpu")
    assert isinstance(ct, torch.Tensor) and ct.device.type == "cpu"
    assert np.asarray(ch).shape == tuple(ct.shape)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    return (f64(ch), f64(th), f64(cd), f64(td), ct.double().numpy(),
            f64(tt))


def test_occupancy_exact_for_integer_mass():
    """Slots >= 2*eps from both page boundaries make every LUT entry 0 or 1:
    the port's float32 sums carry the integer mass exactly."""
    rng = np.random.default_rng(11)
    num_pages, q = 40, 1500
    positions = rng.integers(0, num_pages, q) * C_IPP \
        + rng.integers(16, 112, q)
    eps_rows = rng.choice([1, 2, 4], size=(3, q)).astype(np.int64)
    ch, th, cd, td, ct, tt = _occupancy_trio(positions, eps_rows, num_pages)
    assert np.all(ch == np.round(ch))
    assert np.array_equal(ct, ch) and np.array_equal(ct, cd)
    assert np.array_equal(tt, th) and np.array_equal(tt, td)


def test_occupancy_general_within_float32_tolerance():
    rng = np.random.default_rng(5)
    num_pages, q = 64, 4000
    positions = rng.integers(0, num_pages * C_IPP, q)
    eps_rows = rng.choice([1, 4, 16, 64, 256], size=(4, q)).astype(np.int64)
    ch, th, cd, td, ct, tt = _occupancy_trio(positions, eps_rows, num_pages)
    scale = max(1.0, float(ch.max()))
    for ref_c, ref_t in ((ch, th), (cd, td)):
        assert np.max(np.abs(ref_c - ct)) / scale < 2e-6
        assert np.max(np.abs(ref_t - tt) / np.maximum(ref_t, 1.0)) < 2e-6


def test_occupancy_non_pow2_eps_fallback():
    rng = np.random.default_rng(9)
    num_pages, q = 32, 900
    positions = rng.integers(0, num_pages * C_IPP, q)
    eps_rows = rng.choice([3, 5, 12, 100], size=(2, q)).astype(np.int64)
    ch, th, cd, td, ct, tt = _occupancy_trio(positions, eps_rows, num_pages)
    scale = max(1.0, float(ch.max()))
    assert np.max(np.abs(ch - ct)) / scale < 2e-6
    assert np.max(np.abs(cd - ct)) / scale < 2e-6


def test_occupancy_eps_zero_clamped_to_one():
    rng = np.random.default_rng(2)
    num_pages, q = 16, 400
    positions = rng.integers(0, num_pages * C_IPP, q)
    *_, ct0, tt0 = _occupancy_trio(positions, np.zeros((1, q), np.int64),
                                   num_pages)
    *_, ct1, tt1 = _occupancy_trio(positions, np.ones((1, q), np.int64),
                                   num_pages)
    assert np.array_equal(ct0, ct1)
    assert np.array_equal(tt0, tt1)


@pytest.mark.parametrize("q,num_pages", [(100, 7), (777, 37), (513, 129)])
def test_occupancy_ragged_shapes(q, num_pages):
    rng = np.random.default_rng(q)
    positions = rng.integers(0, num_pages * C_IPP, q)
    eps_rows = rng.choice([2, 8], size=(2, q)).astype(np.int64)
    ch, th, cd, td, ct, tt = _occupancy_trio(positions, eps_rows, num_pages)
    assert ct.shape == (2, num_pages)
    scale = max(1.0, float(ch.max()))
    assert np.max(np.abs(ch - ct)) / scale < 2e-6
    assert np.max(np.abs(th - tt) / np.maximum(th, 1.0)) < 2e-6


def test_profile_grid_ref_matches_pallas_on_its_inputs():
    """The plain version on the Pallas kernel's own (padded) operands: its
    (W', CC') LUT stack read key-major with one full-width band."""
    rng = np.random.default_rng(21)
    k, q, num_pages, width = 3, 700, 50, 5
    cc = 2 * C_IPP
    keys = rng.integers(0, cc, (k, q)).astype(np.int32)
    keys[rng.random((k, q)) < 0.1] = -1                  # padded queries
    pages = rng.integers(0, num_pages, q).astype(np.int32)
    stack = np.zeros((8, 256), np.float32)               # W'=8, CC'=256
    stack[:width] = rng.integers(0, 3, (width, cc))
    pad = num_pages + width - 1
    out_j = np.asarray(jprof.profile_grid(
        jnp.asarray(keys), jnp.asarray(pages[None, :]), jnp.asarray(stack),
        width=width, pad=pad, interpret=True))
    before = tprof.launches
    out_t = tprof.profile_grid(
        torch.as_tensor(keys), torch.as_tensor(pages),
        torch.as_tensor(np.ascontiguousarray(stack[:width].T)),
        torch.as_tensor(np.asarray([[0, width - 1]], np.int32)),
        c_ipp=cc, pad=pad)
    assert tprof.launches == before                      # CPU: plain version
    assert np.array_equal(out_t.numpy(), out_j)
