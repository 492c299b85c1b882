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
