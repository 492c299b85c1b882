"""The port's Che solver against the JAX package on shared numpy inputs
(CPU), and the fused CUDA solve's arithmetic replayed in numpy.

* ``ref.che_solve_ref`` (the plain host loop the CPU path runs) against
  JAX's jitted ``che_solve`` with its Pallas ``che_sums`` in interpret
  mode, relative 1e-4 on T (the bound ``tests/test_torch_attention.py``
  holds the solver to), over K and pass counts and at the edges: capacity
  1, at and around the count of nonzero pages, one nonzero page,
  zero-padded probabilities, N = 1;
* a numpy replay of ``csrc/che_solve.cu``'s order of operations (per-
  thread sums over each block's slice, warp butterflies, warps in order,
  then the blocks' partials added lane-strided in block order and a last
  butterfly; the unfused bracket update) held against ``che_solve_ref``:
  T within 1e-5 relative, and the same bracket on every pass until one
  where a sum lies within 1e-6 of C (there the two orders may round to
  either side);
* the fused solve's launch plan (:func:`che_solver.solve_plan`) and the
  wrappers' argument checks.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache_models as jcm
from repro.kernels import ops as jops
from repro_torch.core import cache_models as tcm
from repro_torch.kernels import che_solver as tche
from repro_torch.kernels import ref as tref

F32 = np.float32
STAGE_MAX = 24_576          # probabilities a block stages (che_solve.cu)
THREADS = 512               # a block of the fused solve


def _zipf(n, seed, zero_frac=0.0):
    rng = np.random.default_rng(seed)
    p = rng.zipf(1.2, n).astype(np.float64)
    p[rng.random(n) < zero_frac] = 0.0
    if not p.any():
        p[0] = 1.0
    return (p / p.sum()).astype(F32)


def _solve_both(p, cap, k=8, iters=16):
    t_port = tref.che_solve_ref(torch.as_tensor(p), cap, k=k, iters=iters)
    assert t_port.dtype == torch.float32 and t_port.dim() == 0
    t_jax = float(jops.che_solve(jnp.asarray(p), cap, k=k, iters=iters,
                                 interpret=True))
    return float(t_port), t_jax


# ---------------------------------------------------------------------------
# the plain solve against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", (1, 4, 8, 16))
@pytest.mark.parametrize("iters", (14, 16, 20))
def test_che_solve_ref_matches_jax(k, iters):
    p = _zipf(3000, 100 * k + iters, zero_frac=0.2)
    for cap in (5.0, 300.0, 1500.0):
        t_port, t_jax = _solve_both(p, cap, k, iters)
        assert abs(t_port - t_jax) <= 1e-4 * t_jax, (cap, t_port, t_jax)


def _edge(case):
    """(probs, capacities) of one edge case."""
    if case == "capacity_1":
        return _zipf(2000, 1), (1.0,)
    if case == "nonzero_count_minus_1":
        p = _zipf(800, 2, zero_frac=0.3)
        return p, (float((p > 0).sum() - 1),)
    if case == "at_nonzero_count":
        p = _zipf(800, 3, zero_frac=0.3)
        return p, (float((p > 0).sum()),)
    if case == "above_nonzero_count":
        p = _zipf(800, 4, zero_frac=0.3)
        nnz = float((p > 0).sum())
        return p, (nnz + 1.0, 2.0 * nnz)
    if case == "one_nonzero_page":
        p = np.zeros(500, F32)
        p[17] = 1.0
        return p, (0.25, 0.5, 1.0)
    if case == "zero_padded":
        return np.concatenate([_zipf(1000, 5), np.zeros(1000, F32)]), \
            (10.0, 300.0)
    if case == "n_1":
        return np.ones(1, F32), (0.5, 1.0)
    raise AssertionError(case)


EDGES = ("capacity_1", "nonzero_count_minus_1", "at_nonzero_count",
         "above_nonzero_count", "one_nonzero_page", "zero_padded", "n_1")


def _saturation(p, t):
    """(sum_i 1 - exp(-p_i t), sum_i p_i (1 - exp(-p_i t))) in float64."""
    occ = -np.expm1(-p.astype(np.float64) * t)
    return occ.sum(), (p * occ).sum()


@pytest.mark.parametrize("case", EDGES)
def test_che_solve_ref_edges_match_jax(case):
    """T within 1e-4 of JAX's, except at a capacity equal to the count of
    nonzero pages (more than one): there the sum only reaches C once it
    saturates, so T is wherever the float32 sum of the nonzero terms first
    rounds to C, which the summation order sets (the two differ by ~8%
    here).  That case is held to what is defined: both T saturate the
    sum, and their hit rates agree."""
    p, caps = _edge(case)
    nnz = float((p > 0).sum())
    for cap in caps:
        t_port, t_jax = _solve_both(p, cap)
        assert np.isfinite(t_port) and t_port > 0
        if cap == nnz > 1:
            (s_port, h_port), (s_jax, h_jax) = (_saturation(p, t_port),
                                                _saturation(p, t_jax))
            assert min(s_port, s_jax) >= cap * (1 - 1e-5), (s_port, s_jax)
            assert abs(h_port - h_jax) <= 1e-6 * h_jax
        else:
            assert abs(t_port - t_jax) <= 1e-4 * t_jax, (cap, t_port, t_jax)


@pytest.mark.parametrize("seed,cap", ((0, 8), (1, 60), (2, 200), (3, 1)))
def test_hit_rate_lru_solver_path_matches_jax(seed, cap):
    """The slice as a whole: ``hit_rate_lru(use_kernel=True)`` on the CPU
    (plain solve, h summed from its T) against JAX's kernel path."""
    p = _zipf(400, seed, zero_frac=0.3)
    h_port = tcm.hit_rate_lru(torch.as_tensor(p), cap, use_kernel=True)
    h_jax = float(jcm.hit_rate_lru(jnp.asarray(p), cap, use_kernel=True))
    assert h_port.dtype == torch.float32 and h_port.dim() == 0
    assert abs(float(h_port) - h_jax) <= 1e-4 * h_jax


def test_che_hit_rate_on_the_cpu_is_the_plain_solve():
    p = torch.as_tensor(_zipf(5000, 9))
    s0, c0 = tche.solve_launches, tche.launches
    t, h = tche.che_hit_rate(p, 250, k=8, iters=16)
    assert (tche.solve_launches, tche.launches) == (s0, c0)
    assert torch.equal(t, tref.che_solve_ref(p, 250, k=8, iters=16))
    assert torch.equal(t, tche.che_solve(p, 250, k=8, iters=16))
    assert torch.equal(h, torch.sum(p * -torch.expm1(-p * t)))


# ---------------------------------------------------------------------------
# the fused kernel's order of operations, replayed in numpy
# ---------------------------------------------------------------------------

def _butterfly(v, axis):
    """``v += shfl_xor(v, o)`` for o = n/2 .. 1 along ``axis`` (every lane
    ends with the same bits); returns lane 0."""
    n = v.shape[axis]
    lanes = np.arange(n)
    o = n // 2
    while o:
        v = (v + np.take(v, lanes ^ o, axis=axis)).astype(F32)
        o //= 2
    return np.take(v, 0, axis=axis)


def _grid_sums(slices, t):
    """(K,) sums of -expm1(-p t) as one pass of the kernel adds them:
    thread-strided sums over each slice, warp butterflies, warps in order;
    then lane l adds the blocks l, l + 32, ... in order, and a butterfly
    over the 32 lanes."""
    parts = []
    for sl in slices:
        rounds = max(-(-sl.shape[0] // THREADS), 1)
        padded = np.zeros(rounds * THREADS, F32)     # p = 0 adds exactly 0
        padded[:sl.shape[0]] = sl
        terms = (-np.expm1(-padded[:, None] * t[None, :])).astype(F32)
        terms = terms.reshape(rounds, THREADS, -1)
        acc = np.zeros(terms.shape[1:], F32)
        for r in range(rounds):
            acc = (acc + terms[r]).astype(F32)
        warps = _butterfly(acc.reshape(THREADS // 32, 32, -1), axis=1)
        block = np.zeros(warps.shape[1], F32)
        for w in range(warps.shape[0]):
            block = (block + warps[w]).astype(F32)
        parts.append(block)
    parts = np.stack(parts)
    lanes = np.zeros((32, parts.shape[1]), F32)
    for b in range(parts.shape[0]):
        lanes[b % 32] = (lanes[b % 32] + parts[b]).astype(F32)
    return _butterfly(lanes, axis=0)


def _kernel_replay(p, cap, k, iters, blocks):
    """T and each pass's (sums, bracket index) in the kernel's order."""
    n = p.shape[0]
    plan = tche.solve_plan(n, blocks)
    slices = [p[min(n, r * plan.slice):min(n, (r + 1) * plan.slice)]
              for r in range(blocks)]
    cap = F32(cap)
    pos = p[p > 0]
    pmin = max(F32(pos.min()) if pos.size else F32(np.inf), F32(1e-30))
    hi0 = max(F32(F32(4.0) * cap) / pmin, F32(1.0))
    log_lo, log_hi = np.log(F32(hi0 * F32(1e-30))), np.log(F32(hi0))
    fracs = np.arange(1, k + 1, dtype=F32) / F32(k + 1)
    passes = []
    for _ in range(iters):
        lt = (log_lo + ((log_hi - log_lo) * fracs).astype(F32)).astype(F32)
        sums = _grid_sums(slices, np.exp(lt).astype(F32))
        idx = int(np.sum(sums < cap))
        passes.append((sums, idx))
        pts = np.concatenate([[log_lo], lt, [log_hi]]).astype(F32)
        log_lo, log_hi = pts[idx], pts[idx + 1]
    return float(np.exp(F32(F32(0.5) * F32(log_lo + log_hi)))), passes


def _ref_passes(monkeypatch, p, cap, k, iters):
    """T of ``che_solve_ref`` and each pass's (sums, bracket index)."""
    passes = []
    plain = tref.che_sums_ref

    def recording(probs, ts):
        sums = plain(probs, ts)
        passes.append((sums.numpy(), int((sums < F32(cap)).sum())))
        return sums

    monkeypatch.setattr(tref, "che_sums_ref", recording)
    t = float(tref.che_solve_ref(torch.as_tensor(p), cap, k=k, iters=iters))
    monkeypatch.setattr(tref, "che_sums_ref", plain)
    return t, passes


@pytest.mark.parametrize("n,blocks,zero_frac", (
    (78_125, 132, 0.0),          # the Che path's rows on an H100 SXM
    (78_125, 114, 0.3),
    (1_000, 132, 0.2),
    (5, 132, 0.0),               # fewer pages than blocks
    (1, 132, 0.0),
    (200_003, 8, 0.1),           # slices past the staging budget
))
def test_kernel_order_replay_matches_plain_solve(monkeypatch, n, blocks,
                                                 zero_frac):
    """Capacities well inside (0, nnz): near nnz the solution is set by
    the rounding of a saturated sum (``test_che_solve_ref_edges_match_jax``
    covers that regime), not by the order being replayed."""
    p = _zipf(n, n + blocks, zero_frac)
    nnz = int((p > 0).sum())
    caps = sorted({max(nnz // 50, 1), max(nnz // 3, 1), max(nnz // 2, 1)})
    for cap in caps + [0.5]:
        t_kernel, k_passes = _kernel_replay(p, cap, 8, 16, blocks)
        t_plain, r_passes = _ref_passes(monkeypatch, p, cap, 8, 16)
        assert abs(t_kernel - t_plain) <= 1e-5 * t_plain, (cap, t_kernel,
                                                            t_plain)
        for (ks, ki), (rs, ri) in zip(k_passes, r_passes):
            if ki != ri:
                near = np.abs(np.concatenate([ks, rs]) - cap) <= 1e-6 * cap
                assert near.any(), (cap, ki, ri, ks, rs)
                break


# ---------------------------------------------------------------------------
# launch plan and argument checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blocks", (8, 114, 132))
@pytest.mark.parametrize("n", (1, 2, 7, 8, 9, 131, 132, 133, 4_096, 78_125,
                               196_608, 196_609, 1_000_003, 3_244_032,
                               3_244_033))
def test_solve_plan_covers_every_page_once(n, blocks):
    plan = tche.solve_plan(n, blocks)
    assert (plan.blocks, plan.threads) == (blocks, THREADS)
    assert tche.solve_plan(n, blocks) is plan                 # cached
    covered = np.zeros(n, np.int8)
    for r in range(blocks):
        j0 = min(n, r * plan.slice)
        covered[j0:min(n, j0 + plan.slice)] += 1
    assert (covered == 1).all()
    assert plan.staged == min(plan.slice, STAGE_MAX)
    assert plan.spilled == (plan.slice > STAGE_MAX)
    assert plan.smem_bytes <= 96 * 1024
    assert plan.spilled == (n > blocks * STAGE_MAX)


@pytest.mark.parametrize("n,blocks", ((0, 132), (10, 0), (-1, 8)))
def test_solve_plan_refuses(n, blocks):
    with pytest.raises(ValueError, match="solve_plan"):
        tche.solve_plan(n, blocks)


@pytest.mark.parametrize("case", ("two_dim", "k_0", "k_17", "iters_neg",
                                  "empty", "meta", "hit_rate_two_dim"))
def test_che_solve_wrapper_refuses(case):
    p = torch.as_tensor(_zipf(10, 0))
    call, match = {
        "two_dim": (lambda: tche.che_solve(p.reshape(2, 5), 3),
                    r"probs \(N,\)"),
        "k_0": (lambda: tche.che_solve(p, 3, k=0), "1 to 16"),
        "k_17": (lambda: tche.che_solve(p, 3, k=17), "1 to 16"),
        "iters_neg": (lambda: tche.che_solve(p, 3, iters=-1), "iters"),
        "empty": (lambda: tche.che_solve(p[:0], 3), "no page"),
        "meta": (lambda: tche.che_solve(torch.empty(10, device="meta"), 3),
                 "CPU or CUDA"),
        "hit_rate_two_dim": (lambda: tche.che_hit_rate(p.reshape(5, 2), 3),
                             r"probs \(N,\)"),
    }[case]
    s0, c0 = tche.solve_launches, tche.launches
    with pytest.raises(ValueError, match=match):
        call()
    assert (tche.solve_launches, tche.launches) == (s0, c0)
