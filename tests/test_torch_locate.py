"""``repro_torch.core.workload.locate`` where the query dtype differs from
the key file's, on the CPU.

Float queries into integer keys whose float images are exact (the file's
ends within +-2**53) are mapped into the key dtype and searched there;
elsewhere ``np.searchsorted`` converts the key file as before.  Either way
every rank equals ``min(np.searchsorted(keys, q, side="left"), n - 1)``
and the JAX package's ``repro.core.workload.locate``, bit for bit: over
uint64 and int64 key files (books-shaped below 2**53, duplicate runs,
straddling 2**53, reaching the dtype's top, starting at 0 or below), and
queries as float64, float32, int64 and uint64 arrays and as the Python
float and int lists ``serving.trace.compile_events`` builds.  A memory
case holds the mapped path to no copy of the key file, and the fallback's
``locate.cast_bytes`` to the bytes ``tracemalloc`` sees it allocate.
"""
import tracemalloc

import numpy as np
import pytest

from _hyp import given, settings, st
from repro.core.workload import locate as jax_locate
from repro_torch import obs
from repro_torch.core.workload import locate
from repro_torch.data.datasets import make_dataset
from repro_torch.serving import trace as tr

EXACT = 2**53
N = 2000


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _books(dtype):
    keys = make_dataset("books", N, seed=7)
    assert int(keys[-1]) < EXACT
    return keys.astype(dtype)


def _dups(dtype):
    rng = np.random.default_rng(1)
    runs = np.sort(rng.integers(0, 10**6, N // 8))
    return np.repeat(runs, rng.integers(1, 16, runs.size)).astype(dtype)


def _straddle(dtype):
    # every integer near 2**53, where float64 holds only the even ones
    near = np.arange(EXACT - N // 2, EXACT + N // 2, dtype=np.int64)
    return np.concatenate([[0, 1, 2**40], near, [EXACT + 2**20]]).astype(dtype)


def _top(dtype):
    top = np.iinfo(dtype).max
    tail = np.array([top - 2**12, top - 2**11 - 1, top - 1, top, top], dtype)
    return np.concatenate([_books(dtype)[:N // 2], tail])


def _bottom(dtype):
    keys = _books(dtype)[:N // 2] - _books(dtype)[0]        # starts at 0
    if dtype == np.int64:
        low = np.iinfo(np.int64).min
        keys = np.concatenate([[low, low + 1, -2**53 - 1, -2**53, -3], keys])
    return keys.astype(dtype)


KEY_FILES = {"books": _books, "dups": _dups, "straddle-2**53": _straddle,
             "top": _top, "bottom": _bottom}


def _float_queries(keys):
    """Each key's image, the midpoints, signed zeros, negatives, the
    dtype's extremes, values at and past 2**64, infinities, NaN last."""
    img = keys.astype(np.float64)
    mids = img[:-1] / 2 + img[1:] / 2
    info = np.iinfo(keys.dtype)
    edges = [0.0, -0.0, -0.5, -1.0, -1e30, 0.5, float(info.min),
             float(info.max), np.nextafter(float(info.max), 0.0), 2.0**53,
             2.0**53 + 2, np.nextafter(2.0**53, 0.0), 2.0**63, 2.0**64,
             1e30, np.inf, -np.inf, np.nan, 1.0]
    q = np.concatenate([img, mids, img + 0.5, img - 0.5, edges])
    q = q[np.random.default_rng(2).permutation(q.size)]
    return np.concatenate([q, [np.nan]])


def _int_queries(keys, dtype):
    """Each key, its neighbours and the query dtype's extremes, as ``dtype``
    (values it cannot hold left out)."""
    info = np.iinfo(dtype)
    k = [int(v) for v in keys]
    vals = k + [v + 1 for v in k] + [v - 1 for v in k] + [
        0, 1, -1, info.min, info.max, 2**53, 2**53 + 1, -2**53 - 1]
    vals = [v for v in vals if info.min <= v <= info.max]
    return np.array(vals, dtype)[np.random.default_rng(3).permutation(
        len(vals))]


def _queries(keys, form):
    if form == "float64":
        return _float_queries(keys)
    if form == "float32":
        return _float_queries(keys).astype(np.float32)
    if form in ("int64", "uint64"):
        return _int_queries(keys, np.dtype(form))
    if form == "py-float":
        return _float_queries(keys).tolist()
    assert form == "py-int"
    return _int_queries(keys, np.int64).tolist()


def _expected(keys, q):
    want = np.minimum(np.searchsorted(keys, np.asarray(q), side="left"),
                      keys.size - 1)
    np.testing.assert_array_equal(jax_locate(keys, q), want)
    return want


def _exact(keys):
    return -EXACT <= int(keys[0]) and int(keys[-1]) <= EXACT


@pytest.mark.parametrize("form", ("float64", "float32", "int64", "uint64",
                                  "py-float", "py-int"))
@pytest.mark.parametrize("name", KEY_FILES)
@pytest.mark.parametrize("key_dtype", ("uint64", "int64"))
def test_ranks_equal_searchsorted(key_dtype, name, form):
    keys = KEY_FILES[name](np.dtype(key_dtype))
    assert np.all(keys[:-1] <= keys[1:])
    q = _queries(keys, form)
    obs.enable()
    got = locate(keys, q)
    obs.disable()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _expected(keys, q))
    counters = obs.snapshot()["counters"]
    qa = np.asarray(q)
    if qa.dtype == keys.dtype:
        assert counters == {}
    elif _exact(keys):
        assert counters == {"locate.mapped_queries": qa.size}
    else:
        assert set(counters) == {"locate.cast_bytes"}


@pytest.mark.parametrize("key_dtype", ("uint64", "int64"))
@pytest.mark.parametrize("q", ([np.nan], [np.nan, 1.0, 0.0], [np.inf],
                               [-np.inf], [0.0], [-0.0], [2.0**64], [1e300],
                               [-1e300], 5.5, np.nan, []),
                         ids=("nan", "nan-first", "inf", "-inf", "0.0",
                              "-0.0", "2**64", "1e300", "-1e300", "scalar",
                              "scalar-nan", "empty"))
def test_lone_queries(key_dtype, q):
    keys = _books(np.dtype(key_dtype))
    q = np.asarray(q, np.float64)
    got = locate(keys, q)
    assert got.shape == q.shape
    np.testing.assert_array_equal(got, _expected(keys, q))


def test_one_key_file():
    keys = np.array([7], np.uint64)
    q = np.array([-1.0, 6.5, 7.0, 7.5, np.nan])
    np.testing.assert_array_equal(locate(keys, q), _expected(keys, q))


@settings(max_examples=200, deadline=None)
@given(st.sampled_from(("uint64", "int64")),
       st.lists(st.one_of(st.integers(0, 64),
                          st.integers(2**53 - 8, 2**53 + 8),
                          st.integers(-2**63, 2**64 - 1)),
                min_size=1, max_size=40),
       st.lists(st.one_of(st.floats(allow_nan=True, allow_infinity=True),
                          st.floats(-2.0, 70.0),
                          st.floats(2.0**53 - 16, 2.0**53 + 16)),
                min_size=1, max_size=40))
def test_property_ranks_equal_searchsorted(key_dtype, key_vals, q):
    info = np.iinfo(key_dtype)
    keys = np.sort(np.array([min(max(v, info.min), info.max)
                             for v in key_vals], dtype=key_dtype))
    q = np.asarray(q, np.float64)
    np.testing.assert_array_equal(locate(keys, q), _expected(keys, q))


def test_compile_events_float_keys_locate_as_uint64():
    """JSONL float keys and the same keys as uint64 compile alike."""
    keys = _books(np.uint64)
    rng = np.random.default_rng(4)
    events_u, events_f = [], []
    for i, op in enumerate(rng.choice(["point", "range", "sorted",
                                       "insert", "delete"], 300)):
        a = int(rng.integers(0, N - 40))
        if op in ("point", "insert", "delete"):
            events_u.append(tr.TraceEvent(op, key=keys[a], ts=i))
            events_f.append(tr.TraceEvent(op, key=float(keys[a]), ts=i))
        else:
            b = a + int(rng.integers(0, 40))
            events_u.append(tr.TraceEvent(op, lo_key=keys[a], hi_key=keys[b],
                                          ts=i))
            events_f.append(tr.TraceEvent(op, lo_key=float(keys[a]),
                                          hi_key=float(keys[b]), ts=i))
    events_f = list(tr.parse_jsonl(tr.to_jsonl(events_f).splitlines()))
    obs.enable()
    got = tr.compile_events(events_f, keys)
    obs.disable()
    want = tr.compile_events(events_u, keys)
    assert [p.kind for p in got.parts] == [p.kind for p in want.parts]
    for g, w in zip(got.parts, want.parts):
        np.testing.assert_array_equal(g.positions, w.positions)
        if w.hi_positions is not None:
            np.testing.assert_array_equal(g.hi_positions, w.hi_positions)
    counters = obs.snapshot()["counters"]
    assert "locate.cast_bytes" not in counters
    assert counters["locate.mapped_queries"] == sum(
        1 + (e.op in ("range", "sorted")) for e in events_f)


def _peak(fn):
    """Bytes ``tracemalloc`` sees ``fn`` hold at its peak, above its start."""
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        fn()
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


BIG = 2_000_000


def test_mapped_path_copies_no_key_file():
    keys = make_dataset("books", BIG, seed=5)
    assert int(keys[-1]) < EXACT
    q = keys[np.random.default_rng(6).integers(0, BIG, 4096)].astype(
        np.float64)
    assert _peak(lambda: locate(keys, q)) < keys.nbytes / 4
    np.testing.assert_array_equal(locate(keys, q), _expected(keys, q))


@pytest.mark.parametrize("query_dtype", ("float64", "int64"))
def test_fallback_cast_bytes_are_the_bytes_allocated(query_dtype):
    """Above 2**53 ``searchsorted`` converts: ``locate.cast_bytes`` is what
    it allocates (within numpy's bookkeeping, a few hundred bytes)."""
    keys = make_dataset("books", BIG, seed=5) + np.uint64(2**60)
    q = keys[np.random.default_rng(6).integers(0, BIG, 8)].astype(query_dtype)
    peak = _peak(lambda: locate(keys, q))
    obs.enable()
    locate(keys, q)
    obs.disable()
    cast = obs.snapshot()["counters"]["locate.cast_bytes"]
    assert cast == 8 * (keys.size + (q.size if query_dtype == "int64" else 0))
    assert abs(peak - cast) < 1024
