"""MXU sign-expansion search: ranking parity with the exact kernel."""

import jax.numpy as jnp
import numpy as np
import pytest

from gsearch_tpu.ops.distance import brute_force_knn
from gsearch_tpu.ops.mxu import MxuSearcher, expand_signs


def test_expand_signs_shape_and_values(rng):
    sigs = rng.integers(0, 1 << 30, size=(5, 16)).astype(np.uint32)
    e = np.asarray(expand_signs(jnp.asarray(sigs), m=4))
    assert e.shape == (5, 64)
    assert set(np.unique(e)) <= {-1, 1}
    # determinism + equality propagation: equal slots -> equal sign blocks
    e2 = np.asarray(expand_signs(jnp.asarray(sigs), m=4))
    np.testing.assert_array_equal(e, e2)


def test_score_estimates_jaccard(rng):
    s, m = 2048, 4
    a = rng.integers(0, 1 << 30, size=(1, s)).astype(np.uint32)
    b = a.copy()
    differ = rng.random(s) < 0.3  # true J = 0.7
    b[0, differ] = rng.integers(0, 1 << 30, size=differ.sum(), dtype=np.uint32)
    ea = np.asarray(expand_signs(jnp.asarray(a), m=m)).astype(np.int32)
    eb = np.asarray(expand_signs(jnp.asarray(b), m=m)).astype(np.int32)
    score = (ea * eb).sum()
    j_est = score / (m * s)
    j_true = 1.0 - differ.mean()
    assert abs(j_est - j_true) < 4.5 / (2 * np.sqrt(m * s)) + 0.01


@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.uint16])
def test_mxu_search_matches_exact(rng, dtype):
    # clusters whose members sit at DISTINCT distances from the center, so
    # the exact top-k is unambiguous (no tie-broken oracle)
    n_clusters, per, s, k = 10, 70, 256, 10
    n = n_clusters * per
    centers = rng.integers(0, 1 << 20, size=(n_clusters, s)).astype(np.uint32)
    base = np.empty((n, s), np.uint32)
    for c in range(n_clusters):
        for r in range(per):
            x = centers[c].copy()
            n_pert = 5 + 3 * r  # distinct distance per member
            pos = rng.choice(s, n_pert, replace=False)
            x[pos] = rng.integers(1 << 20, 1 << 21, size=n_pert, dtype=np.uint32)
            base[c * per + r] = x
    queries_u = centers.copy()  # query at each cluster center
    if dtype == np.float32:
        sigs = (base.astype(np.float64) / 2**32).astype(np.float32)
        queries = (queries_u.astype(np.float64) / 2**32).astype(np.float32)
    else:
        sigs = base.astype(dtype)
        queries = queries_u.astype(dtype)
    db = sigs

    searcher = MxuSearcher(db, m=4, rerank_factor=8)
    d_mxu, ids_mxu = searcher.search(queries, knbn=k)
    d_ref, ids_ref = brute_force_knn(jnp.asarray(queries), jnp.asarray(db), k)
    d_ref, ids_ref = np.asarray(d_ref), np.asarray(ids_ref)

    # distances of returned hits are exact; recall vs oracle is ~1
    recall = np.mean([
        len(set(ids_mxu[i]) & set(ids_ref[i])) / k for i in range(len(queries))
    ])
    assert recall >= 0.95, f"recall {recall}"
    np.testing.assert_allclose(d_mxu[:, 0], d_ref[:, 0], atol=1e-6)


def test_mxu_searcher_bucketing(rng):
    """Odd N/Q sizes work (pad rows never returned)."""
    n, s, k = 77, 64, 5
    sigs = rng.integers(0, 1 << 20, size=(n, s)).astype(np.uint32)
    searcher = MxuSearcher(sigs, m=4)
    d, ids = searcher.search(sigs[:3], knbn=k)
    assert ids.shape == (3, k)
    assert (ids[:, 0] == np.arange(3)).all()
    assert (ids < n).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-6)


def _clustered_db(rng, n_clusters, per, s):
    """Clusters whose members sit at distinct distances from the center."""
    centers = rng.integers(0, 1 << 20, size=(n_clusters, s)).astype(np.uint32)
    base = np.empty((n_clusters * per, s), np.uint32)
    for c in range(n_clusters):
        for r in range(per):
            x = centers[c].copy()
            n_pert = 5 + 3 * r
            pos = rng.choice(s, n_pert, replace=False)
            x[pos] = rng.integers(1 << 20, 1 << 21, size=n_pert, dtype=np.uint32)
            base[c * per + r] = x
    return centers, base


def test_mxu_compact_matches_exact(rng):
    """Compact mode (m=2 expansion + packed 16-bit-hash rerank) returns the
    exact oracle's top-k; distances deviate by at most the 2^-16/slot
    hash-collision bias."""
    n_clusters, per, s, k = 10, 70, 256, 10
    centers, sigs = _clustered_db(rng, n_clusters, per, s)
    queries = centers.copy()

    searcher = MxuSearcher(sigs, compact=True)
    assert searcher.compact and searcher.m == 2
    d_c, ids_c = searcher.search(queries, knbn=k)
    d_ref, ids_ref = brute_force_knn(
        jnp.asarray(queries), jnp.asarray(sigs), k)
    d_ref, ids_ref = np.asarray(d_ref), np.asarray(ids_ref)
    recall = np.mean([
        len(set(ids_c[i]) & set(ids_ref[i])) / k for i in range(len(queries))
    ])
    assert recall >= 0.95, f"compact recall {recall}"
    # rank-aligned distance agreement within the hash-collision bias
    np.testing.assert_allclose(d_c[:, 0], d_ref[:, 0], atol=3.0 / s)


def test_mxu_compact_from_chunks(rng):
    """from_chunks builds the same searcher as the one-shot constructor."""
    n, s, k = 300, 128, 5
    sigs = rng.integers(0, 1 << 20, size=(n, s)).astype(np.uint32)
    whole = MxuSearcher(sigs, compact=True)
    chunked = MxuSearcher.from_chunks(
        (sigs[i : i + 100] for i in range(0, n, 100)), n, s, compact=True)
    q = sigs[:7]
    d_w, ids_w = whole.search(q, knbn=k)
    d_c, ids_c = chunked.search(q, knbn=k)
    np.testing.assert_array_equal(ids_w, ids_c)
    np.testing.assert_allclose(d_w, d_c, atol=1e-6)
    assert (ids_c[:, 0] == np.arange(7)).all()


def test_mxu_compact_auto_threshold(rng):
    """Auto mode stays full-fidelity for small databases and the explicit
    flag forces compact (the auto cutoff needs ~8 GB-scale inputs that do
    not fit a unit test)."""
    sigs = rng.integers(0, 1 << 20, size=(64, 64)).astype(np.uint32)
    assert MxuSearcher(sigs).compact is False
    assert MxuSearcher(sigs, compact=True).compact is True


def test_mxu_big_bucket_fill_paths(rng):
    """N > 8192 exercises the preallocate+donated-write init in both modes
    and from_chunks with full 8192-row chunks."""
    n, s, k = 9000, 64, 5
    sigs = rng.integers(0, 1 << 20, size=(n, s)).astype(np.uint32)
    for compact in (False, True):
        whole = MxuSearcher(sigs, compact=compact)
        chunked = MxuSearcher.from_chunks(
            (sigs[i : i + 8192] for i in range(0, n, 8192)), n, s,
            compact=compact)
        q = sigs[4000:4008]
        d_w, ids_w = whole.search(q, knbn=k)
        d_c, ids_c = chunked.search(q, knbn=k)
        np.testing.assert_array_equal(ids_w, ids_c)
        assert (ids_w[:, 0] == np.arange(4000, 4008)).all()
        np.testing.assert_allclose(d_w[:, 0], 0.0, atol=1e-6)
