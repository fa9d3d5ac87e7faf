import numpy as np
import pytest

from gsearch_tpu.index.flat import FlatIndex
from gsearch_tpu.index.hnsw import HnswIndex
from gsearch_tpu.index.serialize import dump_index, load_index


def _sig_cloud(rng, n, s, n_clusters=8):
    """Synthetic sketch-like signatures: cluster members share most slots."""
    centers = rng.integers(0, 1 << 30, size=(n_clusters, s)).astype(np.uint32)
    sigs = np.empty((n, s), dtype=np.uint32)
    for i in range(n):
        c = centers[i % n_clusters].copy()
        # perturb a random fraction of slots
        frac = rng.uniform(0.0, 0.5)
        mask = rng.random(s) < frac
        c[mask] = rng.integers(0, 1 << 30, size=mask.sum(), dtype=np.uint32)
        sigs[i] = c
    return sigs


def test_flat_index_roundtrip(rng, tmp_path):
    sigs = _sig_cloud(rng, 100, 64)
    idx = FlatIndex(sketch_size=64, sig_dtype=np.uint32)
    idx.insert(sigs)
    d, ids = idx.search(sigs[:5], knbn=3)
    assert (ids[:, 0] == np.arange(5)).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-6)

    dump_index(idx, str(tmp_path))
    idx2 = load_index(str(tmp_path))
    assert idx2.nb_points == 100
    d2, ids2 = idx2.search(sigs[:5], knbn=3)
    np.testing.assert_array_equal(ids, ids2)


def test_flat_index_device_resident(rng, tmp_path):
    """Device-array inserts (straight from an on-device sketcher or corpus
    generator) stay on device and search/persist identically to host ones."""
    import jax.numpy as jnp

    sigs = _sig_cloud(rng, 100, 64)
    host = FlatIndex(sketch_size=64, sig_dtype=np.uint32)
    host.insert(sigs)
    dev = FlatIndex(sketch_size=64, sig_dtype=np.uint32)
    dev.insert(jnp.asarray(sigs[:60]))
    dev.insert(jnp.asarray(sigs[60:]))  # device append path
    assert dev.nb_points == 100
    d_h, ids_h = host.search(sigs[:5], knbn=3)
    d_d, ids_d = dev.search(jnp.asarray(sigs[:5]), knbn=3)
    np.testing.assert_array_equal(ids_h, ids_d)
    np.testing.assert_allclose(d_h, d_d, atol=1e-6)

    mixed = FlatIndex(sketch_size=64, sig_dtype=np.uint32)
    mixed.insert(jnp.asarray(sigs[:60]))
    mixed.insert(sigs[60:])  # device-then-host falls back to host
    assert mixed.nb_points == 100

    dump_index(dev, str(tmp_path))
    idx2 = load_index(str(tmp_path))
    assert idx2.nb_points == 100
    _, ids2 = idx2.search(sigs[:5], knbn=3)
    np.testing.assert_array_equal(ids_h, ids2)


def test_hnsw_recall_vs_flat(rng, tmp_path):
    n, s, k = 3000, 128, 10
    all_sigs = _sig_cloud(rng, n + 20, s, n_clusters=32)
    sigs, queries = all_sigs[:n], all_sigs[n:]

    flat = FlatIndex(sketch_size=s, sig_dtype=np.uint32)
    flat.insert(sigs)
    _, true_ids = flat.search(queries, knbn=k)

    hnsw = HnswIndex(
        sketch_size=s, sig_dtype=np.uint32, max_nb_conn=24, ef_construction=96,
        search_prefix=s,
    )
    hnsw.insert(sigs, batch_size=512)
    true_d, _ = flat.search(queries, knbn=k)
    got_d, got_ids = hnsw.search(queries, knbn=k, ef_search=128)

    # raw id recall is confounded by equal-distance ties; count a miss only
    # when the returned distance is strictly worse than the oracle's
    recall = np.mean([
        len(set(true_ids[i]) & set(got_ids[i])) / k for i in range(len(queries))
    ])
    tie_aware = np.mean([
        1.0 - sum(1 for a, b in zip(sorted(got_d[i]), sorted(true_d[i]))
                  if a > b + 1e-6) / k
        for i in range(len(queries))
    ])
    assert tie_aware >= 0.99, f"tie-aware recall@{k} = {tie_aware:.3f} (raw {recall:.3f})"
    assert recall >= 0.85, f"raw recall@{k} = {recall:.3f}"

    # serialization roundtrip preserves results
    dump_index(hnsw, str(tmp_path))
    hnsw2 = load_index(str(tmp_path))
    _, got2 = hnsw2.search(queries, knbn=k, ef_search=128)
    np.testing.assert_array_equal(got_ids, got2)


def test_hnsw_incremental_insert(rng):
    s = 64
    sigs = _sig_cloud(rng, 500, s)
    hnsw = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16, ef_construction=64,
                     search_prefix=s)
    hnsw.insert(sigs[:300], batch_size=128)
    hnsw.insert(sigs[300:], batch_size=128)
    assert hnsw.nb_points == 500
    # self-queries must find themselves (or an exact-duplicate signature:
    # _sig_cloud can emit identical rows, and a distance-0 twin is a
    # correct answer)
    d, ids = hnsw.search(sigs[450:460], knbn=1, ef_search=64)
    for i, j in enumerate(range(450, 460)):
        assert ids[i, 0] == j or (
            d[i, 0] == 0.0 and (sigs[ids[i, 0]] == sigs[j]).all()
        ), f"query {j}: got {ids[i, 0]} at d={d[i, 0]}"


def test_hnsw_wide_ef_search(rng):
    """ef_search=5000 (the reference's hardcoded request ef, gsearch.rs:893)
    must work on a graph large enough that ef is not clamped below the old
    4096 visited-ring cap (regression: ring seed write needs >= ef slots)."""
    n, s, k = 6000, 64, 5
    all_sigs = _sig_cloud(rng, n + 8, s, n_clusters=16)
    sigs, queries = all_sigs[:n], all_sigs[n:]

    hnsw = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                     ef_construction=64, search_prefix=s)
    hnsw.insert(sigs, batch_size=1024)

    flat = FlatIndex(sketch_size=s, sig_dtype=np.uint32)
    flat.insert(sigs)
    true_d, _ = flat.search(queries, knbn=k)

    got_d, got_ids = hnsw.search(queries, knbn=k, ef_search=5000)
    assert got_ids.shape == (len(queries), k)
    tie_aware = np.mean([
        1.0 - sum(1 for a, b in zip(sorted(got_d[i]), sorted(true_d[i]))
                  if a > b + 1e-6) / k
        for i in range(len(queries))
    ])
    assert tie_aware >= 0.97, f"tie-aware recall@{k} at ef=5000: {tie_aware:.3f}"


def test_hnsw_prefix_rerank_paths(rng, monkeypatch):
    """search_prefix < S exercises the beam-on-prefix + full-sig rerank
    paths; device and host rerank must agree with the flat oracle."""
    n, s, k = 2600, 1024, 10
    all_sigs = _sig_cloud(rng, n + 16, s, n_clusters=24)
    sigs, queries = all_sigs[:n], all_sigs[n:]

    flat = FlatIndex(sketch_size=s, sig_dtype=np.uint32)
    flat.insert(sigs)
    true_d, _ = flat.search(queries, knbn=k)

    hnsw = HnswIndex(
        sketch_size=s, sig_dtype=np.uint32, max_nb_conn=24, ef_construction=96,
        search_prefix=256,
    )
    hnsw.insert(sigs, batch_size=512)

    def tie_aware(got_d):
        return np.mean([
            1.0 - sum(1 for a, b in zip(sorted(got_d[i]), sorted(true_d[i]))
                      if a > b + 1e-6) / k
            for i in range(len(queries))
        ])

    got_d_dev, ids_dev = hnsw.search(queries, knbn=k, ef_search=192)
    assert tie_aware(got_d_dev) >= 0.97, f"device-rerank recall {tie_aware(got_d_dev):.3f}"

    # force the host-rerank path and check it agrees with device rerank
    import gsearch_tpu.index.hnsw as hnsw_mod
    monkeypatch.setattr(hnsw_mod, "_RERANK_DEVICE_BYTES", 0)
    got_d_host, ids_host = hnsw.search(queries, knbn=k, ef_search=192)
    # equal-distance ties may order differently between top_k and
    # argpartition; distances must agree exactly, ids where untied
    np.testing.assert_allclose(got_d_host, got_d_dev, atol=1e-6)
    untied = got_d_dev[:, :-1] + 1e-9 < got_d_dev[:, 1:]
    row_untied = untied.all(axis=1)
    # even in internally-untied rows the LAST slot can tie with the
    # (k+1)-th candidate outside the returned list, where host/device
    # may legitimately pick different ids — compare all but the last
    np.testing.assert_array_equal(
        ids_host[row_untied][:, :-1], ids_dev[row_untied][:, :-1]
    )


def test_beam_gather_pallas_equivalence(rng):
    """Every traversal hop scores its candidate rows with gather_eqcount:
    the beam's returned prefix distances must be the exact distances of
    the returned ids, bit for bit (numpy re-score of the same rows)."""
    import jax.numpy as jnp

    from gsearch_tpu.index.hnsw import _graph_search

    n, s = 1500, 1024
    sigs = _sig_cloud(rng, n + 8, s, n_clusters=12)
    db, queries = sigs[:n], sigs[n:]

    idx = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                    ef_construction=64)
    idx.insert(db, batch_size=512)
    sigs_p, nbrs_p, entries = idx._device_arrays()
    d, ids = _graph_search(sigs_p, nbrs_p, entries, jnp.asarray(queries),
                           jnp.int32(n), ef=64, r=16, hops=12, expand=2)
    d, ids = np.asarray(d), np.asarray(ids)
    assert (ids < n).all()
    eq = (db[ids] == queries[:, None, :]).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(d, (np.float32(s) - eq) * np.float32(1.0 / s))
    assert (np.diff(d, axis=1) >= 0).all()


def test_hnsw_bulk_build_recall(rng, tmp_path):
    """Bulk construction (exact MXU kNN sweep -> heuristic links) matches
    or beats the incremental path's recall, roundtrips, and supports
    incremental `add` on top."""
    n, s, k = 3000, 128, 10
    all_sigs = _sig_cloud(rng, n + 20, s, n_clusters=32)
    sigs, queries = all_sigs[:n], all_sigs[n:]

    flat = FlatIndex(sketch_size=s, sig_dtype=np.uint32)
    flat.insert(sigs)
    true_d, true_ids = flat.search(queries, knbn=k)

    hnsw = HnswIndex(
        sketch_size=s, sig_dtype=np.uint32, max_nb_conn=24, ef_construction=96,
        search_prefix=s,
    )
    hnsw.insert(sigs, bulk=True)
    got_d, got_ids = hnsw.search(queries, knbn=k, ef_search=128)
    recall = np.mean([
        len(set(true_ids[i]) & set(got_ids[i])) / k for i in range(len(queries))
    ])
    tie_aware = np.mean([
        1.0 - sum(1 for a, b in zip(sorted(got_d[i]), sorted(true_d[i]))
                  if a > b + 1e-6) / k
        for i in range(len(queries))
    ])
    assert tie_aware >= 0.99, f"bulk tie-aware recall@{k} = {tie_aware:.3f}"
    assert recall >= 0.85, f"bulk raw recall@{k} = {recall:.3f}"

    # roundtrip + incremental add on top of a bulk-built graph
    dump_index(hnsw, str(tmp_path))
    hnsw2 = load_index(str(tmp_path))
    extra = _sig_cloud(rng, 64, s, n_clusters=4)
    hnsw2.insert(extra)  # n0 > 0 -> incremental path
    d3, ids3 = hnsw2.search(extra[:8], knbn=1, ef_search=64)
    # distance-0 self hit (the cloud may contain identical twins, so the
    # returned id is any of them — but it must be one of the added rows)
    np.testing.assert_allclose(d3[:, 0], 0.0, atol=1e-6)
    assert (ids3[:, 0] >= n).all()


def test_packed_rerank_matches_exact(rng, monkeypatch):
    """The 16-bit packed-hash rerank tier (used when the full matrix
    exceeds HBM) returns the exact tier's neighbors up to hash-collision
    noise (2^-16 per slot)."""
    n, s, k = 3000, 2048, 10
    sigs = _sig_cloud(rng, n + 16, s, n_clusters=24)
    db, queries = sigs[:n], sigs[n:]
    hnsw = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                     ef_construction=64, search_prefix=1024)
    hnsw.insert(db, bulk=False)

    d_exact, ids_exact = hnsw.search(queries, knbn=k, ef_search=96)
    monkeypatch.setenv("GSEARCH_TPU_FORCE_PACKED_RERANK", "1")
    d_packed, ids_packed = hnsw.search(queries, knbn=k, ef_search=96)

    assert hnsw._device_packed is not None  # the tier actually ran
    # distances agree to collision noise; neighbor SETS agree wherever the
    # distance gap exceeds it
    np.testing.assert_allclose(np.sort(d_packed, 1), np.sort(d_exact, 1),
                               atol=4.0 / s)
    same = np.mean([len(set(ids_packed[i]) & set(ids_exact[i])) / k
                    for i in range(len(queries))])
    assert same >= 0.95, f"packed/exact neighbor overlap {same:.3f}"


def test_packed8_rerank_matches_exact(rng, monkeypatch):
    """The 8-bit full-width packed tier (chosen when the 16-bit form would
    not cover all slots within HBM — the 524k x 12000 regime) returns the
    exact tier's neighbors up to 2^-8-per-slot collision noise."""
    from gsearch_tpu.index import hnsw as hnsw_mod

    n, s, k = 3000, 4096, 10
    sigs = _sig_cloud(rng, n + 16, s, n_clusters=24)
    db, queries = sigs[:n], sigs[n:]
    hnsw = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                     ef_construction=64, search_prefix=1024)
    hnsw.insert(db, bulk=False)

    d_exact, ids_exact = hnsw.search(queries, knbn=k, ef_search=96)
    # shrink the device budget so the 16-bit tier cannot cover all 4096
    # slots but the 8-bit full-width tier fits:
    #   16-bit needs 2*s = 8192 B/row, 8-bit needs s = 4096 B/row
    nbp1 = 4096 + 1
    budget = int(nbp1 * 6000 / 0.7)  # 6000 B/row of 0.7*budget
    monkeypatch.setenv("GSEARCH_TPU_FORCE_PACKED_RERANK", "1")
    monkeypatch.setattr(hnsw_mod, "_RERANK_DEVICE_BYTES", budget)
    assert hnsw._rerank_tier()[0] == "packed8"
    d_packed, ids_packed = hnsw.search(queries, knbn=k, ef_search=96)

    assert hnsw._device_packed is not None and hnsw._device_packed[1] == 8
    np.testing.assert_allclose(np.sort(d_packed, 1), np.sort(d_exact, 1),
                               atol=16.0 / s)
    same = np.mean([len(set(ids_packed[i]) & set(ids_exact[i])) / k
                    for i in range(len(queries))])
    assert same >= 0.9, f"packed8/exact neighbor overlap {same:.3f}"


def test_hnsw_bulk_add_recall(rng):
    """Bulk append (_bulk_add: MXU sweep of the new batch + single reverse
    merge) matches the recall of a FRESH bulk build of the same points —
    the parity criterion: appending must not degrade the graph vs
    rebuilding from scratch (reference role: dnasketch.rs:426-436, where
    add and build run the identical parallel_insert)."""
    n0, n1, s, k = 2000, 1500, 128, 10
    base = _sig_cloud(rng, n0, s, n_clusters=24)
    extra = _sig_cloud(rng, n1, s, n_clusters=16)
    allsigs = np.concatenate([base, extra], axis=0)
    queries = np.concatenate([base[:50], extra[:50]], axis=0)

    flat = FlatIndex(sketch_size=s, sig_dtype=np.uint32)
    flat.insert(allsigs)
    true_d, _ = flat.search(queries, knbn=k)

    def tie_aware(index):
        got_d, _ = index.search(queries, knbn=k, ef_search=128)
        return np.mean([
            1.0 - sum(1 for a, b in zip(sorted(got_d[i]), sorted(true_d[i]))
                      if a > b + 1e-6) / k
            for i in range(len(queries))
        ])

    kw = dict(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=24,
              ef_construction=96, search_prefix=s)
    fresh = HnswIndex(**kw)
    fresh.insert(allsigs, bulk=True)
    ta_fresh = tie_aware(fresh)

    grown = HnswIndex(**kw)
    grown.insert(base, bulk=True)
    grown.insert(extra, bulk=True)  # n0 > 0 -> bulk append path
    assert grown.nb_points == n0 + n1
    ta_grown = tie_aware(grown)
    assert ta_grown >= ta_fresh - 0.02, (
        f"bulk-add tie-aware recall@{k} = {ta_grown:.3f} vs fresh build "
        f"{ta_fresh:.3f}")
    # self-findability of the appended points: no worse than the same
    # points in the fresh build (this tie-heavy noise cloud defeats greedy
    # navigation for a few points in ANY graph build; the criterion is
    # that appending does not add misses)
    d2, _ = grown.search(extra[:32], knbn=1, ef_search=256)
    df, _ = fresh.search(extra[:32], knbn=1, ef_search=256)
    miss_grown = int((d2[:, 0] > 1e-6).sum())
    miss_fresh = int((df[:, 0] > 1e-6).sum())
    assert miss_grown <= miss_fresh + 1, (miss_grown, miss_fresh)


def test_packed4_rerank_matches_exact(rng, monkeypatch):
    """The 4-bit full-width packed tier (chosen when even the 8-bit form
    would not fit HBM — the 1M x 12000 regime) returns the exact tier's
    neighbors: its collision bias is affine in the true equal count
    (ranking-safe) and search() polishes the final top-k with an exact
    host re-score, so output distances are exact."""
    from gsearch_tpu.index import hnsw as hnsw_mod

    n, s, k = 3000, 6144, 10
    sigs = _sig_cloud(rng, n + 16, s, n_clusters=24)
    db, queries = sigs[:n], sigs[n:]
    hnsw = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                     ef_construction=64, search_prefix=1024)
    hnsw.insert(db, bulk=False)

    d_exact, ids_exact = hnsw.search(queries, knbn=k, ef_search=96)
    # budget per row between w4//2 = 4096 (4-bit over w4 = 8192 nibble
    # cols) and w8 = 8192 (8-bit over all slots): only packed4 fits
    nbp1 = 4096 + 1
    budget = int(nbp1 * 6000 / 0.7)
    monkeypatch.setenv("GSEARCH_TPU_FORCE_PACKED_RERANK", "1")
    monkeypatch.setattr(hnsw_mod, "_RERANK_DEVICE_BYTES", budget)
    assert hnsw._rerank_tier()[0] == "packed4"
    d_packed, ids_packed = hnsw.search(queries, knbn=k, ef_search=96)

    assert hnsw._device_packed is not None and hnsw._device_packed[1] == 4
    # the exact polish re-scores a 32-wide window: distances are EXACT
    # wherever both paths return the same neighbor sets
    same = np.mean([len(set(ids_packed[i]) & set(ids_exact[i])) / k
                    for i in range(len(queries))])
    assert same >= 0.9, f"packed4/exact neighbor overlap {same:.3f}"
    np.testing.assert_allclose(np.sort(d_packed, 1), np.sort(d_exact, 1),
                               atol=20.0 / s)


def test_coarse_estimator_only_fallback(rng, monkeypatch):
    """When the coarse searcher's full representation exceeds COARSE_BYTES
    the fallback is an estimator-only pool searcher (no 16-bit prefix
    rerank matrix), whose top-r pool still contains the true neighbors."""
    from gsearch_tpu.ops.distance import hamming_frac_xla
    import jax.numpy as jnp

    n, s = 3000, 2048
    sp = 1024
    sigs = _sig_cloud(rng, n + 8, s, n_clusters=24)
    db, queries = sigs[:n], sigs[n:]
    hnsw = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=16,
                     ef_construction=64, search_prefix=sp)
    hnsw.insert(db, bulk=False)

    # full rep at nb=4096 is nb*(4*sp + 4*sp) = 33.5 MB; estimator-only
    # m=4 is 16.8 MB: a 20 MB budget forces the fallback
    monkeypatch.setattr(HnswIndex, "COARSE_BYTES", 20_000_000)
    coarse = hnsw._coarse_searcher()
    assert coarse is not None and coarse.estimator_only
    assert coarse._rr3 is None

    # pool: estimator top-64 on the prefix must contain the exact
    # prefix-metric top-1 for nearly every query
    d_pool, pool = coarse.search(db[:64, :sp].copy(), knbn=64)
    d_true = np.asarray(hamming_frac_xla(
        jnp.asarray(db[:64, :sp].copy()), jnp.asarray(db[:, :sp].copy())))
    hit = np.mean([d_true[i].argmin() in pool[i] for i in range(64)])
    assert hit >= 0.95, f"estimator pool top-1 containment {hit:.3f}"


def test_append_sigs_capacity_buffer(rng):
    """_append_sigs grows the signature matrix in amortized O(new): the
    capacity buffer is reused across in-capacity appends (np.concatenate
    re-copied the WHOLE matrix each time — 27 GB/append at 524k x 12000),
    and externally-assigned matrices (load paths) migrate once."""
    s = 64
    idx = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=8,
                    ef_construction=32, search_prefix=s)
    a = _sig_cloud(rng, 100, s)
    idx._sigs = a[:0]  # externally assigned (empty)
    idx._append_sigs(a[:40])
    buf1 = idx._sigs_buf
    assert idx._sigs.base is buf1 and idx._sigs.shape == (40, s)
    # in-capacity append: same backing buffer, no migration
    idx._append_sigs(a[40:44])
    assert idx._sigs_buf is buf1 and idx._sigs.base is buf1
    np.testing.assert_array_equal(idx._sigs, a[:44])
    # externally re-assigned matrix (e.g. a dump reload): one migration
    idx._sigs = a[:60].copy()
    idx._append_sigs(a[60:100])
    assert idx._sigs_buf is not buf1
    np.testing.assert_array_equal(idx._sigs, a[:100])
    # dtype cast on append (f32-typed index fed u32 rows casts per-row)
    idxf = HnswIndex(sketch_size=s, sig_dtype=np.float32, max_nb_conn=8,
                     ef_construction=32, search_prefix=s)
    f = rng.random((30, s), dtype=np.float32)
    idxf._sigs = f[:10].copy()
    idxf._append_sigs(f[10:])
    assert idxf._sigs.dtype == np.float32
    np.testing.assert_array_equal(idxf._sigs, f)


def test_prefix_dev_cache_lifecycle(rng):
    """The upload-once device prefix is seeded by bulk build/add, consumed
    by the coarse searcher, and invalidated by incremental inserts (which
    change the matrix without updating the cached rows)."""
    s = 128
    sigs = _sig_cloud(rng, 600, s, n_clusters=12)
    idx = HnswIndex(sketch_size=s, sig_dtype=np.uint32, max_nb_conn=12,
                    ef_construction=48, search_prefix=s)
    idx.insert(sigs[:512], bulk=True)
    assert idx._prefix_dev is not None
    n, dev, fp = idx._prefix_dev
    assert n == 512 and dev.shape == (512, s)
    assert fp == idx._sigs_fp()
    np.testing.assert_array_equal(np.asarray(dev), sigs[:512])
    # incremental (beam) insert must drop the stale cache
    idx.insert(sigs[512:], bulk=False)
    assert idx._prefix_dev is None
    # bulk append re-seeds it at the grown size
    more = _sig_cloud(rng, 300, s, n_clusters=6)
    idx._bulk_add(more.astype(np.uint32))
    assert idx._prefix_dev is not None and idx._prefix_dev[0] == 900
    np.testing.assert_array_equal(
        np.asarray(idx._prefix_dev[1]),
        np.concatenate([sigs, more]).astype(np.uint32))
    # external reassignment of _sigs with the SAME row count: the content
    # fingerprint must reject the cached device rows (a further bulk_add
    # would otherwise link against stale signatures)
    tampered = idx._sigs.copy()
    tampered[0] ^= np.uint32(0xDEADBEEF)
    idx._sigs = tampered
    cached = idx._prefix_dev
    assert cached[0] == idx.nb_points and cached[2] != idx._sigs_fp()


@pytest.mark.smoke
def test_load_sigs_capacity_headroom(rng, tmp_path):
    """load_arrays reads sigs into a capacity buffer: the first append
    after a reload must NOT migrate (the 90 s 25 GB copy at 524k)."""
    from gsearch_tpu.index.hnsw import load_sigs_npy_with_headroom

    sigs = rng.random((100, 64), dtype=np.float32)
    path = tmp_path / "x.sigs.npy"
    np.save(path, sigs)
    buf, n = load_sigs_npy_with_headroom(str(path))
    assert n == 100 and buf.shape[0] > 100
    np.testing.assert_array_equal(buf[:100], sigs)

    idx = HnswIndex(sketch_size=64, sig_dtype=np.float32, max_nb_conn=4,
                    ef_construction=16)
    idx.adopt_sig_buffer(buf, n)
    base_ptr = buf.ctypes.data
    idx._append_sigs(rng.random((8, 64), dtype=np.float32))
    assert idx.nb_points == 108
    # still the adopted buffer: no migration copy happened
    assert idx._sigs_buf.ctypes.data == base_ptr


@pytest.mark.smoke
def test_npyio_member_roundtrip(rng, tmp_path):
    """npyio locates and maps npz members byte-exactly."""
    from gsearch_tpu.io.npyio import npy_memmap, npy_read_with_headroom

    a = rng.random((37, 11), dtype=np.float32)
    b = (rng.random(5) * 100).astype(np.int32)
    path = tmp_path / "pack.npz"
    np.savez(path, a=a, b=b)
    mm = npy_memmap(str(path), "a.npy")
    np.testing.assert_array_equal(np.asarray(mm), a)
    buf, n = npy_read_with_headroom(str(path), "a.npy")
    assert n == 37
    np.testing.assert_array_equal(buf[:37], a)


@pytest.mark.smoke
@pytest.mark.parametrize("version", [(1, 0), (2, 0)])
def test_npyio_header_versions(rng, tmp_path, version):
    """Both .npy header versions parse through numpy's public readers;
    other versions are refused with a clear error."""
    from gsearch_tpu.io.npyio import npy_payload, npy_read_with_headroom

    a = rng.random((9, 4), dtype=np.float32)
    path = tmp_path / "a.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(f, a, version=version)
    off, shape, dtype = npy_payload(str(path))
    assert shape == (9, 4) and dtype == np.float32 and off % 16 == 0
    buf, n = npy_read_with_headroom(str(path))
    np.testing.assert_array_equal(buf[:n], a)
    raw = bytearray(path.read_bytes())
    raw[6] = 9  # major version byte
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        npy_payload(str(path))


@pytest.mark.smoke
def test_collector_error_lands_on_its_ticket():
    """A failing batch raises from ITS ticket's sketch_finish; other
    tickets complete normally (per-ticket err routing)."""
    from gsearch_tpu.core.params import DataType, SeqSketcherParams, SketchAlgo
    from gsearch_tpu.models import make_sketcher

    rng = np.random.default_rng(0)
    sk = make_sketcher(SeqSketcherParams(
        kmer_size=12, sketch_size=128, algo=SketchAlgo.OPTDENS,
        data_t=DataType.DNA))
    good = [rng.integers(0, 4, 3000).astype(np.uint8) for _ in range(2)]
    t_ok = sk.sketch_submit(good)

    # inject a failing device array into a second ticket via the
    # collector queue (the same path a device error takes)
    class Boom:
        def __getitem__(self, i):
            raise RuntimeError("device exploded")

        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("device exploded")

    t_bad = sk.sketch_submit(good)  # healthy batches first
    sk._dispatch_to_collector(t_bad, [0], Boom())
    ok = sk.sketch_finish(t_ok)  # unaffected ticket completes
    assert ok.shape == (2, 128)
    with pytest.raises(RuntimeError, match="device exploded"):
        sk.sketch_finish(t_bad)
