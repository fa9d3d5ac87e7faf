"""Multi-chip sharding on the 8-device virtual CPU mesh (see conftest)."""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gsearch_tpu.parallel.mesh import (
    make_device_mesh,
    shard_database,
    sharded_knn,
    sharded_sketch_and_knn_step,
)


@pytest.mark.smoke
def test_eight_devices():
    assert len(jax.devices()) == 8


def test_sharded_knn_matches_single(rng):
    n, s, q, k = 1024, 128, 16, 10
    db = rng.integers(0, 64, size=(n, s)).astype(np.uint32)
    queries = db[rng.choice(n, q, replace=False)]

    mesh = make_device_mesh(8)
    search = sharded_knn(mesh, s_total=s, knbn=k)
    db_sharded = shard_database(db, mesh)
    d, ids = search(db_sharded, jnp.asarray(queries), jnp.int32(n))
    d, ids = np.asarray(d), np.asarray(ids)

    # oracle: single-device exact
    from gsearch_tpu.ops.distance import brute_force_knn

    d0, ids0 = brute_force_knn(jnp.asarray(queries), jnp.asarray(db), k)
    np.testing.assert_allclose(d, np.asarray(d0), atol=1e-6)
    # ids may differ among equal distances; distances must match exactly
    assert (d[:, 0] == 0).all()


def test_sharded_knn_2d_mesh(rng):
    """2-D mesh: rows shard over 'd', sketch slots over 's'."""
    n, s, q, k = 512, 64, 8, 5
    db = rng.integers(0, 64, size=(n, s)).astype(np.uint32)
    queries = db[:q].copy()
    mesh = make_device_mesh(8, two_d=True)
    assert mesh.axis_names == ("d", "s")
    search = sharded_knn(mesh, s_total=s, knbn=k)
    db_sharded = shard_database(db, mesh)
    d, ids = search(db_sharded, jnp.asarray(queries), jnp.int32(n))
    d, ids = np.asarray(d), np.asarray(ids)
    assert (ids[:, 0] == np.arange(q)).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-6)


def test_sharded_sketch_and_knn_step(rng):
    """The full dp-sketch + sharded-search training step, 8 virtual chips."""
    from gsearch_tpu.core.params import DataType, SeqSketcherParams, SketchAlgo
    from gsearch_tpu.models import make_sketcher

    s = 256
    params = SeqSketcherParams(kmer_size=12, sketch_size=s, algo=SketchAlgo.OPTDENS,
                               data_t=DataType.DNA)
    sk = make_sketcher(params)

    mesh = make_device_mesh(8)
    block_len = 4096
    batch = 16  # 2 genomes per chip
    codes = rng.integers(0, 4, size=(batch, block_len)).astype(np.uint8)

    n = 256
    db = rng.integers(0, 1 << 30, size=(n, s)).astype(np.uint32)
    # make db rows 0..batch-1 equal to the batch's own signatures
    sigs_expected = sk.sketch_many(list(codes))
    db[:batch] = sigs_expected.view(np.uint32)

    step = sharded_sketch_and_knn_step(mesh, sk, block_len, knbn=3)
    from jax.sharding import NamedSharding, PartitionSpec as P

    codes_sharded = jax.device_put(codes, NamedSharding(mesh, P("d", None)))
    db_sharded = jax.device_put(db, NamedSharding(mesh, P("d", None)))
    sigs, d, ids = step(codes_sharded, db_sharded)
    sigs, d, ids = np.asarray(sigs), np.asarray(d), np.asarray(ids)

    # dp-sharded sketching == host-loop sketching
    np.testing.assert_array_equal(sigs.view(np.uint32), sigs_expected.view(np.uint32))
    # each fresh signature's nearest db row is its own planted copy
    assert (ids[:, 0] == np.arange(batch)).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-6)


@pytest.mark.smoke
def test_mesh_pipeline_e2e(rng, tmp_path):
    """tohnsw --mesh 8 -> request --mesh 8 through the real pipeline:
    dp-sharded sketching at build, MeshSearcher at request."""
    from gsearch_tpu.core import ComputingParams, HnswParams, ProcessingParams
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu.pipeline import build_database, request_database

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    gdir, qdir, dbdir, odir = (tmp_path / x for x in ("g", "q", "db", "out"))
    gdir.mkdir(), qdir.mkdir()
    genomes = [bytes(rng.choice(acgt, 4000)) for _ in range(20)]
    for i, g in enumerate(genomes):
        (gdir / f"g{i}.fna").write_bytes(b">c\n" + g + b"\n")
    mut = np.frombuffer(genomes[3], np.uint8).copy()
    pos = rng.choice(len(mut), 40, replace=False)
    mut[pos] = rng.choice(acgt, 40)
    (qdir / "q.fna").write_bytes(b">q\n" + mut.tobytes() + b"\n")

    pp = ProcessingParams(
        hnsw=HnswParams(capacity=1000, ef=64, max_nb_conn=8, scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=14, sketch_size=256, algo="OPTDENS",
                                 data_t="DNA"),
        block_flag=True,
    )
    comp = ComputingParams(mesh_devices=-1)  # all 8 virtual devices
    build_database(str(gdir), str(dbdir), pp, comp)
    res = request_database(str(dbdir), str(qdir), nb_answers=5, computing=comp,
                           out_dir=str(odir))
    assert res["nb_requests"] == 1
    body = (odir / "gsearch.neighbors.txt").read_text()
    assert "g3.fna" in body

    # mesh build must produce the same database as the single-device build
    dbdir2 = tmp_path / "db2"
    build_database(str(gdir), str(dbdir2), pp, ComputingParams())
    a = np.load(dbdir / "index.sigs.npy")
    b = np.load(dbdir2 / "index.sigs.npy")
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_mesh_searcher_matches_flat(rng):
    """MeshSearcher over a signature matrix == single-device exact search,
    including non-divisible N (pad-row masking)."""
    from gsearch_tpu.index.flat import FlatIndex
    from gsearch_tpu.parallel.mesh import MeshSearcher

    n, s, k = 1001, 96, 7  # 1001 % 8 != 0 on purpose
    sigs = rng.integers(0, 1 << 24, size=(n, s)).astype(np.float32)
    queries = sigs[rng.choice(n, 9, replace=False)].copy()

    flat = FlatIndex(sketch_size=s, sig_dtype=np.float32)
    flat.insert(sigs)
    d0, _ = flat.search(queries, knbn=k)

    ms = MeshSearcher(sigs, n_devices=8)
    d, ids = ms.search(queries, knbn=k)
    np.testing.assert_allclose(d, d0, atol=1e-6)
    assert (d[:, 0] == 0).all() and ids.max() < n


def _clustered(rng, n, s, per=32):
    centers = rng.integers(0, 1 << 24, size=(n // per, s)).astype(np.float32)
    sigs = np.repeat(centers, per, axis=0)
    mask = rng.random(sigs.shape) < rng.uniform(0.02, 0.3, size=(n, 1))
    sigs[mask] = rng.random(int(mask.sum())).astype(np.float32)
    return sigs


def test_sharded_hnsw_sequential_and_roundtrip(rng, tmp_path):
    """ShardedHnswIndex: round-robin global ids, host-merged search, and
    save/load round trip."""
    from gsearch_tpu.index.sharded import ShardedHnswIndex

    n, s, k = 1024, 256, 5
    sigs = _clustered(rng, n, s)
    idx = ShardedHnswIndex(sketch_size=s, sig_dtype=np.float32, n_shards=8,
                           max_nb_conn=8, ef_construction=64)
    idx.insert(sigs[:512])
    idx.insert(sigs[512:])  # incremental add keeps shards balanced
    assert idx.nb_points == n
    assert max(sh.nb_points for sh in idx.shards) - min(
        sh.nb_points for sh in idx.shards) <= 1
    # get_sigs reassembles global order
    np.testing.assert_array_equal(
        idx.get_sigs().view(np.uint32), sigs.view(np.uint32))

    q = sigs[rng.choice(n, 16, replace=False)].copy()
    d, ids = idx.search(q, knbn=k, ef_search=128)
    assert (d[:, 0] == 0).all()
    got = sigs[ids[:, 0]]
    np.testing.assert_array_equal(got.view(np.uint32), q.view(np.uint32))

    from gsearch_tpu.index.serialize import dumpall, load_index
    from gsearch_tpu.core import ProcessingParams, HnswParams, SeqDict
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu.core.seqdict import Id, ItemDict

    sd = SeqDict()
    for i in range(n):
        sd.push(ItemDict(id=Id(path=f"g{i}", fasta_id="c"), len=1000))
    pp = ProcessingParams(
        hnsw=HnswParams(capacity=n, ef=64, max_nb_conn=8, scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=14, sketch_size=s, algo="OPTDENS",
                                 data_t="DNA"),
        block_flag=True)
    dbdir = str(tmp_path / "db")
    dumpall(dbdir, idx, sd, pp)
    idx2 = load_index(dbdir)
    assert idx2.KIND == "hnsw_sharded" and idx2.nb_points == n
    d2, ids2 = idx2.search(q, knbn=k, ef_search=128)
    np.testing.assert_array_equal(ids2[:, 0], ids[:, 0])


def test_mesh_graph_searcher_recall(rng):
    """MeshGraphSearcher: one shard_map dispatch over 8 subgraphs matches
    the exact oracle on clustered data."""
    from gsearch_tpu.index.sharded import ShardedHnswIndex
    from gsearch_tpu.parallel.mesh import MeshGraphSearcher
    from gsearch_tpu.ops.distance import brute_force_knn

    n, s, k, nq = 2048, 256, 10, 16
    sigs = _clustered(rng, n, s)
    idx = ShardedHnswIndex(sketch_size=s, sig_dtype=np.float32, n_shards=8,
                           max_nb_conn=8, ef_construction=64)
    idx.insert(sigs)
    q = sigs[rng.choice(n, nq, replace=False)].copy()

    ms = MeshGraphSearcher(idx, n_devices=8)
    d, ids = ms.search(q, knbn=k, ef_search=256)
    assert d.shape == (nq, k) and ids.max() < n and ids.min() >= 0

    d0, ids0 = brute_force_knn(jnp.asarray(q.view(np.uint32)),
                               jnp.asarray(sigs.view(np.uint32)), k)
    d0 = np.asarray(d0)
    # tie-aware recall: count returned neighbors at least as close as the
    # oracle's k-th
    rec = np.mean([(d[i] <= d0[i, -1] + 1e-6).mean() for i in range(nq)])
    assert (d[:, 0] == 0).all()
    assert rec >= 0.95, rec


def test_mesh_pipeline_sharded_hnsw_e2e(rng, tmp_path):
    """tohnsw --index hnsw --mesh -> request --mesh builds a sharded graph
    database and searches it with the mesh graph path."""
    from gsearch_tpu.core import ComputingParams, HnswParams, ProcessingParams
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu.index.serialize import get_index_kind
    from gsearch_tpu.pipeline import build_database, request_database

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    gdir, qdir, dbdir, odir = (tmp_path / x for x in ("g", "q", "db", "out"))
    gdir.mkdir(), qdir.mkdir()
    genomes = [bytes(rng.choice(acgt, 4000)) for _ in range(24)]
    for i, g in enumerate(genomes):
        (gdir / f"g{i}.fna").write_bytes(b">c\n" + g + b"\n")
    mut = np.frombuffer(genomes[5], np.uint8).copy()
    pos = rng.choice(len(mut), 40, replace=False)
    mut[pos] = rng.choice(acgt, 40)
    (qdir / "q.fna").write_bytes(b">q\n" + mut.tobytes() + b"\n")

    pp = ProcessingParams(
        hnsw=HnswParams(capacity=1000, ef=64, max_nb_conn=8, scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=14, sketch_size=256, algo="OPTDENS",
                                 data_t="DNA"),
        block_flag=True,
    )
    comp = ComputingParams(mesh_devices=-1)
    build_database(str(gdir), str(dbdir), pp, comp, index_kind="hnsw")
    assert get_index_kind(str(dbdir))["kind"] == "hnsw_sharded"
    res = request_database(str(dbdir), str(qdir), nb_answers=5, computing=comp,
                           out_dir=str(odir))
    assert res["nb_requests"] == 1
    assert "g5.fna" in (odir / "gsearch.neighbors.txt").read_text()


def test_mesh_mxu_searcher_matches_exact(rng):
    """MeshMxuSearcher (sharded compact-MXU scoring + local rerank + ICI
    merge) returns the exact searcher's neighbors, including non-divisible
    N; distances agree within the 16-bit hash-collision bias (~2/S)."""
    from gsearch_tpu.parallel.mesh import MeshMxuSearcher, MeshSearcher

    n, s, k = 1100, 256, 7  # forces pad rows on the last shard
    # clusters with distinct member distances -> unambiguous top-k
    centers = rng.integers(0, 1 << 20, size=(11, s)).astype(np.uint32)
    sigs = np.empty((n, s), np.uint32)
    for i in range(n):
        c = centers[i % 11].copy()
        n_pert = 5 + 2 * (i // 11)
        pos = rng.choice(s, min(n_pert, s), replace=False)
        c[pos] = rng.integers(1 << 20, 1 << 21, size=len(pos), dtype=np.uint32)
        sigs[i] = c
    queries = centers.copy()

    exact = MeshSearcher(sigs, n_devices=8)
    d0, ids0 = exact.search(queries, knbn=k)
    mx = MeshMxuSearcher(sigs, n_devices=8)
    d, ids = mx.search(queries, knbn=k)
    assert ids.max() < n
    recall = np.mean([len(set(ids[i]) & set(ids0[i])) / k
                      for i in range(len(queries))])
    assert recall >= 0.95, f"sharded-mxu recall {recall}"
    np.testing.assert_allclose(d[:, 0], d0[:, 0], atol=3.0 / s)


def test_initialize_multihost_two_process(tmp_path):
    """Simulated two-host bring-up: two OS processes, 4 virtual CPU
    devices each, joined by jax.distributed (Gloo collectives).  Each
    process must see the 8-device global view and agree on a global
    reduction — the multi-host path of parallel/mesh.py:initialize_multihost."""
    import subprocess
    import sys as _sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "mh_worker.py"
    worker.write_text(textwrap.dedent("""
        import os, sys
        pid = int(sys.argv[1])
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        sys.path.insert(0, sys.argv[2])
        import jax
        # force the local CPU backend BEFORE the distributed client
        # instantiates one
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 4)
        import jax.extend.backend
        jax.extend.backend.clear_backends()
        from gsearch_tpu.parallel.mesh import initialize_multihost
        import jax.numpy as jnp
        import numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        idx = initialize_multihost("127.0.0.1:" + sys.argv[3], 2, pid)
        mesh = Mesh(np.array(jax.devices()), ("d",))
        x = jax.device_put(np.arange(8, dtype=np.float32),
                           NamedSharding(mesh, P("d")))
        tot = jax.jit(jnp.sum)(x)
        print(f"RESULT {idx} {float(tot)} {len(jax.devices())}", flush=True)
    """))
    import socket

    with socket.socket() as s:  # a port the coordinator can bind
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
                 [_sys.executable, str(worker), str(i), repo, str(port)],
                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                 env=env, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=360)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("jax.distributed CPU collectives unavailable (timeout)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, out in enumerate(outs):
        lines = [l for l in out.splitlines() if l.startswith("RESULT")]
        assert lines, f"proc {i} produced no result:\n{out[-2000:]}"
        _, idx, tot, ndev = lines[0].split()
        assert float(tot) == 28.0
        assert int(ndev) == 8


def test_mesh_sketch_long_genomes_match_single(rng):
    """Mesh-mode sketching of genomes LARGER than one block (the
    per-genome streaming fallback under a mesh) must equal the
    single-device result bit-for-bit."""
    from gsearch_tpu.core.params import (DataType, SeqSketcherParams,
                                         SketchAlgo)
    from gsearch_tpu.models import make_sketcher
    from gsearch_tpu.parallel.mesh import make_device_mesh

    p = SeqSketcherParams(kmer_size=14, sketch_size=128,
                          algo=SketchAlgo.OPTDENS, data_t=DataType.DNA)
    genomes = [rng.integers(0, 4, n).astype(np.uint8)
               for n in (40_000, 70_001, 5_000, 33_000)]

    single = make_sketcher(p)
    single.MAX_BLOCK_LOG2 = 14  # force >1-block streaming on most rows
    want = single.sketch_many(genomes)

    meshed = make_sketcher(p)
    meshed.MAX_BLOCK_LOG2 = 14
    meshed.set_mesh(make_device_mesh(8))
    got = meshed.sketch_many(genomes)
    np.testing.assert_array_equal(want, got)
