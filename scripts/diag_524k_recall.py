"""Which stage caps 524k graph-path recall: coarse prefix pool or packed rerank?

Loads the cached 524k corpus + graph + oracle (same env vars as
scripts/bench_hnsw.py), then for several candidate widths r measures:

  * pool_recall:  |prefix-metric top-r  ∩  oracle top-10| / 10 — the ceiling
    any rerank of that pool can reach
  * exact_rerank_recall: host exact rerank of the pool (what a perfect
    rerank tier would return)
  * packed_recall: the production path (device packed-16-bit rerank)

Writes DIAG524K.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(m):
    print(f"[diag {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def main():
    from gsearch_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from gsearch_tpu.index.hnsw import HnswIndex, _as_u32, _next_pow2

    scache = os.environ["HNSW_BENCH_SIG_CACHE"]
    gcache = os.environ["HNSW_BENCH_CACHE"]
    g = np.load(scache)
    sigs, centers = g["sigs"], g["centers"]
    n, s = sigs.shape
    gg = np.load(gcache)
    idx = HnswIndex(sketch_size=s, sig_dtype=np.float32, max_nb_conn=64,
                    ef_construction=256)
    idx._sigs = sigs
    idx._nbrs, idx._nbr_d, idx._entry_ids = gg["nbrs"], gg["nbr_d"], gg["entries"]
    log(f"graph loaded n={n} s={s}")

    og = np.load(gcache + ".oracle.npz")
    oracle_ids, oracle_d = og["ids"], og["d"]
    nq, k = oracle_ids.shape

    # EXACT query generation of bench_hnsw on a signature-cache hit: rng
    # seed 0 with no draws consumed before the query block (the cached
    # oracle was computed for THESE queries; any deviation reads recall 0)
    rng = np.random.default_rng(0)
    qc = rng.integers(0, centers.shape[0], nq)
    queries = centers[qc].copy()
    qmask = rng.random((nq, s)) < rng.uniform(0.05, 0.35, size=(nq, 1))
    queries[qmask] = rng.random(int(qmask.sum())).astype(np.float32)

    qb = _next_pow2(nq, floor=8)
    qbuf = np.full((qb, s), 0xFFFFFFFF, np.uint32)
    qbuf[:nq] = _as_u32(queries)
    q_dev = jnp.asarray(qbuf)
    sigs_u = _as_u32(sigs)
    qs_u = _as_u32(queries)

    def host_exact(ids_pool):
        """exact top-k from a candidate pool, + pool/exact recalls"""
        pool_rec, ex_rec = [], []
        top_ids = np.zeros((nq, k), np.int64)
        for i in range(nq):
            ids_i = ids_pool[i][ids_pool[i] < n]
            eq = (sigs_u[ids_i] == qs_u[i][None, :]).sum(-1)
            d = 1.0 - eq / np.float32(s)
            o = np.argsort(d, kind="stable")[:k]
            top_ids[i] = ids_i[o]
            oset = set(oracle_ids[i].tolist())
            pool_rec.append(len(oset & set(ids_i.tolist())) / k)
            ex_rec.append(len(oset & set(top_ids[i].tolist())) / k)
        return float(np.mean(pool_rec)), float(np.mean(ex_rec))

    # guard: the cached oracle must describe THESE queries — check that
    # the top-1 oracle distance matches a host recomputation
    eq0 = (sigs_u[oracle_ids[0, 0]] == qs_u[0]).sum()
    d0 = 1.0 - eq0 / np.float32(s)
    assert abs(float(d0) - float(oracle_d[0, 0])) < 1e-5, \
        f"oracle mismatch: host {d0} vs cached {oracle_d[0, 0]} — query gen drifted"
    log(f"oracle consistency ok (top-1 d={d0:.4f})")

    out = {"n": n, "s": s, "rows": []}
    for r in (160, 1024):
        os.environ["GSEARCH_TPU_RERANK_R"] = str(r)
        t0 = time.perf_counter()
        dp, ids = idx.search_device(q_dev, k, 256, rerank=False)
        ids_pool = np.asarray(ids)[:nq]
        t_pool = time.perf_counter() - t0
        pool_rec, ex_rec = host_exact(ids_pool)
        # production packed path (r > 512 would blow the gather kernel's
        # VMEM rowbuf at this S — the production default is r=160)
        packed_rec = None
        if r <= 512:
            d2, ids2 = idx.search_device(q_dev, k, 256, rerank=True)
            ids2 = np.asarray(ids2)[:nq]
            packed_rec = round(float(np.mean([
                len(set(oracle_ids[i].tolist()) & set(ids2[i].tolist())) / k
                for i in range(nq)])), 4)
        row = {"r": r, "pool_recall": round(pool_rec, 4),
               "exact_rerank_recall": round(ex_rec, 4),
               "packed_recall": packed_rec,
               "pool_s": round(t_pool, 1)}
        out["rows"].append(row)
        log(str(row))
    os.environ.pop("GSEARCH_TPU_RERANK_R", None)

    with open("DIAG524K.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
