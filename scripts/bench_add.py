"""Bulk `add` (incremental append) benchmark at reference scale.

Round-2 verdict item 4: the beam-insert `add` path measured ~4,800 s for
262k points; the bulk append path (_bulk_add: exact-kNN MXU sweep of the
new batch against prefix+batch, heuristic links, one reverse merge —
reference role dnasketch.rs:426-436) must take a 32k append into a 262k+
database in well under 90 s.

Reuses the cached signatures/graph of scripts/bench_hnsw.py when present
(HNSW_BENCH_SIG_CACHE / HNSW_BENCH_CACHE) so the 524k corpus doesn't
regenerate; fresh mutant points are appended and recall@10 of queries
targeting the ADDED points is checked against a streamed exact oracle.

Each stage runs in its OWN subprocess, so each stage's peak host memory
(the streamed oracle moves ~50 GB at this scale) is its own.

Usage: python scripts/bench_add.py [N_BASE] [N_ADD] [S]
Writes ADD_BENCH.json.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import subprocess
import time

import numpy as np

NQ, K = 256, 10


def log(msg):
    print(f"[add-bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def _caches():
    scache = os.environ.get("HNSW_BENCH_SIG_CACHE", "")
    gcache = os.environ.get("HNSW_BENCH_CACHE", "")
    if not (scache and os.path.exists(scache) and gcache
            and os.path.exists(gcache)):
        sys.exit("need HNSW_BENCH_SIG_CACHE + HNSW_BENCH_CACHE from a prior "
                 "scripts/bench_hnsw.py run (the base graph is reused, not "
                 "rebuilt)")
    return scache, gcache


def _gen_new_points(centers, n_add, s, n_base):
    """Seed-deterministic appended batches + queries (same rng sequence in
    every phase, so the phases agree without shipping 3 GB through disk
    twice)."""
    rng = np.random.default_rng(99)
    batches = []
    for _ in range(2):
        cc = rng.integers(0, centers.shape[0], n_add)
        new = centers[cc].astype(np.float32, copy=True)
        mask = rng.random((n_add, s)) < rng.uniform(0.02, 0.45,
                                                    size=(n_add, 1))
        new[mask] = rng.random(int(mask.sum())).astype(np.float32)
        batches.append(new)
    return rng, batches


def _make_index(s):
    from gsearch_tpu.index.hnsw import HnswIndex

    return HnswIndex(sketch_size=s, sig_dtype=np.float32, max_nb_conn=64,
                     ef_construction=256)


def _npz_member_into_capacity(path, name):
    """Read one uncompressed .npz member straight into a capacity buffer
    with append headroom (mirrors the production reload path)."""
    from gsearch_tpu.io.npyio import npy_read_with_headroom

    return npy_read_with_headroom(path, name)


def phase_add(n_base, n_add, s, rpath):
    """ADD1 (cold) + ADD2 (warm); dump the post-add graph rows + new sigs."""
    import jax

    scache, gcache = _caches()
    log(f"backend={jax.default_backend()} base={n_base} add={n_add} s={s}")
    # mirror the production reload path (load_sigs_npy_with_headroom):
    # read the cached sig matrix straight into a capacity buffer so ADD1
    # measures compiles+work, not a 25 GB capacity-migration memcpy the
    # real `add` no longer pays either
    buf, nrows = _npz_member_into_capacity(scache, "sigs.npy")
    assert (nrows, buf.shape[1]) == (n_base, s), (nrows, buf.shape)
    centers = np.load(scache)["centers"]
    idx = _make_index(s)
    gg = np.load(gcache)
    idx.adopt_sig_buffer(buf, nrows)
    idx._nbrs, idx._nbr_d, idx._entry_ids = gg["nbrs"], gg["nbr_d"], gg["entries"]
    del buf, gg  # stale aliases of 25 GB matrices OOM this host
    log(f"reused cached {n_base}-point graph")

    _, (new, new2) = _gen_new_points(centers, n_add, s, n_base)
    t0 = time.perf_counter()
    idx.insert(new)  # >= BULK_ADD_MIN: the bulk append path
    t_add = time.perf_counter() - t0
    assert idx.nb_points == n_base + n_add
    log(f"ADD: {t_add:.1f}s for {n_add} points into {n_base} "
        f"({n_add / t_add:.0f}/s, cold: includes compiles for the "
        f"crossed power-of-two row bucket)")

    # second append, same shapes: the programs are compiled now, so this
    # is the steady-state append pace a long-running `add` session (or a
    # process with a warm compile cache) actually sustains
    t0 = time.perf_counter()
    idx.insert(new2)
    t_add2 = time.perf_counter() - t0
    n_total = n_base + 2 * n_add
    assert idx.nb_points == n_total
    log(f"ADD2 (warm): {t_add2:.1f}s for {n_add} points into "
        f"{n_base + n_add} ({n_add / t_add2:.0f}/s)")

    np.savez(rpath, nbrs=idx._nbrs, nbr_d=idx._nbr_d,
             entries=idx._entry_ids, pinned=idx._pinned,
             t_add=np.float64(t_add), t_add2=np.float64(t_add2))
    log(f"wrote {rpath}")


def _reconstruct(n_base, n_add, s, rpath):
    """Rebuild the post-add index (sigs from the seeded generator + base
    cache, graph rows from the add phase's dump)."""
    scache, _ = _caches()
    g = np.load(scache)
    base, centers = g["sigs"], g["centers"]
    rng, (new, new2) = _gen_new_points(centers, n_add, s, n_base)
    n_total = n_base + 2 * n_add
    sigs = np.empty((n_total, s), np.float32)
    sigs[:n_base] = base
    del base, g
    sigs[n_base:n_base + n_add] = new
    sigs[n_base + n_add:] = new2
    idx = _make_index(s)
    rr = np.load(rpath)
    idx._sigs = sigs
    idx._nbrs, idx._nbr_d = rr["nbrs"], rr["nbr_d"]
    idx._entry_ids, idx._pinned = rr["entries"], rr["pinned"]
    assert idx.nb_points == n_total

    # queries: mutants of ADDED points (the add must make them findable)
    qsrc = rng.integers(n_base, n_total, NQ)
    queries = sigs[qsrc].astype(np.float32, copy=True)
    qmask = rng.random((NQ, s)) < rng.uniform(0.02, 0.2, size=(NQ, 1))
    queries[qmask] = rng.random(int(qmask.sum())).astype(np.float32)
    return idx, queries, float(rr["t_add"]), float(rr["t_add2"])


def phase_oracle(n_base, n_add, s, rpath, ocache):
    """Streamed exact top-K over all rows (full signatures) — 50 GB of
    uploads at this scale, so it gets a process of its own."""
    import functools
    import gc

    import jax
    import jax.numpy as jnp

    from gsearch_tpu.index.hnsw import _next_pow2, _round_up
    from gsearch_tpu.ops.distance import hamming_frac_xla

    idx, queries, _, _ = _reconstruct(n_base, n_add, s, rpath)
    n_total = idx.nb_points
    sp = _round_up(s, 1024)
    q_pad = np.ones((NQ, sp), np.uint32)
    q_pad[:, :s] = queries.view(np.uint32)
    q_dev = jnp.asarray(q_pad)
    chunk = 16384

    @functools.partial(jax.jit, static_argnames=("k",))
    def stream_chunk(db_rows, q, start, n_live, *, k):
        d = hamming_frac_xla(q, db_rows)
        d = (d * jnp.float32(sp) - jnp.float32(sp - s)) / jnp.float32(s)
        col = start + jnp.arange(db_rows.shape[0], dtype=jnp.int32)
        d = jnp.where((col < n_live)[None, :], d, jnp.inf)
        neg, ii = jax.lax.top_k(-d, k)
        return -neg, start + ii

    sigs_u = idx._sigs.view(np.uint32)
    best_d = np.full((NQ, K), np.inf, np.float32)
    best_i = np.zeros((NQ, K), np.int32)
    nrows = _next_pow2(n_total)
    rows = np.zeros((chunk, sp), np.uint32)  # reused staging buffer
    t0 = time.perf_counter()
    for st in range(0, nrows, chunk):
        live = max(min(n_total - st, chunk), 0)
        rows[:] = 0
        if live:
            rows[:live, :s] = sigs_u[st : st + live]
        d_rows = jnp.asarray(rows)
        dd, ii = stream_chunk(d_rows, q_dev, jnp.int32(st),
                              jnp.int32(n_total), k=K)
        cd = np.concatenate([best_d, np.asarray(dd)], axis=1)
        ci = np.concatenate([best_i, np.asarray(ii)], axis=1)
        del d_rows, dd, ii
        sel = np.argsort(cd, axis=1, kind="stable")[:, :K]
        best_d = np.take_along_axis(cd, sel, axis=1)
        best_i = np.take_along_axis(ci, sel, axis=1)
        if (st // chunk) % 8 == 7:
            gc.collect()
    log(f"oracle done in {time.perf_counter() - t0:.0f}s")
    np.savez(ocache, best_d=best_d, best_i=best_i)


def phase_search(n_base, n_add, s, rpath, ocache, out_path):
    idx, queries, t_add, t_add2 = _reconstruct(n_base, n_add, s, rpath)
    oc = np.load(ocache)
    best_d, best_i = oc["best_d"], oc["best_i"]

    t0 = time.perf_counter()
    dd, ids = idx.search(queries, knbn=K, ef_search=64)
    t_first = time.perf_counter() - t0
    rec = float(np.mean([len(set(best_i[i]) & set(ids[i])) / K
                         for i in range(NQ)]))
    ta = float(np.mean([
        1.0 - sum(1 for a, b in zip(sorted(dd[i]), sorted(best_d[i]))
                  if a > b + 1e-6) / K for i in range(NQ)]))
    log(f"recall@10 {rec:.4f} tie-aware {ta:.4f} (first search {t_first:.1f}s)")

    out = {
        "n_base": n_base, "n_add": n_add, "s": s,
        "add_cold_s": round(t_add, 1),
        "points_per_s_cold": round(n_add / t_add, 1),
        "add_warm_s": round(t_add2, 1),
        "points_per_s_warm": round(n_add / t_add2, 1),
        "recall10_added_queries": round(rec, 4), "tie_aware": round(ta, 4),
        "beam_insert_reference_s": "4802 at 262k (round 2 PERF.md)",
        "note": ("cold includes every XLA compile for the crossed "
                 "power-of-two row bucket (one-off per bucket with a "
                 "persistent compile cache); warm is the steady append "
                 "pace"),
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {out_path}")
    print(json.dumps(out))


def main():
    # persistent executable cache: a fresh process replays prior compiles
    # from disk instead of re-paying them
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from gsearch_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    n_base = int(sys.argv[1]) if len(sys.argv) > 1 else 524_288
    n_add = int(sys.argv[2]) if len(sys.argv) > 2 else 32_768
    s = int(sys.argv[3]) if len(sys.argv) > 3 else 12_000
    phase = os.environ.get("ADD_BENCH_PHASE", "")
    # key the stage dumps on the sig cache's identity (mtime+size), so a
    # regenerated corpus or base graph can never silently mix with stale
    # stage results from a previous run
    scache, gcache = _caches()
    tag = (f"{int(os.path.getmtime(scache))}_{os.path.getsize(scache)}_"
           f"{int(os.path.getmtime(gcache))}")
    rpath = f"/tmp/add_result_{n_base}_{n_add}_{s}_{tag}.npz"
    ocache = f"/tmp/add_oracle_{n_base}_{n_add}_{s}_{NQ}_{tag}.npz"
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_path = os.path.join(here, "ADD_BENCH.json")

    if phase == "add":
        phase_add(n_base, n_add, s, rpath)
    elif phase == "oracle":
        phase_oracle(n_base, n_add, s, rpath, ocache)
    elif phase == "search":
        phase_search(n_base, n_add, s, rpath, ocache, out_path)
    else:
        # driver: one subprocess per stage (peak-RSS isolation)
        stages = []
        if not os.path.exists(rpath):
            stages.append("add")
        if not os.path.exists(ocache):
            stages.append("oracle")
        stages.append("search")
        for st in stages:
            log(f"--- stage {st} ---")
            env = dict(os.environ, ADD_BENCH_PHASE=st)
            p = subprocess.run([sys.executable, os.path.abspath(__file__)]
                               + sys.argv[1:], env=env)
            if p.returncode != 0:
                sys.exit(f"stage {st} failed ({p.returncode})")


if __name__ == "__main__":
    main()
