"""HNSW graph index at reference scale on one GPU.

Builds an HnswIndex over N clustered synthetic signatures (mutation-ladder
structure: members share most sketch slots with their cluster center — the
shape real genome sketches have, unlike uniform-random), then measures:

  * build wall-clock (the reference builds 318k-genome RefSeq in 2-3 h on a
    24-thread CPU, /root/reference/README.md:134)
  * exact-oracle top-10 (device brute force over the full signatures)
  * qps + recall@10 for a sweep of ef_search values
  * exact (flat-path) qps at the same N for the crossover comparison

Usage: python scripts/bench_hnsw.py [N] [S] [M] [EFC] [EF,EF,...] [MULT,...]
(MULTs scale the entry tier for the search sweep.)  Writes results to
HNSW_BENCH.json and prints progress to stderr.  HNSW_BENCH_CACHE=<file>
caches the built graph and the exact oracle across runs.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools
import json
import os
import sys
import time

import numpy as np


def log(msg):
    print(f"[hnsw-bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _mutate(rng, base, lo, hi):
    out = np.array(base)
    fr = rng.uniform(lo, hi, size=(out.shape[0], 1))
    mask = rng.random(out.shape) < fr
    out[mask] = rng.random(int(mask.sum())).astype(np.float32)
    return out


def make_clustered(rng, n, s, n_centers, lo=0.02, hi=0.45):
    """Hierarchical mutation-ladder corpus: super-centers -> centers ->
    members, mirroring genome taxonomy (family -> species -> strain).
    Mutually-equidistant flat clusters would make cluster DISCOVERY a
    needle search with no geometric gradient — unnavigable for any graph
    index (incl. the reference's); real sketch databases have taxonomic
    structure, which is what graph navigation exploits."""
    n_super = max(n_centers // 32, 4)
    supers = (rng.integers(0, 1 << 24, size=(n_super, s)).astype(np.float32)
              * np.float32(1.0 / (1 << 24)))
    centers = _mutate(rng, supers[np.arange(n_centers) % n_super], 0.3, 0.6)
    sigs = np.empty((n, s), dtype=np.float32)
    per = n // n_centers
    for c in range(n_centers):
        block = np.repeat(centers[c][None, :], per, axis=0)
        sigs[c * per:(c + 1) * per] = _mutate(rng, block, lo, hi)
        if c % 256 == 0:
            log(f"gen centers {c}/{n_centers}")
    rest = n - per * n_centers
    if rest:
        sigs[per * n_centers:] = (rng.integers(0, 1 << 24, size=(rest, s))
                                  .astype(np.float32) / np.float32(1 << 24))
    return sigs, centers


def make_clustered_device(n, s, n_centers, lo=0.02, hi=0.45, seed=0):
    """Same hierarchical corpus generated ON DEVICE: the host generator
    needs ~800M RNG draws (12+ min for 65k x 12000 on this 1-core host,
    ~50 min at 262k); device gen is seconds plus the chunk downloads."""
    import jax
    import jax.numpy as jnp

    n_super = max(n_centers // 32, 4)
    per = n // n_centers
    key = jax.random.PRNGKey(seed)
    k_sup, k_cfr, k_cm, k_cv, k_mem = jax.random.split(key, 5)

    supers = jax.random.uniform(k_sup, (n_super, s), jnp.float32)
    cfr = jax.random.uniform(k_cfr, (n_centers, 1), jnp.float32,
                             minval=0.3, maxval=0.6)
    cmask = jax.random.uniform(k_cm, (n_centers, s)) < cfr
    cvals = jax.random.uniform(k_cv, (n_centers, s), jnp.float32)
    centers = jnp.where(cmask, cvals,
                        supers[jnp.arange(n_centers) % n_super])
    centers_h = np.asarray(centers)

    @functools.partial(jax.jit, static_argnames=("rows",))
    def member_chunk(centers, key, c0, *, rows):
        # centers is an ARGUMENT, not a closure capture: captured device
        # arrays embed as HLO constants (8192 x 12000 f32 = 393 MB of
        # program at 1M-point scale)
        kf, km, kv = jax.random.split(key, 3)
        nc = rows // per
        base = jax.lax.dynamic_slice_in_dim(centers, c0, nc, axis=0)
        base = jnp.repeat(base, per, axis=0)  # [rows, s]
        fr = jax.random.uniform(kf, (rows, 1), jnp.float32, minval=lo, maxval=hi)
        mask = jax.random.uniform(km, (rows, s)) < fr
        vals = jax.random.uniform(kv, (rows, s), jnp.float32)
        return jnp.where(mask, vals, base)

    sigs = np.empty((n, s), dtype=np.float32)
    # chunk = a whole number of clusters, sized ~0.5 GB of output
    cpc = max(1, (1 << 27) // max(per * s, 1))
    keys = jax.random.split(k_mem, (n_centers + cpc - 1) // cpc + 1)
    c = 0
    while c < n_centers:
        nc = min(cpc, n_centers - c)
        rows = nc * per
        # fixed `rows` per bucket keeps one compiled program; the tail
        # cluster block just recompiles once
        chunk = member_chunk(centers, keys[c // cpc], c, rows=rows)
        sigs[c * per:(c + nc) * per] = np.asarray(chunk)
        c += nc
        if (c // cpc) % 8 == 0:
            log(f"gen centers {c}/{n_centers}")
    rest = n - per * n_centers
    if rest:
        tail = jax.random.uniform(keys[-1], (rest, s), jnp.float32)
        sigs[per * n_centers:] = np.asarray(tail)
    return sigs, centers_h


def _npz_memmap(path, name):
    """Memory-map one member of an uncompressed .npz without extracting
    it: the 50 GB 1M x 12000 sig cache then costs ~zero anon RSS (the
    first 1M run OOMed this 125 GB host: np.load's full copy + the
    index's internal append copy)."""
    from gsearch_tpu.io.npyio import npy_memmap

    return npy_memmap(path, name)


def _rss_gb():
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1e6
    return 0.0


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 262_144
    s = int(sys.argv[2]) if len(sys.argv) > 2 else 12_000
    m = int(sys.argv[3]) if len(sys.argv) > 3 else 64
    efc = int(sys.argv[4]) if len(sys.argv) > 4 else 256
    efs = ([int(x) for x in sys.argv[5].split(",")]
           if len(sys.argv) > 5 else [64, 256, 1024])
    mults = ([float(x) for x in sys.argv[6].split(",")]
             if len(sys.argv) > 6 else [1.0])
    nq, k = int(os.environ.get("HNSW_BENCH_NQ", "256")), 10

    from gsearch_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from gsearch_tpu.index.hnsw import HnswIndex
    from gsearch_tpu.ops.distance import hamming_frac

    log(f"backend={jax.default_backend()} N={n} S={s} m={m} efc={efc} efs={efs}")
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    scache = os.environ.get("HNSW_BENCH_SIG_CACHE", "")
    if scache and os.path.exists(scache):
        if os.environ.get("HNSW_BENCH_SIG_MMAP"):
            sigs = _npz_memmap(scache, "sigs.npy")
            centers = np.load(scache)["centers"]
            log(f"memmapped cached signatures from {scache}")
        else:
            g = np.load(scache)
            sigs, centers = g["sigs"], g["centers"]
            log(f"reused cached signatures from {scache}")
    elif os.environ.get("HNSW_BENCH_HOST_GEN"):
        sigs, centers = make_clustered(rng, n, s, n_centers=max(n // 128, 8))
    else:
        sigs, centers = make_clustered_device(n, s, n_centers=max(n // 128, 8))
    if scache and not os.path.exists(scache):
        np.savez(scache, sigs=sigs, centers=centers)
        log(f"cached signatures to {scache}")
    # queries: fresh mutants of random centers (same generative process)
    qc = rng.integers(0, centers.shape[0], nq)
    queries = centers[qc].copy()
    qmask = rng.random((nq, s)) < rng.uniform(0.05, 0.35, size=(nq, 1))
    queries[qmask] = rng.random(int(qmask.sum())).astype(np.float32)
    log(f"data generated in {time.perf_counter() - t0:.1f}s")

    cache = os.environ.get("HNSW_BENCH_CACHE", "")
    idx = HnswIndex(sketch_size=s, sig_dtype=np.float32, max_nb_conn=m,
                    ef_construction=efc)
    if cache and os.path.exists(cache):
        g = np.load(cache)
        idx._sigs = sigs
        idx._nbrs, idx._nbr_d, idx._entry_ids = g["nbrs"], g["nbr_d"], g["entries"]
        t_build = float(g["build_s"])
        log(f"reused cached graph from {cache} (build was {t_build:.1f}s)")
    else:
        t0 = time.perf_counter()
        marks = []  # (rows_done, t) after each applied batch

        def prog(done, total):
            marks.append((done, time.perf_counter() - t0))
            if len(marks) % 16 == 0:
                log(f"insert {done}/{total} ({done / marks[-1][1]:.0f}/s)")

        # default: the bulk MXU-sweep constructor (auto at this N); set
        # HNSW_BENCH_INCREMENTAL=1 to force the beam-insert path
        bulk = not os.environ.get("HNSW_BENCH_INCREMENTAL")
        idx.insert(sigs, batch_size=1024, progress=prog, bulk=bulk)
        t_build = time.perf_counter() - t0
        # steady-state rate excludes the first batch, which pays the two
        # one-time jit compiles (amortized to ~0 by the persistent compile
        # cache)
        steady = ((marks[-1][0] - marks[0][0]) / (marks[-1][1] - marks[0][1])
                  if len(marks) > 1 else n / t_build)
        log(f"BUILD: {t_build:.1f}s for {n} points "
            f"({n / t_build:.0f}/s total, {steady:.0f}/s steady-state; "
            f"first batch incl. compiles {marks[0][1]:.1f}s)")
        if cache:
            np.savez(cache, nbrs=idx._nbrs, nbr_d=idx._nbr_d,
                     entries=idx._entry_ids, build_s=t_build,
                     steady_per_s=steady)

    # ---- exact oracle on device, chunked over db rows (a full [Q, N]
    # sweep would need a padded second copy of the matrix)
    import functools
    from gsearch_tpu.ops.distance import hamming_frac_xla

    from gsearch_tpu.index.hnsw import (_next_pow2, _rerank_device_bytes,
                                        _round_up)
    spad_s = _round_up(s, 1024)
    full_bytes = (_next_pow2(n) + 1) * spad_s * 4
    stream_oracle = full_bytes > _rerank_device_bytes()
    if stream_oracle:
        # beyond the device budget: stream the matrix from host RAM chunk
        # by chunk — the honest exact path at this scale, and exactly why
        # the graph index exists
        log(f"full matrix {full_bytes/1e9:.1f} GB > device budget: streaming oracle")
        full = None
        sp = spad_s
    else:
        full = idx._device_full_sigs()  # [nb+1, 8, Sp/8] u32 (lane-padded)
        sp = full.shape[1] * full.shape[2]
    q_pad = np.ones((nq, sp), np.uint32)  # col pads=1 vs db's 0: never equal
    q_pad[:, :s] = queries.view(np.uint32)
    q_dev = jnp.asarray(q_pad)
    chunk = 16384

    @functools.partial(jax.jit, static_argnames=("k", "chunk"))
    def oracle_chunk(full, q, start, n_live, *, k, chunk):
        db = jax.lax.dynamic_slice_in_dim(full, start, chunk, axis=0)
        db = db.reshape(chunk, sp)  # per-chunk layout copy only
        d = hamming_frac_xla(q, db)  # normalized by sp; rescale to S
        d = (d * jnp.float32(sp) - jnp.float32(sp - s)) / jnp.float32(s)
        col = start + jnp.arange(chunk, dtype=jnp.int32)
        d = jnp.where((col < n_live)[None, :], d, jnp.inf)
        neg, ii = jax.lax.top_k(-d, k)
        return -neg, start + ii

    @functools.partial(jax.jit, static_argnames=("k",))
    def stream_chunk(db_rows, q, start, n_live, *, k):
        d = hamming_frac_xla(q, db_rows)  # normalized by sp; rescale to S
        d = (d * jnp.float32(sp) - jnp.float32(sp - s)) / jnp.float32(s)
        col = start + jnp.arange(db_rows.shape[0], dtype=jnp.int32)
        d = jnp.where((col < n_live)[None, :], d, jnp.inf)
        neg, ii = jax.lax.top_k(-d, k)
        return -neg, start + ii

    def exact_search():
        best_d = np.full((nq, k), np.inf, np.float32)
        best_i = np.zeros((nq, k), np.int32)
        # iterate the power-of-two row region only (excludes the sentinel
        # row): chunks never overlap, so the merged top-k has no duplicate
        # candidates (a clamped last chunk once re-covered nearly the whole
        # matrix at N=16384 and silently halved measured recall)
        nrows = _next_pow2(n) if stream_oracle else full.shape[0] - 1
        cstep = min(chunk, nrows)
        assert nrows % cstep == 0
        sigs_u = idx._sigs.view(np.uint32) if stream_oracle else None
        for st in range(0, nrows, cstep):
            if stream_oracle:
                rows = np.zeros((cstep, sp), np.uint32)
                live = max(min(n - st, cstep), 0)
                if live:
                    rows[:live, :s] = sigs_u[st : st + live]
                db_dev = jnp.asarray(rows)
                dd, ii = stream_chunk(db_dev, q_dev, jnp.int32(st),
                                      jnp.int32(n), k=min(k, cstep))
                dd, ii = np.asarray(dd), np.asarray(ii)
                db_dev.delete()  # free the 800 MB staging buffer eagerly
                del db_dev, rows
                if (st // cstep) % 16 == 0:
                    log(f"oracle chunk {st // cstep}: rss {_rss_gb():.1f} GB")
            else:
                dd, ii = oracle_chunk(full, q_dev, jnp.int32(st), jnp.int32(n),
                                      k=min(k, cstep), chunk=cstep)
            cd = np.concatenate([best_d, np.asarray(dd)], axis=1)
            ci = np.concatenate([best_i, np.asarray(ii)], axis=1)
            sel = np.argsort(cd, axis=1, kind="stable")[:, :k]
            best_d = np.take_along_axis(cd, sel, axis=1)
            best_i = np.take_along_axis(ci, sel, axis=1)
        return best_d, best_i

    ocache = (f"{cache}.oracle{'' if nq == 256 else nq}.npz") if cache else ""
    skip_recall = bool(os.environ.get("HNSW_BENCH_SKIP_RECALL"))
    if skip_recall:
        # qps-only re-measurement (e.g. a bigger query batch on a cached
        # graph whose recall is already recorded): skip the exact oracle
        oracle_d = np.zeros((nq, k), np.float32)
        oracle_ids = np.full((nq, k), -1, np.int32)
        exact_qps = float("nan")
    elif ocache and os.path.exists(ocache):
        og = np.load(ocache)
        oracle_d, oracle_ids = og["d"], og["ids"]
        exact_qps = float(og["exact_qps"])
        log(f"reused cached oracle (exact qps {exact_qps:.0f})")
    else:
        t0 = time.perf_counter()
        oracle_d, oracle_ids = exact_search()
        t_oracle_compile = time.perf_counter() - t0
        log(f"oracle done (compile+run {t_oracle_compile:.1f}s)")

        if stream_oracle and os.environ.get("HNSW_BENCH_ORACLE_ONCE"):
            # 1M x 12000: skip a second 50 GB sweep; the first sweep's
            # wall (compile included) is a conservative exact-qps
            exact_qps = nq / t_oracle_compile
        elif stream_oracle:
            # one sweep re-uploads the whole matrix from the host; its
            # duration (minus compiles) IS the exact path's cost here
            t0 = time.perf_counter()
            exact_search()
            exact_qps = nq / (time.perf_counter() - t0)
        else:
            t0 = time.perf_counter()
            iters = 2
            for _ in range(iters):
                exact_search()
            exact_qps = nq * iters / (time.perf_counter() - t0)
        log(f"exact-path qps at N={n}: {exact_qps:.0f}")
        if ocache:
            np.savez(ocache, d=oracle_d, ids=oracle_ids, exact_qps=exact_qps)

    results = {
        "n": n, "s": s, "max_nb_conn": m, "ef_construction": efc,
        "build_s": round(t_build, 1),
        "exact_qps": None if skip_recall else round(exact_qps, 1),
        "points_per_s": round(n / t_build, 1), "curve": [],
        "build_path": ("incremental" if os.environ.get("HNSW_BENCH_INCREMENTAL")
                       else "bulk"),
    }
    try:
        results["points_per_s_steady"] = round(float(steady), 1)
    except NameError:
        if cache and os.path.exists(cache) and "steady_per_s" in np.load(cache):
            results["points_per_s_steady"] = round(
                float(np.load(cache)["steady_per_s"]), 1)

    def recall_of(ids):
        return float(np.mean([
            len(set(oracle_ids[i]) & set(ids[i])) / k for i in range(nq)]))

    def tie_aware(dd):
        return float(np.mean([
            1.0 - sum(1 for a, b in zip(sorted(dd[i]), sorted(oracle_d[i]))
                      if a > b + 1e-6) / k for i in range(nq)]))

    # device-resident query buffer: production queries come out of the
    # sketch pipeline already on-chip, so qps_dev (search_device, no
    # per-call staging upload) is the serving number;
    # qps (idx.search) additionally pays the host->device query upload
    from gsearch_tpu.index.hnsw import _as_u32, _next_pow2
    qb = _next_pow2(nq, floor=8)
    qbuf = np.full((qb, s), 0xFFFFFFFF, np.uint32)
    qbuf[:nq] = _as_u32(np.ascontiguousarray(queries, dtype=idx.sig_dtype))
    q_dev_full = jnp.asarray(qbuf)
    dev_rerank = not idx._host_rerank_needed()

    for mult in mults:
        idx.entry_tier_mult = mult
        idx._refresh_entries()
        idx._device = None  # re-pad the entry array for the new tier
        tier = len(idx._entry_ids)
        for ef in efs:
            t0 = time.perf_counter()
            dd, ids = idx.search(queries, knbn=k, ef_search=ef)  # compile + run
            t_compile = time.perf_counter() - t0
            rec, ta = recall_of(ids), tie_aware(dd)
            t0 = time.perf_counter()
            iters = 4
            for _ in range(iters):
                idx.search(queries, knbn=k, ef_search=ef)
            qps = nq * iters / (time.perf_counter() - t0)
            out_dev = idx.search_device(q_dev_full, k, ef, rerank=dev_rerank)
            jax.block_until_ready(out_dev)
            t0 = time.perf_counter()
            for _ in range(iters):
                jax.block_until_ready(
                    idx.search_device(q_dev_full, k, ef, rerank=dev_rerank))
            qps_dev = nq * iters / (time.perf_counter() - t0)
            log(f"tier={tier} ef={ef}: recall@10={rec:.4f} tie-aware={ta:.4f} "
                f"qps={qps:.0f} qps_dev={qps_dev:.0f} "
                f"(first call {t_compile:.1f}s)")
            results["curve"].append({
                "tier": tier, "ef": ef,
                "recall10": None if skip_recall else round(rec, 4),
                "tie_aware": None if skip_recall else round(ta, 4),
                "qps": round(qps, 1), "qps_dev": round(qps_dev, 1)})

    out = os.environ.get("HNSW_BENCH_OUT", "HNSW_BENCH.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    log(f"wrote {out}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
