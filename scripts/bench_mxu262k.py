"""262k-genome exact-rerank search on ONE device: the compact MxuSearcher.

Compact mode (ops/mxu.py: m=2 sign expansion + pair-packed 16-bit slot
hashes, 48 KB/row) holds a 262k x 12000 database in a fraction of the
memory of the two standard representations, keeping the int8-GEMM
full-sweep path at reference-RefSeq scale (~318k genomes, reference
README.md:134).

Measures: init time, qps (Q=1024 device-resident), recall@10 on planted
neighbors, and the rerank-distance error vs an exact host recompute of the
query->plant distances (validating the 2^-16/slot hash-collision bias
claim).  Writes MXU262K_BENCH.json.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 262_144
S = 12_000
CHUNK = 8192
N_Q = 1024
KNBN = 10
NQ_CHK = 32


def main() -> None:
    from gsearch_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from gsearch_tpu.ops.mxu import MxuSearcher

    print(f"[mxu262k] backend={jax.default_backend()}", file=sys.stderr, flush=True)

    @jax.jit
    def gen_chunk(key):
        return jax.random.uniform(key, (CHUNK, S), jnp.float32)

    @jax.jit
    def gen_plants(key):
        kq, km, kv = jax.random.split(key, 3)
        q_chk = jax.random.uniform(kq, (NQ_CHK, S), jnp.float32)
        frac = 0.05 + 0.04 * jnp.arange(KNBN, dtype=jnp.float32)
        mask = jax.random.uniform(km, (NQ_CHK, KNBN, S)) < frac[None, :, None]
        alt = jax.random.uniform(kv, (NQ_CHK, KNBN, S), jnp.float32)
        rows = jnp.where(mask, alt, q_chk[:, None, :])
        return q_chk, rows.reshape(NQ_CHK * KNBN, S)

    q_chk, plants = gen_plants(jax.random.PRNGKey(42))
    # exact distances of each check query to its plants (host, tiny)
    q_chk_h = np.asarray(q_chk)
    plants_h = np.asarray(plants).reshape(NQ_CHK, KNBN, S)
    d_exact = 1.0 - (plants_h == q_chk_h[:, None, :]).sum(-1) / np.float32(S)

    def chunk_iter():
        for ci in range(N // CHUNK):
            c = gen_chunk(jax.random.PRNGKey(1000 + ci))
            if ci == 0:  # plants occupy rows 0..NQ_CHK*KNBN-1
                c = jnp.concatenate([plants, c[NQ_CHK * KNBN :]], axis=0)
            yield c

    t0 = time.perf_counter()
    searcher = MxuSearcher.from_chunks(chunk_iter(), N, S)
    jax.block_until_ready(searcher._rr3)
    init_s = time.perf_counter() - t0
    assert searcher.compact, "262k x 12000 must select compact mode"
    print(f"[mxu262k] init {init_s:.1f}s (compact, m={searcher.m})",
          file=sys.stderr, flush=True)

    # timing queries: actual db rows from chunk 3 -> self-hit check
    q_base = 3 * CHUNK
    q = gen_chunk(jax.random.PRNGKey(1003))[:N_Q]

    # warm/compile + recall on the planted neighbors
    t0 = time.perf_counter()
    d_chk, ids_chk = searcher.search(np.asarray(q_chk), knbn=KNBN)
    print(f"[mxu262k] first search (compile) {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)
    want = np.arange(NQ_CHK * KNBN).reshape(NQ_CHK, KNBN)
    recall = float(np.mean([
        len(set(want[i]) & set(ids_chk[i])) / KNBN for i in range(NQ_CHK)
    ]))
    # rerank distance error vs exact (align by id)
    errs = []
    for i in range(NQ_CHK):
        for j, pid in enumerate(ids_chk[i]):
            if pid < NQ_CHK * KNBN and pid // KNBN == i:
                errs.append(abs(d_chk[i, j] - d_exact[i, pid % KNBN]))
    max_err = float(np.max(errs)) if errs else float("nan")

    # steady-state qps, device-resident queries
    d_dev, ids_dev = searcher.search_device(q, knbn=KNBN)
    jax.block_until_ready(ids_dev)
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        d_dev, ids_dev = searcher.search_device(q, knbn=KNBN)
    ids_host = np.asarray(ids_dev)
    dt = time.perf_counter() - t0
    qps = N_Q * iters / dt
    self_hits = float((ids_host[:, 0] == np.arange(q_base, q_base + N_Q)).mean())

    out = {
        "n": N,
        "s": S,
        "mode": "compact",
        "m": searcher.m,
        "init_s": round(init_s, 1),
        "qps": round(qps, 1),
        "recall10_planted": recall,
        "self_hit_rate": self_hits,
        "max_rerank_dist_err": max_err,
    }
    print(json.dumps(out))
    with open("MXU262K_BENCH.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
