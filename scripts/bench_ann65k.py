"""The `ann` workflow at the reference's operating point (~65k genomes):
k-NN graph extraction + hubness + 2-D embedding, timed on the real chip.

The reference runs `ann --embed` on GTDB-scale databases
(/root/reference/src/bin/gsearch.rs:537-561); this measures the same path
end-to-end: batched self-search k-NN graph -> hubness stats -> full-batch
negative-sampling embedding -> quality estimate.

Usage: python scripts/bench_ann65k.py [N] [S]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import os
import sys
import time

import numpy as np


def log(m):
    print(f"[ann-bench {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65_536
    s = int(sys.argv[2]) if len(sys.argv) > 2 else 12_000

    from gsearch_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    import functools

    import jax
    import jax.numpy as jnp
    from gsearch_tpu.analysis.embed import Embedder, EmbedderParams
    from gsearch_tpu.analysis.kgraph import Hubness, kgraph_from_index
    from gsearch_tpu.index.flat import FlatIndex

    log(f"backend={jax.default_backend()} N={n} S={s}")

    # clustered corpus generated ON DEVICE, in row chunks: 64-genome clusters
    # around integer-valued centers, per-row mutation fraction 0.05..0.5.
    # (3.1 GB of host RNG plus an upload takes minutes; device gen is
    # seconds and leaves the signatures resident for the self-search.)
    n_centers = max(n // 64, 8)

    @functools.partial(jax.jit, static_argnames=("rows", "row0"))
    def gen_chunk(key, centers, *, rows, row0):
        km, kf, kv = jax.random.split(key, 3)
        idx = (row0 + jnp.arange(rows)) // 64
        base = jnp.take(centers, jnp.minimum(idx, n_centers - 1), axis=0)
        frac = jax.random.uniform(kf, (rows, 1), minval=0.05, maxval=0.5)
        mask = jax.random.uniform(km, (rows, s)) < frac
        alt = jax.random.uniform(kv, (rows, s), jnp.float32)
        return jnp.where(mask, alt, base)

    key = jax.random.PRNGKey(0)
    kc, key = jax.random.split(key)
    centers = jax.random.randint(
        kc, (n_centers, s), 0, 1 << 24).astype(jnp.float32)
    chunk = 8192
    parts = []
    for row0 in range(0, n, chunk):
        key, kr = jax.random.split(key)
        parts.append(gen_chunk(kr, centers, rows=min(chunk, n - row0), row0=row0))
    sigs = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    jax.block_until_ready(sigs)
    del parts, centers
    log("device data gen done")

    idx = FlatIndex(sketch_size=s, sig_dtype=np.float32)
    idx.insert(sigs)  # device-resident insert: zero host round-trips

    t0 = time.perf_counter()
    kg = kgraph_from_index(idx, knbn=8)
    t_kgraph = time.perf_counter() - t0
    # warm re-run: same extraction with every jit already compiled — the
    # steady-state cost with a warm compile cache
    t0 = time.perf_counter()
    kgraph_from_index(idx, knbn=8)
    t_kgraph_warm = time.perf_counter() - t0
    hub = Hubness(kg)
    s3m = hub.get_standard3m()
    log(f"kgraph: {t_kgraph:.1f}s for {n} nodes; hubness s3m={s3m:.3f}")

    t0 = time.perf_counter()
    emb = Embedder(kg, EmbedderParams())
    y = emb.embed()
    t_embed = time.perf_counter() - t0
    q = emb.get_quality_estimate_from_edge_length(500)
    log(f"embed: {t_embed:.1f}s; quality={q:.3f} (edge/random length ratio, small=good)")

    # cluster separation: the corpus is built as 64-genome clusters
    # (label = row // 64), so a neighborhood-preserving embedding must
    # place same-cluster pairs far closer than cross-cluster pairs
    prng = np.random.default_rng(7)
    pairs = prng.integers(0, n, (2, 50_000))
    lab = pairs // 64
    d = np.linalg.norm(y[pairs[0]] - y[pairs[1]], axis=1)
    same = lab[0] == lab[1]
    intra = float(d[same].mean()) if same.any() else float("nan")
    inter = float(d[~same].mean())
    log(f"cluster separation: intra={intra:.3f} inter={inter:.3f} "
        f"(ratio {intra / inter:.3f}, small=good)")
    assert q < 1.0, f"embed quality {q:.3f} fails the q < 1 bar"
    assert intra < inter, f"intra {intra:.3f} !< inter {inter:.3f}"

    out = {"n": n, "s": s, "kgraph_s": round(t_kgraph, 1),
           "kgraph_warm_s": round(t_kgraph_warm, 1),
           "embed_s": round(t_embed, 1), "hubness_s3m": round(float(s3m), 3),
           "embed_quality": round(float(q), 4),
           "embed_intra_cluster": round(intra, 3),
           "embed_inter_cluster": round(inter, 3)}
    with open("ANN_BENCH.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
