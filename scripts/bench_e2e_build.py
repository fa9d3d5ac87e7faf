"""Full-corpus `tohnsw` build wall-clock on the real chip.

Generates a multi-gigabase synthetic corpus on disk (default 1024 files x
3 MB), then times the COMPLETE user-facing build path — directory walk,
parse, encode, packed upload, device sketch, index insert, five-file dump
— via pipeline.build_database, exactly what `python -m gsearch_tpu tohnsw`
runs.  The reference's effective build rate is ~144 MB/s (GTDB ~65k
genomes in <0.5 h on a 24-thread CPU, /root/reference/README.md:134).

Usage: python scripts/bench_e2e_build.py [n_files] [file_mb] [algo]
Writes E2E_BUILD.json.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def log(m):
    print(f"[e2e-build {time.strftime('%H:%M:%S')}] {m}", file=sys.stderr, flush=True)


def main():
    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    file_mb = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    algo = sys.argv[3] if len(sys.argv) > 3 else "OPTDENS"

    from gsearch_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    import jax
    from gsearch_tpu.core import ComputingParams, HnswParams, ProcessingParams
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu.pipeline import build_database

    log(f"backend={jax.default_backend()} files={n_files} x {file_mb}MB algo={algo}")
    rng = np.random.default_rng(0)
    td = tempfile.mkdtemp(prefix="e2e_corpus_")
    out = tempfile.mkdtemp(prefix="e2e_db_")
    # one big random base pool; each genome is a distinct slice + point
    # mutations would be overkill for a throughput bench — slices at random
    # offsets already defeat any content shortcut (every byte is parsed,
    # encoded, uploaded and hashed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    pool = rng.choice(acgt, (file_mb << 20) * 8)
    total = 0
    t0 = time.perf_counter()
    for i in range(n_files):
        off = int(rng.integers(0, len(pool) - (file_mb << 20)))
        g = pool[off : off + (file_mb << 20)].tobytes()
        total += len(g)
        with open(os.path.join(td, f"g{i:05d}.fna"), "wb") as f:
            f.write(b">chr1\n" + g + b"\n")
        if i % 256 == 0:
            log(f"corpus {i}/{n_files}")
    log(f"corpus written: {total / 1e9:.2f} Gbases in {time.perf_counter() - t0:.0f}s")

    pp = ProcessingParams(
        hnsw=HnswParams(capacity=n_files, ef=200, max_nb_conn=64,
                        scale_modification=1.0),
        sketch=SeqSketcherParams(kmer_size=16, sketch_size=12000, algo=algo,
                                 data_t="DNA"),
        block_flag=True,
    )
    comp = ComputingParams(nb_files_par=8, nb_threads=4)

    # warm the compile shapes on a tiny same-bucket subset so the measured
    # run is steady-state (compiles are paid once per shape, not per
    # corpus)
    wd = tempfile.mkdtemp(prefix="e2e_warm_")
    for i in range(8):
        shutil.copy(os.path.join(td, f"g{i:05d}.fna"), wd)
    build_database(wd, tempfile.mkdtemp(prefix="e2e_wdb_"), pp, comp)
    shutil.rmtree(wd, ignore_errors=True)
    log("warmup done; timing the full build")

    t0 = time.perf_counter()
    res = build_database(td, out, pp, comp)
    dt = time.perf_counter() - t0
    mbps = total / dt / 1e6
    log(f"BUILD: {dt:.1f}s for {total / 1e9:.2f} Gbases -> {mbps:.1f} Mbases/s "
        f"(reference ~144 MB/s effective)")
    result = {
        "n_files": n_files, "file_mb": file_mb, "algo": algo,
        "total_gbases": round(total / 1e9, 3),
        "build_s": round(dt, 1), "mbases_per_s": round(mbps, 1),
        "stages": res["stages"],
    }
    with open("E2E_BUILD.json", "w") as f:
        json.dump(result, f, indent=1)
    shutil.rmtree(td, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
