"""bindash-rs equivalent: all-pairs densified-MinHash distance.

Output/behavior parity with the reference binary (reference:
src/bin/bindash.rs:235-411 — sketch each file list with OptDens (dens=0) or
RevOptDens (dens=1), all-pairs slot-equality Jaccard, distance
1 - (2J/(1+J))^(1/k), TSV "Query\tReference\tDistance", same-basename
pairs forced to 0).

Device formulation: the all-pairs comparison is ONE fused distance-matrix
kernel (ops/distance.py) over the stacked signature matrices instead of a
rayon loop over pairs.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def read_genome_list(path: str) -> list:
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def run_bindash(
    query_list: str,
    reference_list: str,
    kmer_size: int = 16,
    sketch_size: int = 2048,
    densification: int = 0,
    output: str | None = None,
) -> int:
    import jax.numpy as jnp

    from ..core.params import DataType, SeqSketcherParams, SketchAlgo
    from ..io.fasta import concat_file_codes
    from ..models import make_sketcher
    from ..ops.distance import hamming_frac

    queries = read_genome_list(query_list)
    refs = read_genome_list(reference_list)
    algo = SketchAlgo.OPTDENS if densification == 0 else SketchAlgo.REVOPTDENS
    params = SeqSketcherParams(
        kmer_size=kmer_size, sketch_size=sketch_size, algo=algo, data_t=DataType.DNA
    )
    sk = make_sketcher(params)

    def sketch_all(paths):
        sigs = []
        for p in paths:
            codes, _, _ = concat_file_codes(p)
            sigs.append(sk.sketch_codes(codes))
        return np.stack(sigs)

    q_sigs = sketch_all(queries)
    r_sigs = sketch_all(refs)

    ham = np.asarray(hamming_frac(jnp.asarray(q_sigs), jnp.asarray(r_sigs)))
    j = 1.0 - ham.astype(np.float64)
    dist = 1.0 - np.power(2.0 * j / (1.0 + j), 1.0 / kmer_size)

    out = open(output, "w") if output else sys.stdout
    out.write("Query\tReference\tDistance\n")
    n = 0
    for qi, q in enumerate(queries):
        qb = os.path.basename(q)
        for ri, r in enumerate(refs):
            d = 0.0 if qb == os.path.basename(r) else dist[qi, ri]
            out.write(f"{q}\t{r}\t{d:.6f}\n")
            n += 1
    if output:
        out.close()
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bindash", description="all-pairs densified MinHash ANI")
    ap.add_argument("-q", "--query_list", required=True)
    ap.add_argument("-r", "--reference_list", required=True)
    ap.add_argument("-k", "--kmer_size", type=int, default=16)
    ap.add_argument("-s", "--sketch_size", type=int, default=2048)
    ap.add_argument("-d", "--densification", type=int, default=0, choices=[0, 1])
    ap.add_argument("-t", "--threads", type=int, default=0, help="accepted for parity; unused")
    ap.add_argument("-o", "--output", default=None)
    args = ap.parse_args(argv)
    from ..utils import enable_compilation_cache

    enable_compilation_cache()
    n = run_bindash(
        args.query_list, args.reference_list, args.kmer_size, args.sketch_size,
        args.densification, args.output,
    )
    print(f"wrote {n} pairs", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
