"""gsearch_tpu command-line interface.

Flag-level parity with the reference binary (reference:
src/bin/gsearch.rs:417-587): subcommands tohnsw / add / request / ann with
global --pio and --nbthreads.  As in the reference, add/request/ann accept
NO algorithm flags — everything is reloaded from the database's
parameters.json to guarantee coherence (gsearch.rs:55-58,714-742).

Extra (additions): --index {auto,flat,hnsw} on tohnsw, and the
`reformat` distance->ANI converter as a subcommand (standalone binary in
the reference, src/bin/reformat.rs).
"""

from __future__ import annotations

import argparse
import sys

from ..utils import enable_compilation_cache, get_logger

log = get_logger(__name__)


def _add_global(p: argparse.ArgumentParser) -> None:
    p.add_argument("--pio", type=int, default=0, help="files per parallel IO group")
    p.add_argument("--nbthreads", type=int, default=0, help="host parse threads")
    p.add_argument(
        "--mesh", type=int, default=0,
        help="shard sketching and search over a device mesh "
             "(0=off, -1=all devices, N=first N devices); replaces the "
             "reference's multiple_build/multiple_search scripts",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gsearch_tpu",
        description="genome sketch-and-search in JAX (gsearch capabilities)",
    )
    _add_global(ap)
    sub = ap.add_subparsers(dest="command", required=True)

    # tohnsw (gsearch.rs:417-483)
    t = sub.add_parser("tohnsw", help="build a database from a directory of FASTA files")
    t.add_argument("-d", "--dir", required=True, help="directory of genome FASTA files")
    t.add_argument("-k", "--kmer", type=int, required=True)
    t.add_argument("-s", "--sketch", type=int, required=True)
    t.add_argument("-n", "--nbng", type=int, required=True, help="max neighbors (M)")
    t.add_argument("--ef", type=int, default=1600)
    t.add_argument("--scale_modify_f", type=float, default=1.0)
    t.add_argument("--algo", default="optdens",
                   help="prob | super | super2 | hll | optdens | revoptdens")
    t.add_argument("--aa", action="store_true", help="amino-acid mode")
    t.add_argument("--block", action="store_true",
                   help="sketch whole files as one block (genome mode)")
    t.add_argument("--index", default="auto", choices=["auto", "flat", "hnsw"])
    t.add_argument("-o", "--out", default=".", help="output database directory")

    # add (gsearch.rs:488-505)
    a = sub.add_parser("add", help="add genomes to an existing database")
    a.add_argument("-b", "--hnsw", required=True, dest="hnsw_dir", help="database directory")
    a.add_argument("-n", "--new", required=True, dest="new_dir", help="directory of new genomes")

    # request (gsearch.rs:507-535)
    r = sub.add_parser("request", help="search query genomes against a database")
    r.add_argument("-b", "--hnsw", required=True, dest="hnsw_dir")
    r.add_argument("-n", "--nbanswers", type=int, required=True)
    r.add_argument("-r", "--query", required=True, dest="req_dir")
    r.add_argument("-o", "--out", default=".", help="output directory")
    r.add_argument(
        "--ef", type=int, default=0,
        help="graph search width; 0 = measured default (256). The reference "
             "hardcodes 5000 (gsearch.rs:893) — pass --ef 5000 for parity; "
             "the 262k recall curve showed no recall gain past 64",
    )

    # ann (gsearch.rs:537-561); embedder knobs mirror annembed's
    # EmbedderParams as the reference configures them (embed.rs:40-47)
    n = sub.add_parser("ann", help="graph stats and 2-D embedding of a database")
    n.add_argument("-b", "--hnsw", required=True, dest="hnsw_dir")
    n.add_argument("-s", "--stats", action="store_true")
    n.add_argument("-e", "--embed", action="store_true")
    n.add_argument("--nb_grad_batch", type=int, default=15,
                   help="gradient batches (annembed default 15)")
    n.add_argument("--scale_rho", type=float, default=0.75)
    n.add_argument("--beta", type=float, default=1.0)
    n.add_argument("--grad_step", type=float, default=3.0)
    n.add_argument("--nb_sampling_by_edge", type=int, default=10)
    n.add_argument("--knbn", type=int, default=8,
                   help="k-NN graph width (reference: embed.rs:19-22)")
    n.add_argument("-o", "--out", default=".", help="output directory")

    # import: reference (Rust gsearch) database dir -> native database
    # (reference dump layout: src/utils/dumpload.rs:15-62; the published
    # DBs of gsearch_database.txt become usable without re-sketching)
    i = sub.add_parser("import", help="convert a reference-format database")
    i.add_argument("-b", "--refdb", required=True, dest="ref_dir",
                   help="reference database dir (hnswdump.hnsw.data + "
                        "seqdict.json + parameters.json)")
    i.add_argument("-o", "--out", required=True, help="output database dir")
    i.add_argument("--index", default="auto", choices=["auto", "flat", "hnsw"])

    # reformat (src/bin/reformat.rs)
    f = sub.add_parser("reformat", help="neighbors file -> TSV with ANI")
    f.add_argument("kmer", type=int)
    f.add_argument("model", type=int, help="1=Poisson, 2=Binomial")
    f.add_argument("input_file")
    f.add_argument("output_file")

    # companion tools, standalone binaries in the reference — reachable both
    # here and as python -m gsearch_tpu.cli.<tool>
    sub.add_parser("bindash", add_help=False)
    sub.add_parser("hypermash", add_help=False)
    sub.add_parser("superani", add_help=False)
    sub.add_parser("superaai", add_help=False)
    sub.add_parser("hnsw2knn", add_help=False)
    sub.add_parser("hnswcore", add_help=False)
    sub.add_parser("bigsig", add_help=False)
    sub.add_parser("genepred", add_help=False)
    sub.add_parser("hmmsearch", add_help=False)

    return ap


def _algo_name(name: str) -> str:
    return {"prob": "PROB3A"}.get(name.lower(), name.upper())


def main(argv=None) -> int:
    import sys as _sys

    argv = list(_sys.argv[1:] if argv is None else argv)
    # forward companion-tool subcommands to their own parsers
    tools = {
        "bindash": "gsearch_tpu.cli.bindash",
        "hypermash": "gsearch_tpu.cli.hypermash",
        "superani": "gsearch_tpu.cli.superani",
        "superaai": "gsearch_tpu.cli.superaai",
        "hnsw2knn": "gsearch_tpu.cli.hnsw2knn",
        "hnswcore": "gsearch_tpu.cli.hnswcore",
        "bigsig": "gsearch_tpu.cli.bigsig",
        "genepred": "gsearch_tpu.cli.genepred",
        "hmmsearch": "gsearch_tpu.cli.hmmsearch",
    }
    if argv and argv[0] in tools:
        import importlib

        return importlib.import_module(tools[argv[0]]).main(argv[1:])

    args = build_parser().parse_args(argv)
    enable_compilation_cache()

    from ..core import ComputingParams, HnswParams, ProcessingParams, SeqSketcherParams

    computing = ComputingParams(
        nb_files_par=args.pio, nb_threads=args.nbthreads, mesh_devices=args.mesh
    )

    if args.command == "tohnsw":
        from ..pipeline import build_database

        params = ProcessingParams(
            hnsw=HnswParams(
                capacity=1_500_000,
                ef=args.ef,
                max_nb_conn=min(args.nbng, 255),
                scale_modification=args.scale_modify_f,
            ),
            sketch=SeqSketcherParams(
                kmer_size=args.kmer,
                sketch_size=args.sketch,
                algo=_algo_name(args.algo),
                data_t="AA" if args.aa else "DNA",
            ),
            block_flag=args.block,
        )
        res = build_database(args.dir, args.out, params, computing, index_kind=args.index)
        print(f"built database with {res['nb_points']} points in {res['elapsed_s']:.1f}s")
        return 0

    if args.command == "import":
        from ..index.refimport import import_reference_db

        res = import_reference_db(args.ref_dir, args.out, index_kind=args.index)
        print(f"imported {res['nb_points']} points "
              f"({res['source_dtype']} sigs) -> {res['out']} ({res['index_kind']})")
        return 0

    if args.command == "add":
        from ..pipeline import add_to_database

        res = add_to_database(args.hnsw_dir, args.new_dir, computing)
        print(f"database now has {res['nb_points']} points (+{res['added']})")
        return 0

    if args.command == "request":
        from ..pipeline import request_database

        res = request_database(
            args.hnsw_dir, args.req_dir, args.nbanswers, computing,
            out_dir=args.out, ef_search=args.ef,
        )
        print(
            f"{res['nb_requests']} requests, {res['nb_matches']} matches "
            f"-> {res['neighbors_file']}"
        )
        return 0

    if args.command == "ann":
        from ..analysis.embed import EmbedderParams, get_graph_stats_embed

        eparams = EmbedderParams(
            nb_grad_batch=args.nb_grad_batch,
            scale_rho=args.scale_rho,
            beta=args.beta,
            grad_step=args.grad_step,
            nb_sampling_by_edge=args.nb_sampling_by_edge,
        )
        res = get_graph_stats_embed(
            args.hnsw_dir, ask_stats=args.stats, embed=args.embed,
            knbn=args.knbn, params=eparams, out_dir=args.out,
        )
        print(res["summary"])
        return 0

    if args.command == "reformat":
        from .reformat import reformat_file

        n = reformat_file(args.input_file, args.output_file, args.kmer, args.model)
        print(f"wrote {n} rows to {args.output_file}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
