"""Smoke test of the main path on the GPU: the quickest proof that the
system starts and answers correctly on the card.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs: the mesh paths only

One process drives the card(s); the CLI runs in-process through
gsearch_tpu.cli.main.main(argv).  Phases (one line each):

  device   the card's name and power limit (nvidia-smi), JAX's view of it,
           the compile cache directory, whether the native parser loaded
  kernel   the rerank gather (gather_eqcount) at its four widths against
           a numpy re-count (exact), the int8 estimator's scores
           against an int32 reference (exact), the int8 GEMM's HLO target
  sketch   the batched sketch dispatch at both element budgets (2^23, the
           default, and 2^25)
  cli      tohnsw / request / reformat / add / request on 256 generated
           genomes of 2-6 Mb (k=16, s=12000, the GTDB r207 setting)
  index    FlatIndex and HnswIndex at 65,536 x 12,000 signatures on the
           device, recall@10 against the exact oracle
  multi    (--multi) tohnsw/request --mesh 4 through MeshGraphSearcher and
           MeshMxuSearcher at 65,536 x 12,000, against one card's answers

The last line of stdout is {"ok": true, "device": {...}}.  Without a GPU
the script exits non-zero before any phase runs; any failed check raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

K, S = 16, 12_000
GENOME_BP = (2_000_000, 6_000_000)
N_INDEX = 65_536
BATCH = 1024       # queries per index search
N_CHECK = 64       # of which oracle-checked
KERNEL_QUERIES = 512
KNBN = 10


def say(phase: str, **kv) -> None:
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


class LogTap(logging.Handler):
    """Keeps the pipeline's log lines (stage reports, chosen searcher)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def last(self, prefix: str) -> str:
        return next((m for m in reversed(self.lines) if m.startswith(prefix)), "")


# ---------------------------------------------------------------- corpus

ACGT = np.frombuffer(b"ACGT", np.uint8)


def mutate(rng, anc: np.ndarray, rate: float) -> np.ndarray:
    """Point-mutate a fraction `rate` of positions to a different base."""
    g = anc.copy()
    m = rng.random(len(g)) < rate
    g[m] = (g[m] + rng.integers(1, 4, int(m.sum()), dtype=np.uint8)) % 4
    return g


def write_fasta(path: str, name: str, codes: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(ACGT[codes].tobytes())
        f.write(b"\n")


def gen_corpus(root: str, rng, n_clusters: int, per_cluster: int,
               n_queries: int, n_added: int) -> dict:
    """Clustered genomes as in scripts/bench_build5k.py: per-cluster
    ancestors of 2-6 Mb, members at 0.5-8% point mutations.  Queries are
    1% mutants of distinct members; `added` genomes come from new clusters.
    Returns the directories and each query's source genome."""
    dirs = {k: os.path.join(root, k) for k in ("db", "queries", "added")}
    for d in dirs.values():
        os.makedirs(d)
    members = []
    for c in range(n_clusters + n_added):
        anc = rng.integers(0, 4, int(rng.integers(GENOME_BP[0], GENOME_BP[1] + 1)),
                           dtype=np.uint8)
        if c >= n_clusters:  # one new genome per added cluster
            write_fasta(os.path.join(dirs["added"], f"a{c:04d}.fna"),
                        f"added_{c}", mutate(rng, anc, 0.02))
            continue
        for j in range(per_cluster):
            name = f"g{c:03d}_{j}"
            g = mutate(rng, anc, rng.uniform(0.005, 0.08))
            write_fasta(os.path.join(dirs["db"], name + ".fna"), name, g)
            members.append((name, g))
    sources = {}
    for qi, mi in enumerate(rng.choice(len(members), n_queries, replace=False)):
        name, g = members[mi]
        qname = f"q{qi:02d}"
        write_fasta(os.path.join(dirs["queries"], qname + ".fna"), qname,
                    mutate(rng, g, 0.01))
        sources[qname + ".fna"] = name + ".fna"
    return dirs | {"sources": sources}


def read_neighbors(path: str) -> dict:
    """query file -> [(distance, answer file)] in file order."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            if line.startswith("query_id:"):
                p = line.split("\t")
                out.setdefault(os.path.basename(p[1]), []).append(
                    (float(p[3]), os.path.basename(p[5])))
    return out


# ---------------------------------------------------------------- phases

def phase_device(multi: bool):
    import jax

    from gsearch_tpu.io.native import get_lib
    from gsearch_tpu.utils import device_profile, enable_compilation_cache

    prof = device_profile()
    if prof.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform is {prof.platform})",
              file=sys.stderr)
        sys.exit(2)
    want = 4 if multi else 1
    check(prof.count >= want, f"{want} GPU(s) needed, {prof.count} present")
    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    say("device", kind=repr(prof.kind), count=prof.count,
        bytes_limit=prof.bytes_limit, jax=jax.__version__,
        compile_cache=cache, native_parser=get_lib() is not None)
    return prof


def _time(fn, reps=5):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts) * 1e3


def phase_kernel(seed: int):
    import jax
    import jax.numpy as jnp

    from gsearch_tpu.ops.distance import gather_eqcount
    from gsearch_tpu.ops.mxu import _sign_scores, expand_signs

    def eq_fields(x, parts):  # numpy: equal packed fields of x = a ^ b
        bits = 32 // parts
        return sum((((x >> np.uint32(bits * b)) & np.uint32((1 << bits) - 1)) == 0)
                   .astype(np.int64) for b in range(parts))

    key = jax.random.PRNGKey(seed)
    n, qn = N_INDEX, KERNEL_QUERIES
    # (tier, fields per u32 lane, lanes, real fields, candidates): raw
    # S=12000 padded to 12288 lanes, the compact 16-bit pairs, and the
    # packed8 / packed4 hash tiers
    widths = [("raw", 1, 12288, S, 80), ("compact", 2, 6144, S, 160),
              ("packed8", 4, 3072, 12288, 80), ("packed4", 8, 2048, 16384, 80)]
    times = {}
    for name, parts, lanes, s_true, c in widths:
        k1, k2, k3 = jax.random.split(jax.random.fold_in(key, parts), 3)
        db = jax.random.randint(k1, (n, lanes), 0, 4, jnp.int32).astype(jnp.uint32)
        db = db * jnp.uint32(0x11111111 if parts > 1 else 1)
        q = jnp.take(db, jax.random.randint(k2, (qn,), 0, n), axis=0)
        q = q ^ jax.random.randint(k3, (qn, lanes), 0, 2, jnp.int32).astype(jnp.uint32)
        ids = jax.random.randint(k3, (qn, c), 0, n, jnp.int32)
        run = jax.jit(lambda db, q, ids: gather_eqcount(
            db, q, ids, s_true=s_true, parts=parts))
        d = np.asarray(run(db, q, ids))
        # numpy re-count of 16 queries' candidate rows (the distance's
        # final division is XLA's; the index phase checks it bitwise)
        sub_ids = np.asarray(ids[:16])
        rows = np.asarray(db)[sub_ids] ^ np.asarray(q[:16])[:, None, :]
        got_eq = np.rint((1.0 - d[:16].astype(np.float64)) * s_true)
        check(np.array_equal(got_eq, eq_fields(rows, parts).sum(-1)),
              f"gather_eqcount {name}: equal counts != numpy")
        ms = _time(lambda: run(db, q, ids))
        times[name] = {"ms": round(ms, 4),
                       "GBps": round(qn * c * lanes * 4 / ms / 1e6, 1)}
        del db, q, ids

    # int8 estimator scores: exact against an int32 product on a row subset
    k1, k2 = jax.random.split(key)
    sig = jax.random.randint(k1, (N_INDEX, S), 0, 1 << 30, jnp.int32).astype(jnp.uint32)
    q_exp = expand_signs(sig[:64], m=4)
    db_exp = expand_signs(sig, m=4)
    got = np.asarray(jax.jit(_sign_scores)(q_exp, db_exp))
    rows = np.asarray(jax.random.choice(k2, N_INDEX, (512,), replace=False))
    ref = np.asarray(jax.lax.dot_general(
        q_exp.astype(jnp.int32), db_exp[rows].astype(jnp.int32),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32))
    check(np.array_equal(got[:, rows], ref.astype(np.float32)),
          "int8 estimator scores != int32 reference")
    # the GEMM must read int8 operands (no widening convert in front of
    # it); on the GPU XLA hands it to cuBLAS or to its own Triton GEMM
    hlo = jax.jit(_sign_scores).lower(q_exp, db_exp).compile().as_text()
    dtype_of = dict(re.findall(r"%([\w.\-]+) = \(?(\w+)\[", hlo))
    gemm = next(ln.strip() for ln in hlo.splitlines()
                if "__cublas" in ln or " dot(" in ln)
    operands = re.search(r"(?:custom-call|dot)\(([^)]*)\)", gemm).group(1)
    types = [dtype_of.get(o.strip().lstrip("%")) for o in operands.split(",")]
    check(types == ["s8", "s8"], f"int8 GEMM operands are {types}: {gemm[:160]}")
    # cuBLAS custom calls and XLA's own (Triton) GEMM fusions, by name
    target = ",".join(sorted(set(re.findall(r'custom_call_target="(__cublas[^"]*)"', hlo))
                             | set(re.findall(r'"kind":"(__triton[^"]*)"', hlo)))) or "dot"
    say("kernel", gather_counts_exact=True, gather_queries=qn,
        gather=json.dumps(times).replace(" ", ""),
        int8_scores_exact=True, int8_gemm_target=target)


def phase_sketch(seed: int):
    """Both sides of the batched sketch dispatch budget, once: 32 genomes
    of 4 Mb, k=16, s=12000 optdens."""
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu.models import make_sketcher

    rng = np.random.default_rng(seed)
    genomes = [rng.integers(0, 4, GENOME_BP[1] * 2 // 3, dtype=np.uint8)
               for _ in range(32)]
    result = {}
    for log2 in (23, 25):
        sk = make_sketcher(SeqSketcherParams(kmer_size=K, sketch_size=S,
                                             algo="OPTDENS", data_t="DNA"))
        sk.__dict__["_BATCH_ELEMS_LOG2"] = log2  # the env knob, per instance
        t0 = time.perf_counter()
        first = sk.sketch_many(genomes)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = sk.sketch_many(genomes)
        t_steady = time.perf_counter() - t0
        check(np.array_equal(first, again), "sketch is not deterministic")
        result[log2] = (first, t_first, t_steady)
    check(np.array_equal(result[23][0], result[25][0]), "budgets disagree")
    mb = sum(len(g) for g in genomes) / 1e6
    say("sketch", genomes=32, mbases=round(mb, 1),
        **{f"elems2^{k}": f"first_s={v[1]:.3f},steady_s={v[2]:.4f},"
                          f"mbases_per_s={mb / v[2]:.1f}"
           for k, v in result.items()})


def phase_cli(work: str, seed: int, tap: LogTap):
    from gsearch_tpu.cli.main import main as cli

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    c = gen_corpus(os.path.join(work, "cli"), rng, n_clusters=32,
                   per_cluster=8, n_queries=16, n_added=32)
    gbases = sum(os.path.getsize(os.path.join(c["db"], f))
                 for f in os.listdir(c["db"])) / 1e9
    t_gen = time.perf_counter() - t0
    db, out = os.path.join(work, "cli", "gsdb"), os.path.join(work, "cli", "out")

    def run(argv):
        t = time.perf_counter()
        check(cli(argv) == 0, f"CLI {argv[0]} failed")
        return round(time.perf_counter() - t, 3)

    walls = {"tohnsw": run(["tohnsw", "-d", c["db"], "-k", str(K), "-s", str(S),
                            "-n", "128", "--ef", "1600", "--algo", "optdens",
                            "--block", "-o", db])}
    build_log = tap.last("build done")
    walls["request"] = run(["request", "-b", db, "-n", "10", "-r", c["queries"],
                            "-o", out])
    request_log = tap.last("request done")
    nb_file = os.path.join(out, "gsearch.neighbors.txt")
    ani_file = os.path.join(out, "ani.tsv")
    walls["reformat"] = run(["reformat", str(K), "1", nb_file, ani_file])
    ani = {}
    with open(ani_file) as f:
        next(f)
        for line in f:
            qn, _, ans, _, a = line.rstrip("\n").split("\t")
            ani.setdefault(qn, (ans, float(a)))  # rows sorted by distance
    check(len(ani) == len(c["sources"]), f"{len(ani)} of 16 queries answered")
    for qn, src in c["sources"].items():
        ans, a = ani[qn]
        check(ans == src, f"{qn}: top hit {ans}, planted source {src}")
        check(abs(a - 99.0) <= 0.5, f"{qn}: ANI {a} not within 0.5 of 99")
    anis = [a for _, a in ani.values()]

    walls["add"] = run(["add", "-b", db, "-n", c["added"]])
    add_log = tap.last("add done")
    probe = sorted(os.listdir(c["added"]))[0]
    qdir = os.path.join(work, "cli", "probe")
    os.makedirs(qdir)
    shutil.copy(os.path.join(c["added"], probe), qdir)
    out2 = os.path.join(work, "cli", "out2")
    walls["request_added"] = run(["request", "-b", db, "-n", "10", "-r", qdir,
                                  "-o", out2])
    line = next(ln for ln in open(os.path.join(out2, "gsearch.neighbors.txt"))
                if ln.startswith("query_id:"))
    parts = line.split("\t")
    check(os.path.basename(parts[5]) == probe and parts[3] == "0.00000E0",
          f"added genome came back as {parts[5]} at {parts[3]}")
    say("cli", genomes=256, gbases=round(gbases, 3), gen_s=round(t_gen, 1),
        top1_is_source="16/16", ani_min=round(min(anis), 3),
        ani_max=round(max(anis), 3), added_at_distance=parts[3],
        wall_s=json.dumps(walls).replace(" ", ""))
    for what, msg in (("build", build_log), ("request", request_log),
                      ("add", add_log)):
        print(f"  stages {what}: {msg}", flush=True)


def planted_signatures(seed: int):
    """65,536 x 12,000 f32 signatures on the device with N_CHECK queries,
    each with KNBN planted neighbours at distinct distances 0.05..0.50
    (the rest of the database sits at distance ~1)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    planted = rng.choice(N_INDEX, N_CHECK * KNBN, replace=False).reshape(N_CHECK, KNBN)

    @jax.jit
    def gen(key):
        kd, kq, km, kv = jax.random.split(key, 4)
        db = jax.random.uniform(kd, (N_INDEX, S), jnp.float32)
        q = jax.random.uniform(kq, (N_CHECK, S), jnp.float32)
        frac = 0.05 + 0.05 * jnp.arange(KNBN, dtype=jnp.float32)
        mask = jax.random.uniform(km, (N_CHECK, KNBN, S)) < frac[None, :, None]
        alt = jax.random.uniform(kv, (N_CHECK, KNBN, S), jnp.float32)
        rows = jnp.where(mask, alt, q[:, None, :])
        return db.at[jnp.asarray(planted.reshape(-1))].set(rows.reshape(-1, S)), q

    db, q = gen(jax.random.PRNGKey(seed))
    return db, q


def oracle_topk(db, q):
    import jax
    import jax.numpy as jnp

    from gsearch_tpu.ops.distance import hamming_frac_xla

    d = hamming_frac_xla(q.view(jnp.uint32), db.view(jnp.uint32))
    neg, ids = jax.lax.top_k(-d, KNBN)
    return -np.asarray(neg), np.asarray(ids)


def recall(ids, ref_ids) -> float:
    return float(np.mean([len(set(a[:KNBN]) & set(b)) / KNBN
                          for a, b in zip(ids, ref_ids)]))


def phase_index(seed: int):
    import jax
    import jax.numpy as jnp

    from gsearch_tpu.index.flat import FlatIndex
    from gsearch_tpu.index.hnsw import HnswIndex
    from gsearch_tpu.ops.distance import bucketed_knn

    db, q_chk = planted_signatures(seed)
    ref_d, ref_i = oracle_topk(db, q_chk)
    # the oracle-checked queries, then database rows
    batch = jnp.concatenate([q_chk, db[: BATCH - N_CHECK]], 0)

    flat = FlatIndex(S, np.float32)
    flat.insert(db)
    t0 = time.perf_counter()
    d, i = flat.search(batch, KNBN)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, i = flat.search(batch, KNBN)
    t_flat = time.perf_counter() - t0
    r_flat = recall(i[:N_CHECK], ref_i)
    check(r_flat >= 0.99, f"flat recall@10 {r_flat}")
    check(np.array_equal(d[:N_CHECK, 0], ref_d[:, 0]), "flat top-1 distance != oracle")
    check((i[N_CHECK:, 0] == np.arange(BATCH - N_CHECK)).all(), "flat self-queries")
    # the other side of the flat index's device check: the exact compare
    # sweep it takes without an accelerator, once, on the same queries
    t0 = time.perf_counter()
    d_s, i_s = bucketed_knn(batch, db, KNBN)
    t_sweep = time.perf_counter() - t0
    check(np.array_equal(d_s[:N_CHECK, 0], ref_d[:, 0]), "sweep top-1 != oracle")
    del flat

    db_host = np.asarray(db)
    hnsw = HnswIndex(sketch_size=S, sig_dtype=np.float32, max_nb_conn=64,
                     ef_construction=256)
    t0 = time.perf_counter()
    hnsw.insert(db_host, bulk=True)
    t_build = time.perf_counter() - t0
    batch_h = np.asarray(batch)
    t0 = time.perf_counter()
    d, i = hnsw.search(batch_h, KNBN, ef_search=64)
    t_hfirst = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, i = hnsw.search(batch_h, KNBN, ef_search=64)
    t_hnsw = time.perf_counter() - t0
    check(hnsw._coarse not in (None, False), "graph search skipped the coarse tier")
    r_hnsw = recall(i[:N_CHECK], ref_i)
    check(r_hnsw >= 0.99, f"hnsw recall@10 {r_hnsw}")
    check(np.array_equal(d[:N_CHECK, 0], ref_d[:, 0]), "hnsw top-1 distance != oracle")
    say("index", n=N_INDEX, s=S, queries=BATCH,
        flat_recall10=r_flat, flat_qps=round(BATCH / t_flat, 1),
        flat_first_s=round(t_first, 3),
        sweep_qps=round(BATCH / t_sweep, 1),
        hnsw_recall10=r_hnsw, hnsw_qps_ef64=round(BATCH / t_hnsw, 1),
        hnsw_first_s=round(t_hfirst, 3), hnsw_build_s=round(t_build, 3),
        rerank_tier=hnsw._rerank_tier()[0],
        peak_bytes=(jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use"))
    return db, q_chk, ref_d, ref_i


def phase_multi(work: str, seed: int, tap: LogTap):
    import jax

    from gsearch_tpu.cli.main import main as cli
    from gsearch_tpu.ops.mxu import MxuSearcher
    from gsearch_tpu.parallel.mesh import MeshMxuSearcher

    rng = np.random.default_rng(seed + 1)
    c = gen_corpus(os.path.join(work, "multi"), rng, n_clusters=8,
                   per_cluster=8, n_queries=16, n_added=0)

    def build_and_request(tag, mesh):
        db, out = (os.path.join(work, "multi", x + tag) for x in ("gsdb", "out"))
        extra = ["--mesh", "4"] if mesh else []
        check(cli(extra + ["tohnsw", "-d", c["db"], "-k", str(K), "-s", str(S),
                           "-n", "128", "--ef", "1600", "--algo", "optdens",
                           "--block", "--index", "hnsw", "-o", db]) == 0, "tohnsw")
        check(cli(extra + ["request", "-b", db, "-n", "10", "-r", c["queries"],
                           "-o", out]) == 0, "request")
        return (read_neighbors(os.path.join(out, "gsearch.neighbors.txt")),
                tap.last("request searched with"))

    one, _ = build_and_request("_1", mesh=False)
    four, searcher = build_and_request("_4", mesh=True)
    check(searcher.endswith("MeshGraphSearcher"), f"mesh request used: {searcher}")
    check(one.keys() == four.keys() == c["sources"].keys(), "queries answered")
    same_top1 = all(one[qn][0][1] == four[qn][0][1] for qn in one)
    check(same_top1, "mesh top-1 differs from one card")
    r_graph = float(np.mean([len({a for _, a in four[qn]} & {a for _, a in one[qn]})
                             / len(one[qn]) for qn in one]))
    check(r_graph >= 0.99, f"mesh graph recall vs one card {r_graph}")

    db, q_chk = planted_signatures(seed)
    ref_d, ref_i = oracle_topk(db, q_chk)
    db_host, q_host = np.asarray(db), np.asarray(q_chk)
    del db
    d1, i1 = MxuSearcher(db_host, compact=True).search(q_host, KNBN)
    mesh = MeshMxuSearcher(db_host, n_devices=4)
    shards = {s.device for s in mesh._exp.addressable_shards}
    check(len(shards) == 4, f"MeshMxuSearcher shards on {len(shards)} devices")
    d4, i4 = mesh.search(q_host, KNBN)
    check((i4[:, 0] == i1[:, 0]).all(), "MeshMxuSearcher top-1 differs from one card")
    r_mxu = recall(i4, ref_i)
    check(r_mxu >= 0.99, f"MeshMxuSearcher recall@10 {r_mxu}")
    say("multi", devices=len(jax.devices()), graph_searcher="MeshGraphSearcher",
        graph_same_top1=same_top1, graph_recall_vs_one_card=r_graph,
        mxu_shard_devices=len(shards), mxu_same_top1=True,
        mxu_recall10=r_mxu)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    prof = phase_device(args.multi)
    tap = LogTap()
    logging.getLogger("gsearch_tpu").addHandler(tap)
    work = os.path.join(HERE, ".smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(work, args.seed, tap)
    else:
        phase_kernel(args.seed)
        phase_sketch(args.seed)
        phase_cli(work, args.seed, tap)
        phase_index(args.seed)
    shutil.rmtree(work, ignore_errors=True)
    say("done", wall_s=round(time.perf_counter() - t0, 1))
    print(json.dumps({"ok": True, "device": {
        "platform": prof.platform, "kind": prof.kind, "count": prof.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
