"""Orchestration pipelines: build (tohnsw), add, and request.

Capability-equivalent of the reference's L4 layer
(`sketchandstore_dir_compressedkmer`, src/dna/dnasketch.rs:64-477;
`sketch_and_request_dir_compressedkmer`, src/dna/dnarequest.rs:64-388;
and their AA mirrors).  The reference pipelines are 3 thread groups joined
by channels (producer -> sketchers -> collector); here the sketch stage IS
the device, so the pipeline reduces to: host ingest (grouped parallel IO +
parse, the --pio analog) -> device sketch kernels -> index insert -> dump.

Both DNA and AA flow through the same generic code — the dispatch over
algorithm x k-mer width that the reference does with 150 lines of static
type dispatch per mode (dnasketch.rs:493-644, aasketch.rs:449-552) is a
table lookup in models.make_sketcher plus the (hi, lo) lane-pair k-mer
representation that covers every width uniformly.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np

from .core import ComputingParams, ProcessingParams, ProcessingState, SeqDict
from .core.seqdict import Id, ItemDict
from .index import FlatIndex
from .index.hnsw import HnswIndex
from .index.serialize import dumpall, load_index
from .io.fasta import concat_file_codes_packed, file_records_codes
from .io.walk import iter_file_buffers, walk_fasta_dir
from .models import make_sketcher
from .results.answer import Neighbour, ReqAnswer
from .results.matcher import Matcher
from .utils import StageTimer, get_logger

log = get_logger(__name__)

OUT_THRESHOLD = 0.99  # answer filter (reference: dnarequest.rs:83, matcher.rs:235)
# Request-time ef.  The reference hardcodes ef_search=5000 (gsearch.rs:893)
# to drive its layered HNSW deep enough; our graph replaces the hierarchy
# with an exact entry tier that already lands the beam in the right
# cluster, and its 262k-point recall curve is flat in ef: recall@10 =
# 0.9996 from ef=64 up.  Default 0 = the index's own default (ef=256, a
# throughput point with recall margin); the reference's 5000 remains
# available via `request --ef 5000`.
EF_SEARCH = 0
NEIGHBORS_FILE = "gsearch.neighbors.txt"
MATCHES_FILE = "gsearch.matches"

# databases small enough for the exact index (strictly better recall and,
# on an accelerator, better throughput than graph traversal at this scale).
# The ceiling is a share of one device's memory: the GEMM searcher's
# compact representations cost ~4 bytes/slot/genome (ops/mxu.py
# planned_footprint), so the limit scales with 1/sketch_size.
FLAT_AUTO_CAP = 262_144
FLAT_AUTO_FRACTION = 0.75


def flat_auto_limit(sketch_size: int) -> int:
    from .utils import device_profile

    budget = device_profile().budget(FLAT_AUTO_FRACTION)
    return min(FLAT_AUTO_CAP, budget // max(4 * sketch_size, 1))


def _iter_parsed(paths, is_aa: bool, block_flag: bool, computing: ComputingParams,
                 timer: StageTimer):
    """Yield (path, [(codes, fasta_id, length), ...]) per file, in path
    order.  nb_threads > 1 parses files concurrently (read + decompress +
    native encode all release the GIL) — the reference's rayon parse
    workers (files.rs:258-341); otherwise --pio group slurping applies."""

    def parse_one(args):
        path, data = args
        with timer.stage("parse"):
            if data is None:
                from .io.fasta import read_file_bytes

                data = read_file_bytes(path)
            if block_flag:
                # DNA block mode parses straight into the packed upload
                # form via the fused native parser (PackedCodes); AA /
                # no-native fall back to code arrays inside
                codes, first_id, total = concat_file_codes_packed(
                    path, is_aa=is_aa, data=data)
                units = [(codes, first_id, total)] if total > 0 else []
            else:
                units = [
                    (codes, fid, len(codes))
                    for codes, fid in file_records_codes(path, is_aa=is_aa, data=data)
                ]
        return path, units

    nb_threads = computing.nb_threads
    if nb_threads == 0:
        # default (--nbthreads 0): use the host's cores, like the
        # reference's rayon default thread pool (files.rs:258-341); capped
        # — parse is bandwidth-bound well before 8 workers
        nb_threads = max(1, min(8, os.cpu_count() or 1))
    if nb_threads > 1:
        from .io.walk import bounded_thread_map

        yield from bounded_thread_map(
            parse_one, ((p, None) for p in paths), nb_threads
        )
    else:
        for _rank, path, data in iter_file_buffers(paths, computing.nb_files_par):
            yield parse_one((path, data))


def _sketch_dir(
    dirpath: str,
    params: ProcessingParams,
    computing: ComputingParams,
    seqdict: SeqDict,
    timer: StageTimer,
) -> List[np.ndarray]:
    """Walk + parse + sketch every FASTA under dirpath; extends seqdict and
    returns one signature per dictionary entry, in rank order.

    3-stage overlap, the device shape of the reference's producer/sketcher/
    collector thread groups (dnasketch.rs:183-456): a producer thread walks
    + parses + encodes into a bounded queue while the main thread assembles
    device batches; the device batches themselves overlap upload with
    compute behind the sketcher's in-flight window."""
    is_aa = params.sketch.data_t.value == "AA"
    sketcher = make_sketcher(params.sketch)
    if computing.mesh_devices:
        from .parallel.mesh import make_device_mesh

        mesh = make_device_mesh(
            None if computing.mesh_devices < 0 else computing.mesh_devices
        )
        sketcher.set_mesh(mesh)
        log.info("sketching sharded over %d devices", mesh.devices.size)
    paths = walk_fasta_dir(dirpath, is_aa=is_aa)
    if not paths:
        raise FileNotFoundError(f"no FASTA files under {dirpath}")
    log.info("found %d files under %s", len(paths), dirpath)
    tickets: List = []
    nb_seq = 0
    t_report = time.time()
    # buffer parsed genomes and sketch them in batched device dispatches
    # (the analog of the reference's 100-Mbase sketcher batches,
    # dnasketch.rs:246-325); submits are asynchronous, so device compute
    # of one flush overlaps parse/pack/upload of the next
    buf_codes: List[np.ndarray] = []
    buf_bases = 0

    def flush():
        nonlocal buf_codes, buf_bases
        if not buf_codes:
            return
        with timer.stage("sketch"):
            tickets.append(sketcher.sketch_submit(buf_codes))
        buf_codes = []
        buf_bases = 0

    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(computing.nb_files_par, 8))
    _END = object()

    def produce():
        try:
            for item in _iter_parsed(paths, is_aa, params.block_flag, computing, timer):
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            q.put(e)
        q.put(_END)

    prod = threading.Thread(target=produce, daemon=True, name="gsearch-producer")
    prod.start()
    filerank = 0
    while True:
        item = q.get()
        if item is _END:
            break
        if isinstance(item, BaseException):
            raise item
        path, units = item
        filerank += 1
        for codes, fasta_id, length in units:
            if length < params.sketch.kmer_size:
                # no valid k-mer can exist: an empty sketch carries no
                # signal and must not enter the index
                log.warning("skipping %s (%s): shorter than k", path, fasta_id)
                continue
            buf_codes.append(codes)
            buf_bases += len(codes)
            seqdict.push(ItemDict(id=Id(path=path, fasta_id=fasta_id), len=length))
            nb_seq += 1
            if buf_bases >= (1 << 26) or len(buf_codes) >= 2048:
                flush()
        if time.time() - t_report > 30:
            log.info("processed %d/%d files, %d sequences", filerank, len(paths), nb_seq)
            t_report = time.time()
    prod.join()
    flush()
    sigs: List[np.ndarray] = []
    with timer.stage("sketch-drain"):
        for t in tickets:
            sigs.extend(sketcher.sketch_finish(t))
    return sigs


def _mesh_size(computing: ComputingParams) -> int:
    if not computing.mesh_devices:
        return 0
    if computing.mesh_devices > 0:
        return computing.mesh_devices
    import jax

    return len(jax.devices())


def _new_index(params: ProcessingParams, sig_dtype, kind: str, nb_hint: int,
               n_shards: int = 0):
    if kind == "auto":
        kind = ("flat" if nb_hint <= flat_auto_limit(params.sketch.sketch_size)
                else "hnsw")
    if kind == "flat":
        return FlatIndex(params.sketch.sketch_size, sig_dtype)
    hkw = dict(
        sketch_size=params.sketch.sketch_size,
        sig_dtype=sig_dtype,
        max_nb_conn=params.hnsw.max_nb_conn,
        ef_construction=params.hnsw.ef,
        scale_modification=params.hnsw.scale_modification,
    )
    if n_shards > 1:
        # graph + mesh: one subgraph per device so request --mesh can run
        # every shard on its own chip (index/sharded.py)
        from .index.sharded import ShardedHnswIndex

        return ShardedHnswIndex(n_shards=n_shards, **hkw)
    return HnswIndex(**hkw)


def build_database(
    genome_dir: str,
    out_dir: str,
    params: ProcessingParams,
    computing: ComputingParams | None = None,
    index_kind: str = "auto",
) -> dict:
    """tohnsw: sketch a directory tree and build + dump a database
    (reference call stack: SURVEY.md §3.1)."""
    computing = computing or ComputingParams()
    timer = StageTimer()
    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    seqdict = SeqDict()
    sigs = _sketch_dir(genome_dir, params, computing, seqdict, timer)
    sig_mat = np.stack(sigs)
    index = _new_index(params, sig_mat.dtype, index_kind, len(sigs),
                       n_shards=_mesh_size(computing))
    with timer.stage("index_insert"):
        index.insert(sig_mat)
    assert index.nb_points == len(seqdict), "seqdict/index size mismatch"
    state = ProcessingState(
        nb_seq=len(seqdict),
        nb_file=len({i.id.path for i in seqdict}),
        elapsed_t=time.time() - t0,
    )
    with timer.stage("dump"):
        dumpall(out_dir, index, seqdict, params, state)
    report = timer.report()
    log.info("build done: %d points in %.1fs %s", index.nb_points, time.time() - t0, report)
    return {"nb_points": index.nb_points, "elapsed_s": time.time() - t0, "stages": report}


def _migrate_flat_if_needed(index, params: ProcessingParams, n_after: int):
    """`add` growth guard: a flat DB pushed past the flat auto-limit is
    converted to an hnsw index (bulk build over the existing signatures)
    before the new points go in.  Without this, a flat DB grown by
    repeated adds would eventually build an MxuSearcher whose compact
    representations exceed device memory (the reference has no
    analogous cliff because hnsw_rs is always a graph, dnasketch.rs:139)."""
    from .index.flat import FlatIndex

    if not isinstance(index, FlatIndex):
        return index
    if n_after <= flat_auto_limit(params.sketch.sketch_size):
        return index
    log.info(
        "flat database would grow to %d points (> auto-limit %d at s=%d): "
        "converting to hnsw before the add",
        n_after, flat_auto_limit(params.sketch.sketch_size),
        params.sketch.sketch_size)
    new = _new_index(params, index.sig_dtype, "hnsw", nb_hint=n_after)
    new.insert(index.get_sigs())
    return new


def add_to_database(db_dir: str, new_dir: str, computing: ComputingParams | None = None) -> dict:
    """add: incremental insertion, parameters reloaded from the database
    (reference: SURVEY.md §3.3 — ids continue from seqdict length)."""
    computing = computing or ComputingParams()
    params = ProcessingParams.reload_json(db_dir)
    seqdict = SeqDict.reload_json(db_dir)
    state = ProcessingState.reload_json(db_dir)
    index = load_index(db_dir)
    assert index.nb_points == len(seqdict)
    timer = StageTimer()
    t0 = time.time()
    sigs = _sketch_dir(new_dir, params, computing, seqdict, timer)
    index = _migrate_flat_if_needed(index, params, len(seqdict))
    with timer.stage("index_insert"):
        index.insert(np.stack(sigs))
    assert index.nb_points == len(seqdict)
    state.nb_seq = len(seqdict)
    state.nb_file = len({i.id.path for i in seqdict})
    state.elapsed_t += time.time() - t0
    with timer.stage("dump"):
        dumpall(db_dir, index, seqdict, params, state)
    log.info("add done: now %d points (+%d) %s", index.nb_points, len(sigs),
             timer.report())
    return {"nb_points": index.nb_points, "added": len(sigs)}


def request_database(
    db_dir: str,
    req_dir: str,
    nb_answers: int,
    computing: ComputingParams | None = None,
    out_dir: str = ".",
    ef_search: int = EF_SEARCH,
) -> dict:
    """request: batched k-NN of query genomes against a reloaded database
    (reference call stack: SURVEY.md §3.2)."""
    computing = computing or ComputingParams()
    params = ProcessingParams.reload_json(db_dir)
    seqdict = SeqDict.reload_json(db_dir)
    index = load_index(db_dir)
    timer = StageTimer()
    req_dict = SeqDict()
    sigs = _sketch_dir(req_dir, params, computing, req_dict, timer)
    with timer.stage("search"):
        from .index.sharded import ShardedHnswIndex

        nd = None if computing.mesh_devices < 0 else computing.mesh_devices
        if computing.mesh_devices and isinstance(index, ShardedHnswIndex):
            # graph-sharded mesh search: every device traverses its own
            # subgraph, per-shard top-k merges in one all_gather
            from .parallel.mesh import MeshGraphSearcher

            try:
                searcher = MeshGraphSearcher(index, n_devices=nd)
                dists, ids = searcher.search(
                    np.stack(sigs), knbn=nb_answers, ef_search=ef_search)
            except ValueError as e:  # shard/device mismatch
                log.warning("mesh graph search unavailable (%s); "
                            "searching shards sequentially", e)
                searcher = index
                dists, ids = index.search(
                    np.stack(sigs), knbn=nb_answers, ef_search=ef_search)
        elif computing.mesh_devices:
            # row-shard the database over the mesh and merge per-shard
            # top-k in one all_gather — the first-class form of the
            # reference's multiple_search.sh (exact, so ef_search is moot).
            # On an accelerator at GEMM scale every device scores its
            # shard with the compact int8 estimator + local rerank
            # (near-exact) instead of the compare sweep
            from .index.flat import FlatIndex
            from .parallel.mesh import MeshMxuSearcher, MeshSearcher
            from .utils import device_profile

            db_sigs = index.get_sigs()
            if (device_profile().accelerated
                    and db_sigs.shape[0] >= FlatIndex.MXU_MIN_POINTS):
                searcher = MeshMxuSearcher(db_sigs, n_devices=nd)
            else:
                searcher = MeshSearcher(db_sigs, n_devices=nd)
            dists, ids = searcher.search(np.stack(sigs), knbn=nb_answers)
        else:
            searcher = index
            dists, ids = index.search(np.stack(sigs), knbn=nb_answers, ef_search=ef_search)
    log.info("request searched with %s", type(searcher).__name__)

    matcher = Matcher(threshold=OUT_THRESHOLD)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, NEIGHBORS_FILE)
    nb_match = 0
    with open(out_path, "w") as out:
        out.write(f" query dir : {req_dir}")
        for rank, item in enumerate(req_dict):
            nbrs = [Neighbour(int(i), float(d)) for d, i in zip(dists[rank], ids[rank])]
            ans = ReqAnswer(rank=rank, req_item=item, neighbours=nbrs)
            nb_match += ans.dump(seqdict, OUT_THRESHOLD, out)
            if not params.block_flag:
                for n in nbrs:
                    if n.distance < OUT_THRESHOLD:
                        matcher.insert_sequence_match(item, seqdict[n.d_id], n.distance)
    if not params.block_flag:
        with open(os.path.join(out_dir, MATCHES_FILE), "w") as out:
            matcher.analyze(out)
    log.info("request done: %d requests, %d matches -> %s %s", len(req_dict),
             nb_match, out_path, timer.report())
    return {
        "nb_requests": len(req_dict),
        "nb_matches": nb_match,
        "neighbors_file": out_path,
        "searcher": type(searcher).__name__,
        "stages": timer.report(),
    }
