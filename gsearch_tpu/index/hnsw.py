"""ANN graph index built and searched on the device (the reference's HNSW role).

Capability-equivalent of hnsw_rs as used by the reference
(Hnsw::new / modify_level_scale / parallel_insert / parallel_search;
reference: src/dna/dnasketch.rs:139-160,435, src/dna/dnarequest.rs:353) —
re-designed for batched accelerator execution rather than translated:

* The multi-layer hierarchy exists only to pick good entry points; the
  reference itself recommends collapsing it (--scale_modify_f 0.25 =>
  ~1 layer "HubNSW", README.md:118, arXiv 2412.01940).  Here the upper
  layers are replaced by an *entry tier*: a deterministic sample of nodes
  searched exactly with the dense distance kernel — one dense compare
  sweep instead of pointer-chasing.  `scale_modification` scales the tier
  size (smaller scale -> relatively more entry points -> flatter search),
  preserving the knob's spirit.
* The base layer is one flat int32 neighbor array [N, M0] on device, traversed
  by *batched multi-query beam search*: every hop expands E beam nodes per
  query, gathers their neighbor ids, de-duplicates against a per-query
  visited ring with vectorized compares (no hash sets), computes distances
  on a signature prefix, and merges via lax.top_k.  All control flow is a
  fixed-trip scan — XLA-compilable, no data-dependent shapes.
* Search runs on a signature *prefix* (slots are iid Jaccard estimators, so
  a prefix is just a smaller sketch); the top candidates are re-ranked
  against full signatures (on device when they fit its memory, on host
  otherwise).  This cuts traversal gather bandwidth ~S/prefix times.

Construction is layer-free batched insertion with ALL graph state resident
on device for the whole build (uploads per batch are the new prefix rows +
a few MB of link updates — the full signature matrix never round-trips):

  jit A (_insert_search): beam-search the current graph for each batch
      member, merge batch-mates in as candidates via a dense block, compute
      the candidate pairwise-distance block, and run the batched
      SELECT-NEIGHBORS-HEURISTIC (the reference enables the
      extend-candidates flavor, dnasketch.rs:159) — returns [B, C] id /
      distance / keep arrays.
  host: vectorized forward-link selection (kept-first stable ordering) and
      reverse-link grouping (sort triples by target, cap incoming per
      target) — pure numpy, no per-row Python loops.
  jit B (_insert_apply): writes the new neighbor rows and merges reverse
      links into their targets (gather rows -> concat incoming -> top-M0 by
      cached link distance -> scatter rows back).

Per-link distances are cached in a [N, M0] array (device during build,
persisted in the graph file) so reverse-link pruning never recomputes
signature distances — the reference's insert recomputes them per link
(hnsw_rs's point-distance calls); here that would be a gather storm.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.distance import eq_to_dist, gather_eqcount
from ..utils import device_profile, get_logger

log = get_logger(__name__)

_PAD = -1  # host-side padding for absent neighbors

# device rerank tiers must fit this share of one device's memory (the rest
# holds the prefix, the graph and the search workspace);
# GSEARCH_TPU_RERANK_DEVICE_BYTES, or setting _RERANK_DEVICE_BYTES, overrides
_RERANK_DEVICE_FRACTION = 0.8125
_RERANK_DEVICE_BYTES = (int(os.environ["GSEARCH_TPU_RERANK_DEVICE_BYTES"])
                        if "GSEARCH_TPU_RERANK_DEVICE_BYTES" in os.environ
                        else None)


def _rerank_device_bytes() -> int:
    if _RERANK_DEVICE_BYTES is not None:
        return _RERANK_DEVICE_BYTES
    return device_profile().budget(_RERANK_DEVICE_FRACTION)


def _forward_rows(cand_ids, cand_d, keep, *, base, valid_limit, n_total,
                  m0, m_near, sent, b_real):
    """Vectorized forward-link selection for a batch of points with ids
    base..base+B (shared by the incremental insert and the bulk build).

    Partitioned rows:
      near region [0, m_near): nearest candidates by distance (pruned ones
        included — local recall needs dense short links),
      far region [m_near, m0): heuristic SURVIVORS beyond the near cutoff —
        the diverse long links that keep dense clusters reachable.  A plain
        nearest-only fill measurably disconnects clusters (262k recall
        collapsed to the entry tier's cluster-coverage rate); the reference
        relies on the same heuristic with keeping_pruned(false),
        dnasketch.rs:159-160.
      tail: degree-4 pseudo-random long links (golden-stride in the node
        id) — connectivity insurance when a candidate pool sits entirely
        inside one dense cluster."""
    B = cand_ids.shape[0]
    cand_d = np.array(cand_d)
    # invalidate pad-mates (ids beyond the live set) and self refs
    cand_d[cand_ids >= valid_limit] = np.inf
    finite = np.isfinite(cand_d)
    good = keep & finite
    rows_ids = np.full((B, m0), sent, dtype=np.int32)
    rows_d = np.full((B, m0), np.inf, dtype=np.float32)
    fin_rank = np.cumsum(finite, axis=1) - 1
    near_take = finite & (fin_rank < m_near)
    r_i, _ = np.nonzero(near_take)
    rows_ids[r_i, fin_rank[near_take]] = cand_ids[near_take]
    rows_d[r_i, fin_rank[near_take]] = cand_d[near_take]
    m_far = m0 - m_near
    beyond = finite & (fin_rank >= m_near)
    # far slots: heuristic survivors beyond the cutoff first (the long
    # links), then next-nearest pruned candidates to keep the local graph
    # dense when few survivors exist
    key = np.where(beyond & good, np.int8(0),
                   np.where(beyond, np.int8(1), np.int8(2)))
    o2 = np.argsort(key, axis=1, kind="stable")
    far_ids = np.take_along_axis(cand_ids, o2, axis=1)[:, :m_far]
    far_d = np.take_along_axis(cand_d, o2, axis=1)[:, :m_far]
    far_ok = np.take_along_axis(key < 2, o2, axis=1)[:, :m_far]
    rows_ids[:, m_near:] = np.where(far_ok, far_ids, sent)
    rows_d[:, m_near:] = np.where(far_ok, far_d.astype(np.float32), np.inf)
    rl = min(4, m_far)
    me_col = (base + np.arange(B, dtype=np.uint64))[:, None]
    jj = np.arange(1, rl + 1, dtype=np.uint64)[None, :]
    rnd = ((me_col * np.uint64(0x9E3779B1) + jj * np.uint64(0x85EBCA77))
           % np.uint64(n_total)).astype(np.int32)
    rnd = np.where(rnd == (base + np.arange(B))[:, None],
                   (rnd + 1) % n_total, rnd)
    rows_ids[:, m0 - rl:] = rnd
    rows_d[:, m0 - rl:] = np.inf
    if b_real < B:
        rows_ids[b_real:] = sent
        rows_d[b_real:] = np.inf
    return rows_ids, rows_d


def _group_reverse(rows_ids, rows_d, *, base, b_real, mmax, rin, sent):
    """Group a batch's reverse links by target: sorted (target, dist)
    triples, capped at `rin` incoming per target (the merge keeps the
    nearest by cached link distance downstream)."""
    B, _ = rows_ids.shape
    me = (base + np.arange(B, dtype=np.int32))[:, None]
    valid = (rows_ids != sent) & (me < base + b_real)
    # reverse only the closest `max_nb_conn` forward links (layer-0
    # reverse degree pressure control, matching hnsw_rs's m)
    valid[:, mmax:] = False
    tgt = rows_ids[valid]
    src = np.broadcast_to(me, rows_ids.shape)[valid]
    dd = rows_d[valid]
    ub = B * mmax
    inc_tgt = np.full(ub, sent, np.int32)
    inc_ids = np.full((ub, rin), sent, np.int32)
    inc_d = np.full((ub, rin), np.inf, np.float32)
    if tgt.size:
        o = np.lexsort((dd, tgt))
        tgt, src, dd = tgt[o], src[o], dd[o]
        first = np.empty(len(tgt), bool)
        first[0] = True
        np.not_equal(tgt[1:], tgt[:-1], out=first[1:])
        seg = np.cumsum(first) - 1
        seg_start = np.flatnonzero(first)
        rank = np.arange(len(tgt)) - seg_start[seg]
        sel = rank < rin
        u = int(seg[-1]) + 1
        inc_tgt[:u] = tgt[first]
        inc_ids[seg[sel], rank[sel]] = src[sel]
        inc_d[seg[sel], rank[sel]] = dd[sel]
    return inc_tgt, inc_ids, inc_d


def _global_reverse_merge(rows_all: np.ndarray, rowsd_all: np.ndarray, *,
                          base_src: int, rin: int, mmax: int, m_near: int,
                          sent: int) -> None:
    """One capped host-vectorized reverse merge: every forward link
    (src -> tgt) of rows src >= base_src becomes a candidate back-link
    (tgt -> src), merged into tgt's near region by distance with dup
    suppression.  Mutates rows_all/rowsd_all in place.  Shared by the bulk
    constructor (base_src=0: all rows are sources) and the bulk append
    path (base_src=n0: only the new rows contribute sources — existing
    links are already mutual from their own build)."""
    tgt = rows_all[base_src:, :mmax].ravel()
    dd = rowsd_all[base_src:, :mmax].ravel()
    src = np.repeat(np.arange(base_src, rows_all.shape[0], dtype=np.int32), mmax)
    ok = (tgt != sent) & np.isfinite(dd)
    tgt, dd, src = tgt[ok], dd[ok], src[ok]
    if not tgt.size:
        return
    o = np.lexsort((dd, tgt))
    tgt, dd, src = tgt[o], dd[o], src[o]
    first = np.empty(len(tgt), bool)
    first[0] = True
    np.not_equal(tgt[1:], tgt[:-1], out=first[1:])
    seg = np.cumsum(first) - 1
    seg_start = np.flatnonzero(first)
    rank = np.arange(len(tgt)) - seg_start[seg]
    sel = rank < rin
    u = int(seg[-1]) + 1
    inc_tgt = tgt[first]
    inc_ids = np.full((u, rin), sent, np.int32)
    inc_d = np.full((u, rin), np.inf, np.float32)
    inc_ids[seg[sel], rank[sel]] = src[sel]
    inc_d[seg[sel], rank[sel]] = dd[sel]
    for cstart in range(0, u, 65536):  # chunk the [U, rin, m_near] dup mask
        ct = inc_tgt[cstart : cstart + 65536]
        ci = inc_ids[cstart : cstart + 65536]
        cdv = inc_d[cstart : cstart + 65536].copy()
        ex_ids = rows_all[ct, :m_near]
        ex_d = rowsd_all[ct, :m_near]
        dup = (ci[:, :, None] == ex_ids[:, None, :]).any(-1)
        cdv[dup] = np.inf
        comb_ids = np.concatenate([ex_ids, ci], axis=1)
        comb_d = np.concatenate([ex_d, cdv], axis=1)
        oc = np.argsort(comb_d, axis=1, kind="stable")[:, :m_near]
        mids = np.take_along_axis(comb_ids, oc, 1)
        md = np.take_along_axis(comb_d, oc, 1)
        mids = np.where(np.isfinite(md), mids, sent)
        rows_all[ct, :m_near] = mids
        rowsd_all[ct, :m_near] = md


def _next_pow2(n: int, floor: int = 16) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def load_sigs_npy_with_headroom(path: str):
    """Read a signature .npy STRAIGHT into a capacity buffer with ~12.5%
    append headroom: one disk read, zero extra copies.  np.load + a later
    capacity migration would re-copy the whole matrix (25 GB at 524k x
    12000) on the first post-reload `add`.  Returns (buf, n)."""
    from ..io.npyio import npy_read_with_headroom

    return npy_read_with_headroom(path)


def _as_u32(x: np.ndarray) -> np.ndarray:
    """Bit-pattern view so one compare kernel serves f32/u32/u16/i32 sigs."""
    if x.dtype == np.float32:
        return x.view(np.uint32)
    if x.dtype in (np.uint32, np.int32):
        return x.view(np.uint32)
    return x.astype(np.uint32)


def _pad_cols_ones(q, spad: int):
    """Device column-pad with 1s (db column pads are 0: never equal)."""
    if q.shape[1] >= spad:
        return q
    return jnp.concatenate(
        [q, jnp.ones((q.shape[0], spad - q.shape[1]), jnp.uint32)], axis=1)


class HnswIndex:
    KIND = "hnsw"

    #: search-time beam width when the caller does not pass ef_search
    #: (a throughput point with recall margin on the 262k recall curve).
    DEFAULT_EF = 256
    #: beam nodes expanded per hop (E); hops scale as ef / E.
    EXPAND = 4

    def __init__(
        self,
        sketch_size: int,
        sig_dtype,
        max_nb_conn: int = 64,
        ef_construction: int = 200,
        scale_modification: float = 1.0,
        capacity: int = 0,
        search_prefix: int = 1024,
    ):
        self.sketch_size = sketch_size
        self.sig_dtype = np.dtype(sig_dtype)
        self.max_nb_conn = int(max_nb_conn)
        self.m0 = 2 * self.max_nb_conn  # base-layer degree, HNSW convention
        self.ef_construction = int(ef_construction)
        self.scale_modification = float(scale_modification)
        self.search_prefix = min(search_prefix, sketch_size)
        self.entry_tier_mult = self.ENTRY_MULT
        self._sigs = np.empty((0, sketch_size), dtype=self.sig_dtype)
        self._nbrs = np.empty((0, self.m0), dtype=np.int32)
        self._nbr_d = np.empty((0, self.m0), dtype=np.float32)
        self._entry_ids = np.empty((0,), dtype=np.int32)
        # permanently-pinned entry ids: points whose nearest pre-existing
        # neighbor at add time was ~max distance (novel cluster — graph
        # navigation has no gradient toward them, so the exact-swept entry
        # tier must cover them directly)
        self._pinned = np.empty((0,), dtype=np.int32)
        self._device = None       # (sigs_p, nbrs_p, entries) for search
        self._device_full = None  # [nb+1, S] full sigs for device rerank
        self._device_packed = None  # (w, [nb+1, 8, w/16]) 16-bit-hash rerank
        self._coarse = None  # MxuSearcher over the prefix (False: won't fit)
        # upload-once prefix cache: (n_valid, [n_valid, sp] u32 on device).
        # Bulk adds extend it with a device concat (only the NEW rows are
        # uploaded); _coarse_searcher consumes it after a build/add so the
        # serving searcher inits with zero host traffic.
        self._prefix_dev = None
        # geometric capacity buffer backing self._sigs (vector-style):
        # np.concatenate re-copies the WHOLE matrix on every append — 27 GB
        # at 524k x 12000 — so appends write into spare capacity instead
        self._sigs_buf = None

    # ------------------------------------------------------------------ basics

    @property
    def nb_points(self) -> int:
        return self._sigs.shape[0]

    def get_nb_point(self) -> int:
        return self.nb_points

    def get_sigs(self) -> np.ndarray:
        return self._sigs

    def adopt_sig_buffer(self, buf: np.ndarray, n: int) -> None:
        """Install a caller-built capacity buffer whose first n rows are
        the live signatures.  Load paths use this (with append headroom,
        see load_sigs_npy_with_headroom) so a reloaded database's first
        `add` does not pay a whole-matrix migration copy (25 GB of host
        memcpy and page faults at 524k x 12000)."""
        assert buf.shape[0] >= n and buf.shape[1] == self.sketch_size
        self._sigs_buf = buf
        self._sigs = buf[:n]

    def _append_sigs(self, new: np.ndarray) -> None:
        """Append rows to the signature matrix in amortized O(new).

        `np.concatenate` re-copies the whole matrix every append — the
        27 GB copy at 524k x 12000 was 80% of warm bulk-add wall-clock.
        Keep a capacity buffer with ~12.5% headroom and slice-view the
        live prefix; externally-assigned `_sigs` (load paths, tests) just
        pay one migration copy on their first append."""
        n0 = self._sigs.shape[0]
        n1 = n0 + new.shape[0]
        buf = self._sigs_buf
        # reuse only when _sigs is the buffer's row-0 prefix view: a
        # non-zero-offset view (a future compaction path) must migrate,
        # or the append would land at the wrong rows and resurrect
        # dropped ones via buf[:n1]
        if not (buf is not None
                and (self._sigs is buf or self._sigs.base is buf)
                and self._sigs.ctypes.data == buf.ctypes.data
                and buf.shape[0] >= n1
                and buf.shape[1] == self.sketch_size):
            cap = n1 + max(n1 >> 3, 4096)
            buf = np.empty((cap, self.sketch_size), self.sig_dtype)
            buf[:n0] = self._sigs
            self._sigs_buf = buf
        buf[n0:n1] = new  # assignment casts; no astype() staging copy
        self._sigs = buf[:n1]

    def _sigs_fp(self) -> int:
        """Cheap content fingerprint of the host signature matrix (first/
        middle/last row).  Guards the _prefix_dev cache against external
        reassignment of `_sigs` with the same row count (benches and tests
        assign `_sigs` directly) — row count alone would let _bulk_add
        link new points against stale device signatures."""
        import zlib

        n = self._sigs.shape[0]
        if n == 0:
            return 0
        fp = 0
        for r in (0, n // 2, n - 1):
            fp = zlib.crc32(np.ascontiguousarray(self._sigs[r]).tobytes(), fp)
        return fp

    #: entry-tier sizing multiplier (env GSEARCH_TPU_ENTRY_MULT overrides;
    #: exposed for benchmark sweeps)
    ENTRY_MULT = float(os.environ.get("GSEARCH_TPU_ENTRY_MULT", "1"))

    def _entry_tier_size(self, n: int) -> int:
        if n <= 0:
            return 0
        # The tier replaces the HNSW upper layers, and must SCALE like
        # them: hnsw_rs holds ~N/m points above layer 0 (geometric level
        # sampling), so a sqrt(N) tier starves navigation at 262k+ (512
        # entries for ~2k natural clusters measured recall@10 = 0.46; a
        # N/64 tier restores >= 0.99 — see STATUS.md).  The exact tier
        # sweep is one dense compare scan, so even 65536 entries are cheap.
        # Small scale_modification (HubNSW direction) widens the tier.
        base = max(math.sqrt(n), n / 64.0) / max(self.scale_modification, 0.2)
        base *= self.entry_tier_mult
        return int(min(n, max(16, base), 65536))

    def _entries_for(self, n: int) -> np.ndarray:
        t = self._entry_tier_size(n)
        if t == 0:
            return np.empty((0,), dtype=np.int32)
        # deterministic golden-stride sample: an arange stride can alias
        # with the corpus layout (e.g. cluster-contiguous generation gives
        # one entry every k-th CLUSTER and recall collapses to the covered
        # fraction); the Fibonacci-hash stride is order-free
        idx = (np.arange(t, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(n)
        pins = self._pinned[self._pinned < n]
        if pins.size:
            return np.unique(np.concatenate([idx.astype(np.int32), pins]))
        return np.unique(idx.astype(np.int32))

    def _refresh_entries(self) -> None:
        self._entry_ids = self._entries_for(self.nb_points)

    # ------------------------------------------------------------------ build

    #: fresh builds at least this large route through the bulk MXU-sweep
    #: constructor (env GSEARCH_TPU_BULK_MIN overrides)
    BULK_MIN = int(os.environ.get("GSEARCH_TPU_BULK_MIN", "32768"))

    #: novelty threshold for entry pinning: a point whose nearest
    #: pre-existing neighbor is at >= PIN_D joins the entry tier for good
    PIN_D = float(os.environ.get("GSEARCH_TPU_PIN_D", "0.98"))

    def insert(self, sigs: np.ndarray, batch_size: int = 1024,
               capacity: int = 0, progress=None, bulk: bool | None = None) -> None:
        """Batched graph construction (role of parallel_insert,
        dnasketch.rs:426-436).  All graph state stays on device across the
        whole call; only candidate lists and link updates cross to the host.

        `capacity` (like Hnsw::new's, dnasketch.rs:139) pre-sizes the
        compiled programs: chunked/incremental inserts up to that many
        points all reuse one compilation.  `progress(rows_done, total)` is
        called after each applied batch (benchmark instrumentation).

        Fresh builds of >= BULK_MIN points take the bulk path (exact MXU
        kNN sweep -> heuristic links, _build_bulk); appends of >=
        BULK_ADD_MIN points into an existing graph take the bulk append
        path (_bulk_add).  bulk=False forces beam inserts; smaller appends
        always use them."""
        sigs = np.ascontiguousarray(sigs, dtype=self.sig_dtype)
        m = sigs.shape[0]
        if m == 0:
            return
        n0 = self.nb_points
        if bulk is None:
            bulk = m >= (self.BULK_MIN if n0 == 0 else self.BULK_ADD_MIN)
        if bulk:
            if n0 == 0:
                return self._build_bulk(sigs, progress=progress)
            return self._bulk_add(sigs, progress=progress)
        n_total = n0 + m
        B = min(_next_pow2(max(batch_size, 64)), _next_pow2(m))
        cap = _next_pow2(max(n_total, capacity))
        sent = cap + B  # sentinel row index; pad-batch rows live in [cap, sent)
        sp = self.search_prefix
        m0 = self.m0
        mmax = self.max_nb_conn

        # static knobs, derived from the CAPACITY so every batch of this
        # call (and any same-bucket later call) reuses one compiled program
        ef_build = _round_up(min(max(self.ef_construction, 64), max(2 * m0, 64), cap), 64)
        C = min(_round_up(min(2 * m0, ef_build + B), 32), ef_build + B)
        expand = self.EXPAND
        hops = max(4, int(2 * math.log2(cap)) + ef_build // (2 * expand))
        tb = _next_pow2(max(self._entry_tier_size(sent), 16))
        rin = 4  # incoming reverse links kept per target per batch
        # row partition: reverse merges may only touch the near region;
        # the far region holds the heuristic's diverse long links, which
        # keep dense clusters connected to the rest of the graph (a pure
        # distance-eviction merge would crowd them out again)
        m_near = max(m0 - max(m0 // 4, min(8, m0 // 2)), rin)

        # --- device-resident build state ------------------------------------
        sigs_p = np.full((sent + 1, sp), 0xFFFFFFFF, np.uint32)
        sigs_p[:n0] = _as_u32(self._sigs[:, :sp])
        nbrs = np.full((sent + 1, m0), sent, np.int32)
        if n0:
            nbrs[:n0] = np.where(self._nbrs == _PAD, sent, self._nbrs)
        nbr_d = np.full((sent + 1, m0), np.inf, np.float32)
        if n0:
            self._ensure_nbr_d()
            nbr_d[:n0] = self._nbr_d
        d_sigs = jnp.asarray(sigs_p)
        d_nbrs = jnp.asarray(nbrs)
        d_nbrd = jnp.asarray(nbr_d)
        del sigs_p, nbrs, nbr_d

        sigs_u32 = _as_u32(sigs[:, :sp])
        n = n0
        for start in range(0, m, B):
            b_real = min(B, m - start)
            q_p = np.full((B, sp), 0xFFFFFFFF, np.uint32)
            q_p[:b_real] = sigs_u32[start : start + b_real]
            entries = np.full(tb, sent, np.int32)
            e = self._entries_for(n)
            if len(e) > tb:  # pinned entries can exceed the compiled buffer
                e = e[np.linspace(0, len(e) - 1, tb).astype(np.int64)]
            entries[: len(e)] = e

            d_sigs, cand_ids, cand_d, keep = _insert_search(
                d_sigs, d_nbrs, jnp.asarray(entries), jnp.asarray(q_p), jnp.int32(n),
                ef=ef_build, C=C, hops=hops, expand=expand,
            )
            cand_ids = np.asarray(cand_ids)
            cand_d = np.array(cand_d)  # writable copy (pad-mates masked below)
            keep = np.asarray(keep)

            rows_ids, rows_d = _forward_rows(
                cand_ids, cand_d, keep, base=n, valid_limit=n + b_real,
                n_total=n_total, m0=m0, m_near=m_near, sent=sent,
                b_real=b_real)
            inc_tgt, inc_ids, inc_d = _group_reverse(
                rows_ids, rows_d, base=n, b_real=b_real, mmax=mmax, rin=rin,
                sent=sent)

            # reachability guarantee: nearest PRE-BATCH candidate of each
            # new point gets a forced back-link (see _insert_apply).  Old
            # ids only — a batch-mate target could close an unreachable
            # cycle inside a novel cluster.
            old_ok = (cand_ids < n) & np.isfinite(cand_d)
            # spread targets over the 16 nearest old candidates by source
            # id: when a whole novel cluster ties at distance 1.0 to every
            # old point, identical "nearest" picks would collide on one
            # row+slot and all but one forced link would be lost
            cum = np.cumsum(old_ok, axis=1)
            k_old = cum[:, -1]
            has_old = k_old > 0
            brow = np.arange(B)
            pick = (n + brow) % np.minimum(np.maximum(k_old, 1), 16) + 1
            fcol = np.argmax(cum == pick[:, None], axis=1)
            live = has_old & (brow < b_real)
            f_tgt = np.where(live, cand_ids[brow, fcol], sent).astype(np.int32)
            f_src = np.where(live, n + brow, sent).astype(np.int32)
            f_d = np.where(live, cand_d[brow, fcol], np.inf).astype(np.float32)

            # entry pinning: when a point's nearest PRE-EXISTING neighbor
            # is ~max distance, greedy navigation has no gradient toward
            # it (all paths tie) — back-links alone cannot make it
            # findable.  Pin the FIRST member of each such novel cluster
            # as a permanent exact-swept entry; its batch-mates connect to
            # it through the dense mate block, so one pin covers the
            # cluster.  hnsw_rs has the same blind spot (nothing funnels a
            # search toward an isolated region); the exact entry tier lets
            # us fix it outright.
            f_near = np.where(has_old, cand_d[brow, np.argmax(old_ok, 1)],
                              np.inf)
            novel = (brow < b_real) & (f_near >= self.PIN_D)
            mate_lt = ((cand_ids >= n) & (cand_ids < n + brow[:, None])
                       & (cand_d < self.PIN_D))
            new_pins = (n + brow)[novel & ~mate_lt.any(axis=1)]
            if new_pins.size:
                self._pinned = np.unique(
                    np.concatenate([self._pinned, new_pins.astype(np.int32)]))

            d_nbrs, d_nbrd = _insert_apply(
                d_nbrs, d_nbrd,
                jnp.asarray(rows_ids), jnp.asarray(rows_d), jnp.int32(n),
                jnp.asarray(inc_tgt), jnp.asarray(inc_ids), jnp.asarray(inc_d),
                jnp.asarray(f_tgt), jnp.asarray(f_src), jnp.asarray(f_d),
                m_near=m_near, rl=min(4, m0 - m_near),
            )
            n += b_real
            if progress is not None:
                progress(n - n0, m)

        # ---- sync host mirrors, free device build state ---------------------
        nbrs_h = np.asarray(d_nbrs)[:n_total]
        nbrd_h = np.asarray(d_nbrd)[:n_total]
        self._nbrs = np.where(nbrs_h >= n_total, _PAD, nbrs_h).astype(np.int32)
        self._nbr_d = np.where(nbrs_h >= n_total, np.inf, nbrd_h).astype(np.float32)
        self._rescue_orphans(self._nbrs, self._nbr_d,
                             rl=min(4, m0 - m_near))
        self._append_sigs(sigs)
        del d_sigs, d_nbrs, d_nbrd
        self._refresh_entries()
        self._device = None
        self._device_full = None
        self._device_packed = None
        self._coarse = None
        self._prefix_dev = None

    def _build_bulk(self, sigs: np.ndarray, progress=None) -> None:
        """Bulk graph construction: exact-kNN MXU sweep -> heuristic links.

        The accelerator's answer to parallel graph build: brute-force
        all-pairs candidate generation is one int8 GEMM sweep (compact
        searcher over the signature PREFIX, ops/mxu.py — ~6 KB/row, so it
        scales to millions of rows on one device), while pointer-chasing
        beam inserts pay a device round trip per batch.  Three passes:

          A. exact top-C sweep (prefix metric) for every point,
          B. select-neighbors heuristic on device (_bulk_keep) + the same
             partitioned forward-row fill as the incremental path,
          C. one global host-vectorized reverse merge (incremental merges
             per batch; here all forward rows exist first, so a single
             capped merge per target suffices).

        Candidates are exact prefix-metric top-C versus the beam's
        approximate pool, so link quality is >= the incremental path's;
        `add` keeps growing the graph incrementally afterwards.
        Role of hnsw_rs parallel_insert (dnasketch.rs:426-436)."""
        from ..ops.mxu import MxuSearcher

        n_total = sigs.shape[0]
        sp = self.search_prefix
        m0, mmax = self.m0, self.max_nb_conn
        sent = _next_pow2(n_total)
        rin = 8  # single global merge -> keep more incoming than per-batch
        m_near = max(m0 - max(m0 // 4, min(8, m0 // 2)), 4)
        C = min(max(min(2 * m0, 512), m0), max(n_total - 1, 1))
        u_pref = np.ascontiguousarray(_as_u32(sigs[:, :sp]))
        # one host->device pass: the searcher's representations AND pass
        # B's gather source both derive from this buffer
        u_dev = jnp.asarray(u_pref)

        # ---- pass A: exact-kNN sweep (searcher resident alone) -------------
        searcher = MxuSearcher(u_dev, compact=True,
                               nb_cand=min(3 * C, n_total))
        knn_ids = np.empty((n_total, C), np.int32)
        knn_d = np.empty((n_total, C), np.float32)
        qb = 4096
        for start in range(0, n_total, qb):
            q = u_pref[start : start + qb]
            d, ids = searcher.search(q, knbn=min(C + 1, n_total))
            me = np.arange(start, start + q.shape[0], dtype=np.int32)[:, None]
            d = np.where(ids == me, np.inf, d)  # drop self
            o = np.argsort(d, axis=1, kind="stable")[:, :C]
            knn_ids[start : start + q.shape[0]] = np.take_along_axis(ids, o, 1)
            knn_d[start : start + q.shape[0]] = np.take_along_axis(d, o, 1)
            if progress is not None:
                progress(min(start + qb, n_total) // 2, n_total)
        del searcher

        # ---- pass B: heuristic keep + forward rows --------------------------
        d_sigs_p = u_dev
        rows_all = np.empty((n_total, m0), np.int32)
        rowsd_all = np.empty((n_total, m0), np.float32)
        kb = 1024 if n_total >= 1024 else _next_pow2(n_total, floor=16)
        for start in range(0, n_total, kb):
            b_real = min(kb, n_total - start)
            cid = np.zeros((kb, C), np.int32)
            cd = np.full((kb, C), np.inf, np.float32)
            cid[:b_real] = knn_ids[start : start + b_real]
            cd[:b_real] = knn_d[start : start + b_real]
            keep = np.asarray(_bulk_keep(d_sigs_p, jnp.asarray(cid),
                                         jnp.asarray(cd)))
            rows_ids, rows_d = _forward_rows(
                cid, cd, keep, base=start, valid_limit=n_total,
                n_total=n_total, m0=m0, m_near=m_near, sent=sent,
                b_real=b_real)
            rows_all[start : start + b_real] = rows_ids[:b_real]
            rowsd_all[start : start + b_real] = rows_d[:b_real]
            if progress is not None:
                progress((n_total + min(start + kb, n_total)) // 2, n_total)
        del d_sigs_p

        # ---- pass C: global reverse merge (host, vectorized) ----------------
        _global_reverse_merge(rows_all, rowsd_all, base_src=0, rin=rin,
                              mmax=mmax, m_near=m_near, sent=sent)
        self._rescue_orphans(rows_all, rowsd_all, rl=min(4, m0 - m_near))

        self._nbrs = np.where(rows_all >= n_total, _PAD, rows_all).astype(np.int32)
        self._nbr_d = np.where(rows_all >= n_total, np.inf,
                               rowsd_all).astype(np.float32)
        self._sigs = sigs
        self._refresh_entries()
        self._device = None
        self._device_full = None
        self._device_packed = None
        self._coarse = None
        self._prefix_dev = (n_total, u_dev, self._sigs_fp())
        if progress is not None:
            progress(n_total, n_total)

    #: appends at least this large route through the bulk MXU-sweep append
    #: path instead of per-batch beam inserts (env override for bench sweeps)
    BULK_ADD_MIN = int(os.environ.get("GSEARCH_TPU_BULK_ADD_MIN", "4096"))

    def _rescue_orphans(self, rows_all: np.ndarray, rowsd_all: np.ndarray,
                        rl: int) -> None:
        """Guarantee in-degree >= 1 for every point after a merge pass.

        Distance eviction in the reverse merge can strip EVERY incoming
        link of a point sitting in a dense tie cluster (its slots in all
        neighbors' near regions lose to strictly-closer arrivals) — the
        point keeps its outgoing links but becomes unreachable.  Two
        rounds of forced back-links (orphan -> its nearest forward
        neighbor's tail slot) fix the common case; anything still orphaned
        afterwards (forced links evicting each other) is pinned into the
        exact-swept entry tier, which makes it reachable outright."""
        n_total, m0 = rows_all.shape
        if rl <= 0:
            return
        for _ in range(2):
            valid = (rows_all >= 0) & (rows_all < n_total)  # host pad is -1
            deg = np.bincount(rows_all[valid], minlength=n_total)
            orph = np.flatnonzero(deg == 0)
            if orph.size == 0:
                return
            t = rows_all[orph, 0]
            ok = (t >= 0) & (t < n_total)
            orph, t = orph[ok], t[ok]
            if orph.size == 0:
                break
            d = rowsd_all[orph, 0]
            srl = (orph ^ (orph >> 4) ^ (orph >> 9)) % rl
            tail_d = rowsd_all[t, m0 - rl:]
            order = np.argsort(-tail_d, axis=1, kind="stable")
            slot = order[np.arange(len(orph)), srl] + (m0 - rl)
            rows_all[t, slot] = orph
            rowsd_all[t, slot] = d
        valid = (rows_all >= 0) & (rows_all < n_total)
        deg = np.bincount(rows_all[valid], minlength=n_total)
        orph = np.flatnonzero(deg == 0).astype(np.int32)
        if orph.size:
            self._pinned = np.unique(np.concatenate([self._pinned, orph]))

    def _bulk_add(self, sigs: np.ndarray, progress=None) -> None:
        """Bulk append into an existing graph: exact MXU kNN sweep of the
        new batch against (existing + batch), heuristic links for the new
        rows, one global reverse merge into the existing near regions.

        Same machinery as _build_bulk, seeded with the existing graph —
        the beam-insert path pays a device round trip per 1024-point batch,
        while this is three GEMM/host passes
        (reference role: dnasketch.rs:426-436, where add and build use the
        identical parallel_insert)."""
        import time as _time

        from ..ops.mxu import MxuSearcher

        t_last = _time.perf_counter()

        def _tick(stage):
            nonlocal t_last
            now = _time.perf_counter()
            log.info("bulk_add %s: %.1fs", stage, now - t_last)
            t_last = now

        n0 = self.nb_points
        m = sigs.shape[0]
        n_total = n0 + m
        sp = self.search_prefix
        m0, mmax = self.m0, self.max_nb_conn
        sent = _next_pow2(n_total)
        rin = 8
        m_near = max(m0 - max(m0 // 4, min(8, m0 // 2)), 4)
        C = min(max(min(2 * m0, 512), m0), max(n_total - 1, 1))
        new_u = _as_u32(np.ascontiguousarray(sigs[:, :sp], self.sig_dtype))
        cached = self._prefix_dev
        if (cached is not None and cached[0] == n0
                and cached[1].shape == (n0, sp)
                and cached[2] == self._sigs_fp()):
            # extend the resident prefix on device: only the NEW rows
            # are uploaded, not the whole base again
            u_dev = jnp.concatenate([cached[1], jnp.asarray(new_u)], 0)
        else:
            u_all = np.empty((n_total, sp), np.uint32)
            u_all[:n0] = _as_u32(self._sigs[:, :sp])
            u_all[n0:] = new_u
            u_dev = jnp.asarray(u_all)
            del u_all
        self._prefix_dev = None  # stale from here until re-seeded below
        _tick("prefix to device")

        # ---- pass A: exact top-C sweep for the NEW points only --------------
        searcher = MxuSearcher(u_dev, compact=True, nb_cand=min(3 * C, n_total))
        _tick("searcher init (expand)")
        knn_ids = np.empty((m, C), np.int32)
        knn_d = np.empty((m, C), np.float32)
        qb = 4096
        for start in range(0, m, qb):
            q = new_u[start : min(start + qb, m)]
            d, ids = searcher.search(q, knbn=min(C + 1, n_total))
            me = np.arange(n0 + start, n0 + start + q.shape[0],
                           dtype=np.int32)[:, None]
            d = np.where(ids == me, np.inf, d)  # drop self
            o = np.argsort(d, axis=1, kind="stable")[:, :C]
            knn_ids[start : start + q.shape[0]] = np.take_along_axis(ids, o, 1)
            knn_d[start : start + q.shape[0]] = np.take_along_axis(d, o, 1)
            if progress is not None:
                progress(min(start + qb, m) // 2, m)
        del searcher
        _tick("pass A (exact top-C sweep)")

        # entry pinning (same rule as the beam-insert path): a new point
        # whose nearest PRE-EXISTING neighbor is ~max distance is only
        # findable through the exact entry tier; pin the first member of
        # each such novel cluster
        grow = np.arange(n0, n_total, dtype=np.int32)
        old_ok = (knn_ids < n0) & np.isfinite(knn_d)
        has_old = old_ok.any(axis=1)
        f_near = np.where(has_old,
                          np.take_along_axis(
                              knn_d, np.argmax(old_ok, 1)[:, None], 1)[:, 0],
                          np.inf)
        mate_lt = ((knn_ids >= n0) & (knn_ids < grow[:, None])
                   & (knn_d < self.PIN_D))
        new_pins = grow[(f_near >= self.PIN_D) & ~mate_lt.any(axis=1)]
        if new_pins.size:
            self._pinned = np.unique(
                np.concatenate([self._pinned, new_pins.astype(np.int32)]))

        # ---- pass B: heuristic keep + forward rows for the new points -------
        self._ensure_nbr_d()
        rows_all = np.full((n_total, m0), sent, np.int32)
        rowsd_all = np.full((n_total, m0), np.inf, np.float32)
        rows_all[:n0] = np.where(self._nbrs == _PAD, sent, self._nbrs)
        rowsd_all[:n0] = self._nbr_d
        d_sigs_p = u_dev
        kb = 1024 if m >= 1024 else _next_pow2(m, floor=16)
        for start in range(0, m, kb):
            b_real = min(kb, m - start)
            cid = np.zeros((kb, C), np.int32)
            cd = np.full((kb, C), np.inf, np.float32)
            cid[:b_real] = knn_ids[start : start + b_real]
            cd[:b_real] = knn_d[start : start + b_real]
            keep = np.asarray(_bulk_keep(d_sigs_p, jnp.asarray(cid),
                                         jnp.asarray(cd)))
            rows_ids, rows_d = _forward_rows(
                cid, cd, keep, base=n0 + start, valid_limit=n_total,
                n_total=n_total, m0=m0, m_near=m_near, sent=sent,
                b_real=b_real)
            rows_all[n0 + start : n0 + start + b_real] = rows_ids[:b_real]
            rowsd_all[n0 + start : n0 + start + b_real] = rows_d[:b_real]
            if progress is not None:
                progress((m + min(start + kb, m)) // 2, m)
        del d_sigs_p
        _tick("pass B (keep + forward rows)")

        # ---- pass C: reverse merge, new rows as sources ---------------------
        _global_reverse_merge(rows_all, rowsd_all, base_src=n0, rin=rin,
                              mmax=mmax, m_near=m_near, sent=sent)
        _tick("pass C (reverse merge)")

        # reachability guarantee (same rule as _insert_apply): each new
        # point forces ONE back-link from a near pre-existing neighbor into
        # that row's tail slots — distance-only merging would evict every
        # back-link toward a cluster that is far from the whole old
        # database, leaving it unreachable
        rl = min(4, m0 - m_near)
        if rl > 0:
            cum = np.cumsum(old_ok, axis=1)
            k_old = cum[:, -1]
            has = k_old > 0
            # spread same-cluster sources over the 16 nearest old
            # candidates so forced links don't all collide on one target
            pick = (grow % np.minimum(np.maximum(k_old, 1), 16)) + 1
            fcol = np.argmax(cum == pick[:, None], axis=1)
            rowsel = np.flatnonzero(has)
            if rowsel.size:
                f_tgt = knn_ids[rowsel, fcol[rowsel]]
                f_src = grow[rowsel]
                f_d = knn_d[rowsel, fcol[rowsel]]
                tail_d = rowsd_all[f_tgt, m0 - rl:]
                order = np.argsort(-tail_d, axis=1, kind="stable")
                srl = (f_src ^ (f_src >> 4) ^ (f_src >> 9)) % rl
                slot = order[np.arange(len(f_src)), srl]
                tail_i = rows_all[f_tgt, m0 - rl:]
                here = tail_i == f_src[:, None]
                slot = np.where(here.any(1), np.argmax(here, 1), slot) + (m0 - rl)
                rows_all[f_tgt, slot] = f_src
                rowsd_all[f_tgt, slot] = f_d
        self._rescue_orphans(rows_all, rowsd_all, rl)
        _tick("rescue")

        self._nbrs = np.where(rows_all >= n_total, _PAD, rows_all).astype(np.int32)
        self._nbr_d = np.where(rows_all >= n_total, np.inf,
                               rowsd_all).astype(np.float32)
        _tick("row commit")
        self._append_sigs(sigs)
        _tick("sig append")
        self._refresh_entries()
        _tick("entry refresh")
        self._device = None
        self._device_full = None
        self._device_packed = None
        self._coarse = None
        self._prefix_dev = (n_total, u_dev, self._sigs_fp())
        if progress is not None:
            progress(m, m)

    def _ensure_nbr_d(self) -> None:
        """Backfill cached link distances (prefix metric) for graphs loaded
        from dumps that predate the cache."""
        n = self.nb_points
        if self._nbr_d.shape[0] == n:
            return
        log.warning("recomputing %d cached link distances (old dump format)", n)
        sp = self.search_prefix
        sigs = _as_u32(self._sigs[:, :sp])
        out = np.full((n, self.m0), np.inf, np.float32)
        for s in range(0, n, 4096):
            e = min(n, s + 4096)
            ids = self._nbrs[s:e]
            ok = ids != _PAD
            rows = sigs[np.clip(ids, 0, n - 1)]
            eq = (rows == sigs[s:e, None, :]).sum(-1)
            d = 1.0 - eq / np.float32(sp)
            out[s:e] = np.where(ok, d, np.inf)
        self._nbr_d = out

    # ------------------------------------------------------------------ search

    def _device_arrays(self):
        if self._device is None:
            n = self.nb_points
            nb = _next_pow2(n)
            sp = self.search_prefix
            sigs_p = np.full((nb + 1, sp), 0xFFFFFFFF, np.uint32)
            sigs_p[:n] = _as_u32(self._sigs[:, :sp])
            nbrs_p = np.full((nb + 1, self.m0), nb, np.int32)
            nbrs_p[:n] = np.where(self._nbrs == _PAD, nb, self._nbrs)
            t = len(self._entry_ids)
            entries = np.full(_next_pow2(max(t, 16)), nb, np.int32)
            entries[:t] = self._entry_ids
            self._device = (jnp.asarray(sigs_p), jnp.asarray(nbrs_p), jnp.asarray(entries))
        return self._device

    def _device_packed_sigs(self, w: int, bits: int = 16):
        """Hashed-slot rerank representation over the first `w` slots:
        bits=16 -> [nb+1, 8, w/16] u32 pair-packed 16-bit hashes (half the
        bytes of the full matrix; w <= S samples the slots when even that
        is too big), bits=8 -> [nb+1, 8, w/32] u32 four-packed 8-bit hashes
        (quarter the bytes — the full-width tier at 524k x 12000, see
        _pack_hash8).  Built in row chunks into a donated buffer — a
        concat would double peak device memory."""
        if (self._device_packed is not None
                and self._device_packed[:2] == (w, bits)):
            return self._device_packed[2]
        from ..ops.mxu import _pack_hash4, _pack_hash8, _pack_hash16

        n = self.nb_points
        nb = _next_pow2(n)
        wq = min(w, self.sketch_size)
        pack = {16: _pack_hash16, 8: _pack_hash8, 4: _pack_hash4}[bits]
        buf = jnp.zeros((nb + 1, 8, w // (256 // bits)), jnp.uint32)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def write(buf, rows_u32, start):
            p3 = pack(rows_u32, spad=w, pad_val=0)
            return jax.lax.dynamic_update_slice(
                buf, p3, (start, jnp.int32(0), jnp.int32(0)))

        src = _as_u32(self._sigs[:, :wq])
        step = min(8192, nb)  # nb is a power of two: uniform chunks, one jit
        for start in range(0, n, step):
            rows = np.zeros((step, wq), np.uint32)
            live = min(step, n - start)
            rows[:live] = src[start : start + live]
            buf = write(buf, jnp.asarray(rows), jnp.int32(start))
        self._device_packed = (w, bits, buf)
        return buf

    def _device_full_sigs(self):
        """Full signatures on device, [nb+1, 8, Sp/8] (the rows of the
        [nb+1, Sp] matrix; gather_eqcount reads either shape).  db column
        pads are 0, query pads 1: never an equal slot."""
        if self._device_full is None:
            n = self.nb_points
            nb = _next_pow2(n)
            sp = _round_up(self.sketch_size, 1024)  # tile-align ([8, Sp/8])
            full = np.zeros((nb + 1, sp), np.uint32)
            full[:n, : self.sketch_size] = _as_u32(self._sigs)
            self._device_full = jnp.asarray(full.reshape(nb + 1, 8, sp // 8))
        return self._device_full

    #: databases at least this large use the coarse int8-GEMM candidate
    #: path on an accelerator (exact prefix-metric top-r sweep via
    #: ops/mxu.py) instead of the beam, when its compact representation
    #: fits next to the rerank tier.  At 524k x 12000 the prefix top-160
    #: pool contained all oracle top-10 — end-to-end recall is set by the
    #: rerank tier's fidelity (_rerank_tier), at dense-matmul throughput
    #: where the beam pays dedup/merge work per hop.
    #: GSEARCH_TPU_FORCE_BEAM=1 overrides.
    COARSE_MIN = int(os.environ.get("GSEARCH_TPU_COARSE_MIN", "65536"))
    #: share of one device's memory for the coarse representation (leaves
    #: room for the packed/full rerank tier, whose own budget is
    #: _rerank_device_bytes()); COARSE_BYTES, when set, overrides
    COARSE_FRACTION = 0.40625
    COARSE_BYTES: int | None = (
        int(os.environ["GSEARCH_TPU_COARSE_BYTES"])
        if "GSEARCH_TPU_COARSE_BYTES" in os.environ else None)

    def _coarse_bytes(self) -> int:
        if self.COARSE_BYTES is not None:
            return self.COARSE_BYTES
        return device_profile().budget(self.COARSE_FRACTION)

    def _coarse_searcher(self):
        """Compact MxuSearcher over the signature PREFIX, or None."""
        if self._coarse is False:
            return None
        if self._coarse is None:
            from ..ops.mxu import MxuSearcher, planned_footprint

            sp = self.search_prefix
            n = self.nb_points
            # consume (don't keep: the rerank tier needs the memory) the
            # upload-once prefix left on device by a bulk build/add
            src = None
            if (self._prefix_dev is not None and self._prefix_dev[0] == n
                    and self._prefix_dev[1].shape == (n, sp)
                    and self._prefix_dev[2] == self._sigs_fp()):
                src = self._prefix_dev[1]
            self._prefix_dev = None

            def host_src():
                return np.ascontiguousarray(_as_u32(self._sigs[:, :sp]))

            _, rep = planned_footprint(n, sp)
            coarse_bytes = self._coarse_bytes()
            if rep > coarse_bytes:
                if sp >= self.sketch_size:
                    # no_rerank configs (search_prefix == full width) take
                    # the coarse output as FINAL distances/ids; the
                    # estimator's sign-dot ranking is biased and noisy, so
                    # it must never be terminal — use the beam, whose
                    # prefix metric IS exact here.
                    self._coarse = False
                    return None
                # the full rep (sign expansion + 16-bit prefix rerank
                # matrix) won't fit next to the rerank tier.  The prefix
                # rerank stage only sharpens POOL selection — final
                # ranking is the tier's job — so fall back to an
                # estimator-only searcher (sign expansion alone, m=4:
                # 4.3 GB at 1M) whose top-r IS the candidate pool.
                nb = _next_pow2(n)
                m_est = next((m for m in (4, 2, 1)
                              if nb * m * sp <= coarse_bytes), 0)
                if not m_est:
                    self._coarse = False
                    return None
                # compact=False: compact mode only halves m and picks the
                # rr3 format — with no rr3 built it must not override m
                self._coarse = MxuSearcher(
                    src if src is not None else host_src(),
                    m=m_est, compact=False, estimator_only=True)
                return self._coarse
            # explicit candidate width: 2048 estimator candidates feed the
            # exact-prefix top-r for any r <= 1024 (the knbn-proportional
            # default would be 8 x r)
            self._coarse = MxuSearcher(
                src if src is not None else host_src(),
                nb_cand=2048)
        return self._coarse

    def search(
        self, queries: np.ndarray, knbn: int, ef_search: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: coarse candidates on the signature prefix (int8
        GEMM sweep on an accelerator at scale, else entry tier + beam
        search) -> full-
        signature rerank of the top candidates.

        Returns (distances [Q, k], ids [Q, k]); parity with
        hnsw_rs parallel_search (dnarequest.rs:353)."""
        n = self.nb_points
        nq = queries.shape[0]
        if n == 0:
            return np.full((nq, 0), np.inf, np.float32), np.zeros((nq, 0), np.int32)
        knbn = min(knbn, n)
        queries = np.ascontiguousarray(queries, dtype=self.sig_dtype)

        if n <= 2048 or len(self._entry_ids) >= n:
            # tiny database: the entry tier is the whole database
            from ..ops.distance import bucketed_knn

            return bucketed_knn(queries, self._sigs, knbn)

        # one staging upload; every query form (beam prefix, rerank pads,
        # packed hashes) derives on device in search_device
        qb = _next_pow2(nq, floor=8)
        qbuf = np.full((qb, self.sketch_size), 0xFFFFFFFF, np.uint32)
        qbuf[:nq] = _as_u32(queries)
        need_host_rerank = self._host_rerank_needed()
        tier_kind = self._rerank_tier()[0]
        # packed4's ~19-slot hash noise can swap ranks near the k-th
        # answer: over-fetch and let the exact host re-score below pick
        # the true top-k from a 32-wide polish window
        fetch = min(max(32, knbn), n) if tier_kind == "packed4" else knbn
        d, ids = self.search_device(jnp.asarray(qbuf), fetch, ef_search,
                                    rerank=not need_host_rerank)
        if not need_host_rerank:
            if tier_kind == "full":
                return np.asarray(d)[:nq], np.asarray(ids)[:nq]
            # the packed tiers' distances are hash-collision-inflated
            # equal counts — fine for candidate ranking, but the host
            # path's output distances feed ANI conversion
            # (reformat.rs:80-85), so the k answers re-score exactly from
            # the resident full signatures (same ids, exact distances;
            # deliberately the SAME device shapes as search_device — a
            # widened device pool here compiled 18 min of extra top_k)
            ids_h = np.asarray(ids)[:nq]
            qs = _as_u32(queries)
            sigs = _as_u32(self._sigs)
            rows = sigs[np.clip(ids_h, 0, n - 1)]  # [nq, fetch, S]
            eq = (rows == qs[:, None, :]).sum(-1)
            dx = (1.0 - eq / np.float32(self.sketch_size)).astype(np.float32)
            dx[ids_h >= n] = np.inf
            sel = np.argsort(dx, axis=1, kind="stable")[:, :knbn]
            return (np.take_along_axis(dx, sel, axis=1),
                    np.take_along_axis(ids_h, sel, axis=1))

        # host rerank: numpy gather from the resident signature matrix
        # (no device tier fits; candidates came back at prefix precision)
        ids_h = np.asarray(ids)[:nq]
        qs = _as_u32(queries)
        sigs = _as_u32(self._sigs)
        rows = sigs[np.clip(ids_h, 0, n - 1)]  # [nq, R, S]
        eq = (rows == qs[:, None, :]).sum(-1)
        d = (1.0 - eq / np.float32(self.sketch_size)).astype(np.float32)
        d[ids_h >= n] = np.inf
        sel = np.argpartition(d, knbn - 1, axis=1)[:, :knbn]
        dsel = np.take_along_axis(d, sel, axis=1)
        o = np.argsort(dsel, axis=1, kind="stable")
        return (
            np.take_along_axis(dsel, o, axis=1),
            np.take_along_axis(np.take_along_axis(ids_h, sel, axis=1), o, axis=1),
        )

    def _rerank_tier(self) -> tuple:
        """(kind, width): which device rerank tier fits the device at N x S.

        "full" = exact equal-count on the whole signature; "packed" =
        16-bit slot hashes (collision bias 2^-16/slot — near-exact) over
        the first w slots; "packed8" = 8-bit slot hashes over ALL slots
        (collision sd ~2 slots at S=12000 — still far below sketch noise).
        Full-width coverage beats hash width: a 16-bit tier over a slot
        SAMPLE (8192/12000) carries ~20-slot sampling noise and capped
        524k recall@10 at 0.982, while the 8-bit full-width tier is
        ~2-slot noise at half the bytes (6.4 GB at 524k x 12000).  "host" =
        nothing fits, candidates rerank on the host."""
        n = self.nb_points
        sp = self.search_prefix
        nbp1 = _next_pow2(n) + 1
        full_bytes = nbp1 * _round_up(self.sketch_size, 1024) * 4
        device_bytes = _rerank_device_bytes()
        if (full_bytes <= device_bytes
                and not os.environ.get("GSEARCH_TPU_FORCE_PACKED_RERANK")):
            return "full", self.sketch_size
        budget = int(0.7 * device_bytes)
        w16 = min(budget // (2 * nbp1) // 2048 * 2048,
                  _round_up(self.sketch_size, 2048))
        if w16 >= _round_up(self.sketch_size, 2048):
            return "packed", w16          # full-width 16-bit
        w8 = _round_up(self.sketch_size, 4096)
        if budget // nbp1 >= w8:
            return "packed8", w8          # full-width 8-bit
        w4 = _round_up(self.sketch_size, 8192)
        if budget // nbp1 >= w4 // 2:
            # full-width 4-bit (1M x 12000: 8.6 GB): affine collision
            # bias (ranking-safe), sd ~19 slots — HALF the ~37-slot
            # sampling noise of a 16-bit tier over the 4096-slot sample
            # that fits the same bytes; search() polishes the final
            # top-k with an exact host re-score (_pack_hash4)
            return "packed4", w4
        if w16 >= 2048 and w16 > sp:
            return "packed", w16          # sampled 16-bit (last resort)
        return "host", 0

    def _host_rerank_needed(self) -> bool:
        return (self.search_prefix < self.sketch_size
                and self._rerank_tier()[0] == "host")

    def search_device(
        self, q_dev, knbn: int, ef_search: int = 0, rerank: bool = True
    ):
        """Device-resident search: q_dev is a [Qb, sketch_size] uint32 (or
        f32-bitcast) array already on device, Qb a power of two >= 8.

        Returns DEVICE arrays (distances [Qb, k], ids [Qb, k]) — no host
        round trip, so callers whose queries are already on device (the
        sketch pipeline's output, the kgraph self-sweep, benchmarks
        measuring device throughput rather than host transfers) avoid the
        per-call staging upload entirely.  With rerank=False, returns the
        candidate list at prefix precision for the caller to rerank."""
        n = self.nb_points
        nb = _next_pow2(n)
        sp = self.search_prefix
        qb = q_dev.shape[0]
        q_u32 = q_dev if q_dev.dtype == jnp.uint32 else q_dev.view(jnp.uint32)
        q_p = q_u32[:, :sp]

        ef = max(ef_search or self.DEFAULT_EF, knbn)
        ef_round = _round_up(min(ef, nb), 64)
        expand = self.EXPAND
        hops = max(8, int(2 * math.log2(nb)) + ef_round // expand)
        no_rerank = sp >= self.sketch_size
        r_env = int(os.environ.get("GSEARCH_TPU_RERANK_R", "0"))
        base_r = r_env or max(4 * knbn, 32)
        r = knbn if no_rerank else min(_round_up(base_r, 8), ef_round)

        coarse = None
        if (device_profile().accelerated and n >= self.COARSE_MIN
                and not os.environ.get("GSEARCH_TPU_FORCE_BEAM")):
            coarse = self._coarse_searcher()
        if coarse is not None:
            if not no_rerank:
                # the coarse sweep's candidates are the exact prefix-metric
                # top-r; unlike the beam's they are not bounded by ef.  At
                # 524k x 12000 the r=160 pool already contained all oracle
                # top-10 — end-to-end recall is set by the rerank tier,
                # not r.  Capped at 1024 to stay inside the coarse
                # searcher's nb_cand=2048 estimator pool.
                r = min(_round_up(r_env or max(16 * knbn, 160), 8), nb, 1024)
            dp, ids = coarse.search_device(
                q_p, knbn=knbn if no_rerank else r)
        else:
            sigs_p, nbrs_p, entries = self._device_arrays()
            dp, ids = _graph_search(
                sigs_p, nbrs_p, entries, q_p, jnp.int32(n),
                ef=ef_round, r=r, hops=hops, expand=expand,
            )
        if no_rerank or not rerank:
            return dp, ids

        kind, w = self._rerank_tier()
        if kind == "full":
            spad = _round_up(self.sketch_size, 1024)
            # column pads 1 != db column pads 0: never an equal slot
            q_full = _pad_cols_ones(q_u32, spad)
            full = self._device_full_sigs()
            return _rerank_device(
                full, q_full, ids, jnp.int32(n),
                knbn=knbn, s_true=self.sketch_size,
            )
        if kind in ("packed", "packed8", "packed4"):
            from ..ops.mxu import _pack_hash4, _pack_hash8, _pack_hash16

            bits = {"packed": 16, "packed8": 8, "packed4": 4}[kind]
            wq = min(w, self.sketch_size)
            packed = self._device_packed_sigs(w, bits=bits)
            pack = {16: _pack_hash16, 8: _pack_hash8, 4: _pack_hash4}[bits]
            q_pk = pack(q_u32[:, :wq], spad=w,
                        pad_val=1).reshape(qb, w // (32 // bits))
            return _rerank_device(
                packed, q_pk, ids, jnp.int32(n),
                knbn=knbn, s_true=wq,
                parts=32 // bits,
            )
        raise ValueError(
            "no device rerank tier fits; use search() (host rerank)")

    # ------------------------------------------------------------------ io

    def save_arrays(self, prefix: str) -> dict:
        np.save(prefix + ".sigs.npy", self._sigs)
        self._ensure_nbr_d()
        np.savez(
            prefix + ".graph.npz",
            nbrs=self._nbrs,
            nbr_d=self._nbr_d,
            entry_ids=self._entry_ids,
            pinned=self._pinned,
        )
        return {
            "max_nb_conn": self.max_nb_conn,
            "ef_construction": self.ef_construction,
            "scale_modification": self.scale_modification,
            "search_prefix": self.search_prefix,
        }

    @classmethod
    def load_arrays(cls, prefix: str, meta: dict) -> "HnswIndex":
        buf, n = load_sigs_npy_with_headroom(prefix + ".sigs.npy")
        g = np.load(prefix + ".graph.npz")
        idx = cls(
            sketch_size=buf.shape[1],
            sig_dtype=buf.dtype,
            max_nb_conn=int(meta.get("max_nb_conn", 64)),
            ef_construction=int(meta.get("ef_construction", 200)),
            scale_modification=float(meta.get("scale_modification", 1.0)),
            search_prefix=int(meta.get("search_prefix", 1024)),
        )
        idx.adopt_sig_buffer(buf, n)
        idx._nbrs = g["nbrs"]
        if "nbr_d" in g:
            idx._nbr_d = g["nbr_d"]
        idx._entry_ids = g["entry_ids"]
        if "pinned" in g:
            idx._pinned = g["pinned"]
        return idx


# ---------------------------------------------------------------------------
# traced building blocks
# ---------------------------------------------------------------------------


def _prefix_dist(rows: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """rows [..., S'], q broadcastable -> fraction of differing slots."""
    return eq_to_dist((rows == q).sum(axis=-1), rows.shape[-1])


def _beam(sigs_p, nbrs_p, entries, q_p, n, *, ef, hops, expand):
    """Batched beam search over the flat neighbor array.

    sigs_p [NB+1, S'] u32 (sentinel last), nbrs_p [NB+1, M0] i32 (sentinel
    id = NB or more), entries [T] i32 (sentinel-padded), q_p [Q, S'] u32,
    n traced live count.  Returns (beam_ids [Q, ef] i32, beam_d [Q, ef]
    f32) sorted ascending by prefix distance.  Each hop scores its
    candidate rows with gather_eqcount."""
    qn = q_p.shape[0]
    m0 = nbrs_p.shape[1]
    sent = sigs_p.shape[0] - 1
    sp = sigs_p.shape[1]
    big = jnp.float32(jnp.inf)

    # ---- entry tier: exact prefix distances to the sampled entries
    ent_sigs = jnp.take(sigs_p, entries, axis=0)  # [T, S']
    d_ent = _prefix_dist(ent_sigs[None, :, :], q_p[:, None, :])  # [Q, T]
    d_ent = jnp.where((entries < n)[None, :], d_ent, big)
    k0 = min(ef, entries.shape[0])
    neg, idx = jax.lax.top_k(-d_ent, k0)
    beam_ids = jnp.take(entries, idx, axis=0).astype(jnp.int32)
    beam_d = -neg
    if k0 < ef:
        pad = ef - k0
        beam_ids = jnp.concatenate(
            [beam_ids, jnp.full((qn, pad), sent, jnp.int32)], axis=1)
        beam_d = jnp.concatenate([beam_d, jnp.full((qn, pad), big)], axis=1)
    expanded = (beam_ids >= n) | ~jnp.isfinite(beam_d)

    # visited ring: everything ever scored; wraparound (re-scoring) is
    # rare with this size and costs only wasted work, never correctness.
    # Must hold at least the initial beam plus one hop block (a 4096 cap
    # broke ef=5000: the ring seed write needs >= ef slots)
    vis_size = _round_up(
        min(ef + hops * expand * m0, max(4096, ef + expand * m0 + 128)), 128)
    ring = jnp.full((qn, vis_size), sent, jnp.int32)
    ring = jax.lax.dynamic_update_slice(ring, beam_ids, (0, 0))
    ring_pos = jnp.int32(ef % max(vis_size - expand * m0, 1))

    rc = min(2048, vis_size)  # ring-compare chunk (bounds the bool buffer)

    def hop(state):
        beam_ids, beam_d, expanded, ring, ring_pos, it = state
        sel_d = jnp.where(expanded, big, beam_d)
        _, sel = jax.lax.top_k(-sel_d, expand)  # [Q, E] beam positions
        sel_ids = jnp.take_along_axis(beam_ids, sel, axis=1)
        onehot = jnp.zeros_like(expanded).at[jnp.arange(qn)[:, None], sel].set(True)
        expanded = expanded | onehot

        cand = jnp.take(nbrs_p, sel_ids, axis=0).reshape(qn, expand * m0)

        # de-dup: ring (chunked compares), live beam, within-block
        def ring_chunk(c, seen):
            rg = jax.lax.dynamic_slice_in_dim(ring, c * rc, rc, axis=1)
            return seen | (cand[:, :, None] == rg[:, None, :]).any(-1)

        seen = jax.lax.fori_loop(
            0, vis_size // rc, ring_chunk,
            jnp.zeros((qn, expand * m0), jnp.bool_))
        in_beam = (cand[:, :, None] == beam_ids[:, None, :]).any(-1)
        occ = (cand[:, :, None] == cand[:, None, :]).astype(jnp.int32)
        is_dup = jnp.cumsum(occ, axis=-1).diagonal(axis1=1, axis2=2) > 1
        fresh = ~seen & ~in_beam & ~is_dup & (cand < n)
        cand = jnp.where(fresh, cand, sent)

        cd = gather_eqcount(sigs_p, q_p, cand, s_true=sp)
        cd = jnp.where(fresh, cd, big)

        all_ids = jnp.concatenate([beam_ids, cand], axis=1)
        all_d = jnp.concatenate([beam_d, cd], axis=1)
        all_x = jnp.concatenate([expanded, ~fresh], axis=1)
        negd, keepk = jax.lax.top_k(-all_d, ef)
        beam_ids = jnp.take_along_axis(all_ids, keepk, axis=1)
        beam_d = -negd
        expanded = jnp.take_along_axis(all_x, keepk, axis=1)

        ring = jax.lax.dynamic_update_slice(ring, cand, (0, ring_pos))
        ring_pos = (ring_pos + expand * m0) % jnp.int32(max(vis_size - expand * m0, 1))
        return beam_ids, beam_d, expanded, ring, ring_pos, it + 1

    def not_done(state):
        # standard HNSW termination, batched: a query still has work while
        # its closest UNEXPANDED beam entry beats its worst kept result.
        # `hops` stays as the hard cap (compile-time bound on the visited
        # ring); typical convergence is far earlier, and the while_loop
        # stops the whole batch when its slowest query converges.
        beam_ids, beam_d, expanded, ring, ring_pos, it = state
        best_unexp = jnp.min(jnp.where(expanded, big, beam_d), axis=1)
        # finite guard: an exhausted query has best_unexp = inf and must
        # count as done even when its beam tail is also inf (inf <= inf)
        active = (best_unexp <= beam_d[:, -1]) & jnp.isfinite(best_unexp)
        return (it < hops) & active.any()

    beam_ids, beam_d, *_ = jax.lax.while_loop(
        not_done, hop,
        (beam_ids, beam_d, expanded, ring, ring_pos, jnp.int32(0)),
    )
    return beam_ids, beam_d


@functools.partial(
    jax.jit, static_argnames=("ef", "C", "hops", "expand"),
    donate_argnums=(0,),
)
def _insert_search(sigs_p, nbrs_p, entries, q_p, n, *, ef, C, hops, expand):
    """Build-time candidate generation for one insert batch.

    Writes the batch prefix sigs at row n (so batch-mates are gatherable),
    beam-searches the existing graph, merges the dense batch-mate block,
    takes the top-C candidates and runs the select-neighbors heuristic.
    Returns (sigs_p', cand_ids [B, C], cand_d [B, C], keep [B, C])."""
    B, sp = q_p.shape
    sigs_p = jax.lax.dynamic_update_slice(sigs_p, q_p, (n, jnp.int32(0)))

    beam_ids, beam_d = _beam(
        sigs_p, nbrs_p, entries, q_p, n, ef=ef, hops=hops, expand=expand)

    # ---- batch-mates as candidates: dense [B, B] prefix-distance block
    mc = min(64, B)

    def mate_chunk(j):
        qc = jax.lax.dynamic_slice_in_dim(q_p, j * mc, mc, axis=0)
        return _prefix_dist(qc[None, :, :], q_p[:, None, :])  # [B, mc]

    d_m = jax.lax.map(mate_chunk, jnp.arange(B // mc))  # [B/mc, B, mc]
    d_m = jnp.moveaxis(d_m, 0, 1).reshape(B, B)
    d_m = jnp.where(jnp.eye(B, dtype=bool), jnp.inf, d_m)
    mate_ids = n + jnp.arange(B, dtype=jnp.int32)

    all_ids = jnp.concatenate([beam_ids, jnp.broadcast_to(mate_ids, (B, B))], axis=1)
    all_d = jnp.concatenate([beam_d, d_m], axis=1)
    negd, sel = jax.lax.top_k(-all_d, C)
    cand_ids = jnp.take_along_axis(all_ids, sel, axis=1)
    cand_d = -negd

    # ---- candidate pairwise block + select heuristic
    cs = jnp.take(sigs_p, jnp.where(jnp.isfinite(cand_d), cand_ids, 0), axis=0)

    # chunk the column sweep: a 1-column loop re-reads the whole [B, C, S']
    # candidate block from device memory C times (~268 GB/batch at B=1024,
    # C=256);
    # pc columns per step cut that traffic pc-fold and the compare+reduce
    # still fuses (no [B, C, pc, S'] materialization)
    pc = min(16, C)
    while C % pc:
        pc -= 1

    def pcol(j, acc):
        cj = jax.lax.dynamic_slice_in_dim(cs, j * pc, pc, axis=1)  # [B, pc, S']
        dj = _prefix_dist(cs[:, :, None, :], cj[:, None, :, :])  # [B, C, pc]
        return jax.lax.dynamic_update_slice(acc, dj, (0, 0, j * pc))

    pair_d = jax.lax.fori_loop(0, C // pc, pcol, jnp.zeros((B, C, C), jnp.float32))

    def step(kept, j):
        # candidate j survives if closer to the node than to every kept one
        d_to_kept = jnp.where(kept, pair_d[:, j, :], jnp.inf)  # [B, C]
        ok = cand_d[:, j] < jnp.min(d_to_kept, axis=-1)
        ok = ok & jnp.isfinite(cand_d[:, j])
        kept = kept.at[:, j].set(ok)
        return kept, None

    kept0 = jnp.zeros((B, C), bool).at[:, 0].set(jnp.isfinite(cand_d[:, 0]))
    keep, _ = jax.lax.scan(step, kept0, jnp.arange(1, C))
    return sigs_p, cand_ids, cand_d, keep


@functools.partial(jax.jit, donate_argnums=(0, 1),
                   static_argnames=("m_near", "rl"))
def _insert_apply(nbrs_p, nbr_d, rows_ids, rows_d, n, inc_tgt, inc_ids, inc_d,
                  f_tgt, f_src, f_d, *, m_near, rl):
    """Write the batch's forward rows at n and merge reverse links into
    their (unique) targets by cached link distance.

    The merge only touches each target row's NEAR region [0, m_near);
    columns [m_near, M0) hold the insert-time heuristic's far/diverse
    survivors and are immutable — distance eviction would otherwise purge
    exactly the links that keep dense clusters reachable.

    f_tgt/f_src/f_d are the reachability guarantee: each inserted point
    forces ONE back-link from its nearest pre-batch neighbor into that
    row's tail (random-link) slots.  Without it, a point far from the
    whole database (novel cluster in an `add`) loses every distance merge
    — its reverse links never land and it is unreachable forever.  The
    tail slot chosen is the one with the largest cached distance, so real
    links replace the inf-distance random links first (hnsw_rs keeps such
    links through its diversity heuristic, dnasketch.rs:159-160)."""
    nbrs_p = jax.lax.dynamic_update_slice(nbrs_p, rows_ids, (n, jnp.int32(0)))
    nbr_d = jax.lax.dynamic_update_slice(nbr_d, rows_d, (n, jnp.int32(0)))
    nbrs_p, nbr_d = _reverse_merge_impl(nbrs_p, nbr_d, inc_tgt, inc_ids,
                                        inc_d, m_near)
    if rl > 0:
        m0 = nbrs_p.shape[1]
        tail_d = jnp.take(nbr_d, f_tgt, axis=0)[:, m0 - rl:]  # [B, rl]
        # slot = (src % rl)-th in the distance-descending slot order: real
        # links replace inf-distance random links first, and same-target
        # writers land in different slots instead of all colliding on one
        order = jnp.argsort(-tail_d, axis=1)
        # bit-mix before the mod: same-target sources differ by multiples
        # of the target-spread modulus, so a plain src % rl would collide
        srl = (f_src ^ (f_src >> 4) ^ (f_src >> 9)) % rl
        slot = jnp.take_along_axis(order, srl[:, None], axis=1)[:, 0]
        # already-present forced source (re-apply / duplicate): no-op slot
        tail_i = jnp.take(nbrs_p, f_tgt, axis=0)[:, m0 - rl:]
        here = tail_i == f_src[:, None]
        slot = jnp.where(here.any(1), jnp.argmax(here, axis=1), slot) + (m0 - rl)
        nbrs_p = nbrs_p.at[f_tgt, slot].set(f_src)
        nbr_d = nbr_d.at[f_tgt, slot].set(f_d)
    return nbrs_p, nbr_d


@jax.jit
def _bulk_keep(sigs_p, cand_ids, cand_d):
    """Select-neighbors heuristic over exact-kNN candidate lists (bulk
    build): keep candidate j iff it is closer to the query than to every
    already-kept candidate — the same greedy rule the incremental
    _insert_search applies to its beam pool (and hnsw_rs's heuristic with
    extend_candidates, dnasketch.rs:159).

    sigs_p [N, sp] u32 prefix matrix; cand_ids [B, C] sorted ascending by
    cand_d (prefix-metric distances; masked entries = inf).
    Returns keep [B, C] bool."""
    sp = sigs_p.shape[1]
    b, c = cand_ids.shape
    rows = jnp.take(sigs_p, cand_ids.reshape(-1), axis=0).reshape(b, c, sp)

    def col(j):
        rj = jax.lax.dynamic_slice_in_dim(rows, j, 1, axis=1)  # [B, 1, sp]
        return eq_to_dist((rows == rj).sum(-1), sp)  # [B, C]

    pair_d = jax.lax.map(col, jnp.arange(c))  # [C(j), B, C(i)]

    def step(closest, j):
        kj = cand_d[:, j] < closest[:, j]
        closest = jnp.where(kj[:, None], jnp.minimum(closest, pair_d[j]),
                            closest)
        return closest, kj

    closest0 = jnp.full((b, c), jnp.inf, jnp.float32)
    _, keeps = jax.lax.scan(step, closest0, jnp.arange(c))
    return keeps.T


def _reverse_merge_impl(nbrs_p, nbr_d, inc_tgt, inc_ids, inc_d, m_near):
    ex_ids = jnp.take(nbrs_p, inc_tgt, axis=0)[:, :m_near]  # [U, m_near]
    ex_d = jnp.take(nbr_d, inc_tgt, axis=0)[:, :m_near]
    # drop incoming links already present (batch-mate forward duplicates)
    dup = (inc_ids[:, :, None] == ex_ids[:, None, :]).any(-1)
    inc_d = jnp.where(dup, jnp.inf, inc_d)
    comb_ids = jnp.concatenate([ex_ids, inc_ids], axis=1)
    comb_d = jnp.concatenate([ex_d, inc_d], axis=1)
    neg, sel = jax.lax.top_k(-comb_d, m_near)
    merged_ids = jnp.take_along_axis(comb_ids, sel, axis=1)
    merged_ids = jnp.where(jnp.isfinite(-neg), merged_ids, nbrs_p.shape[0] - 1)
    rows_now = jnp.take(nbrs_p, inc_tgt, axis=0)
    drow_now = jnp.take(nbr_d, inc_tgt, axis=0)
    rows_new = jnp.concatenate([merged_ids, rows_now[:, m_near:]], axis=1)
    drow_new = jnp.concatenate([-neg, drow_now[:, m_near:]], axis=1)
    nbrs_p = nbrs_p.at[inc_tgt].set(rows_new)
    nbr_d = nbr_d.at[inc_tgt].set(drow_new)
    return nbrs_p, nbr_d


@functools.partial(
    jax.jit, static_argnames=("ef", "r", "hops", "expand"))
def _graph_search(sigs_p, nbrs_p, entries, q_p, n, *, ef, r, hops, expand):
    """Search-time traversal: beam on the prefix, return the top-r
    candidates (prefix distances) for reranking."""
    beam_ids, beam_d = _beam(
        sigs_p, nbrs_p, entries, q_p, n, ef=ef, hops=hops, expand=expand)
    return beam_d[:, :r], beam_ids[:, :r]


@functools.partial(jax.jit, static_argnames=("knbn", "s_true", "parts"))
def _rerank_device(sigs_full, q_full, ids, n, *, knbn, s_true, parts=1):
    """Full-signature (parts=1) or packed-hash (parts=2: 16-bit halves,
    parts=4: 8-bit quarters, parts=8: 4-bit nibbles) rerank of the [Q, R]
    candidates, then top-k."""
    d = gather_eqcount(sigs_full, q_full, ids, s_true=s_true, parts=parts)
    d = jnp.where(ids < n, d, jnp.inf)
    neg, sel = jax.lax.top_k(-d, knbn)
    return -neg, jnp.take_along_axis(ids, sel, axis=1)
