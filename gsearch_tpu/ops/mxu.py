"""Sketch search as an int8 matmul: slot equality estimated by sign dots.

The exact equal-count distance (ops/distance.py) is a Q*N*S compare
sweep.  A matrix unit cannot compare, but it can do something
statistically equivalent: expand every slot value into m sign bits of a *hash* of the
value.  For two genomes' slots:

    equal slot   -> all m sign bits agree        -> contributes +m
    unequal slot -> hash bits are iid fair coins -> contributes 0 on average

so  E[ q_exp . d_exp ] = m * S * J  with per-pair noise sd ~ sqrt(mS)/2 —
an unbiased Jaccard estimator whose precision grows with m, computed as a
[Q, mS] x [mS, N] int8 matmul on the tensor cores instead of a compare
sweep.  Hashing the value first makes the coin-flip property
hold for ANY signature dtype (f32 hash values, u32 fingerprints, u16
SetSketch registers whose neighboring levels differ in one low bit).

Search = matmul scores -> top-C candidates -> exact equal-count rerank on
the gathered candidate rows -> top-k.  With C a few times k the end-to-end
ranking matches the exact kernel with probability -> 1 (validated in
tests/test_mxu.py); rerank distances are bit-exact.

Reference role: this replaces hnsw_rs::parallel_search as the throughput
path (reference: src/dna/dnarequest.rs:353) — the graph index (hnsw.py)
remains for corpora too large for a full sweep.

Compact mode (auto-selected for databases whose standard two
representations would exceed half of one device's memory):
m=2 sign expansion for candidate scoring plus a rerank matrix of 16-bit
slot HASHES packed in pairs into u32 lanes — 48 KB/row instead of 97 KB
at S=12000.  Rerank counts equal 16-bit halves: two unequal slots'
hashes collide with probability 2^-16, so at S=12000 the expected
distance bias is < 2e-5 (<< sketch noise 1/sqrt(S) ~ 1e-2) and ranking
is exact-in-practice; the recall check in scripts/bench_mxu262k.py and
tests/test_mxu.py validate top-k equality against the exact oracle.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import device_profile
from .distance import gather_eqcount
from .hash import mix32

_EXPAND_SEED = 0x51614B17
_RERANK_SEED = 0x243F6A88  # independent of the expansion hash

# bound on one rerank dispatch's working set, the [Qc, C, L] u32 candidate
# rows of gather_eqcount, as a fraction of one device's memory (XLA may
# materialize them); query chunks are sized to fit it
RERANK_WORKSET_FRACTION = 1 / 32


def rerank_chunk(nq: int, nb_cand: int, lanes: int) -> int:
    """Largest power-of-two query chunk (>= 8) whose gathered candidate
    rows, nq x nb_cand x lanes u32, fit RERANK_WORKSET_FRACTION of one
    device's memory; nq itself when the whole batch fits."""
    budget = device_profile().budget(RERANK_WORKSET_FRACTION)
    chunk = 8
    while chunk < nq and 2 * chunk * nb_cand * lanes * 4 <= budget:
        chunk <<= 1
    return min(chunk, nq)


def _as_u32(sigs: jnp.ndarray) -> jnp.ndarray:
    if sigs.dtype == jnp.float32:
        return sigs.view(jnp.uint32)
    if sigs.dtype != jnp.uint32:
        return sigs.astype(jnp.uint32)
    return sigs


@functools.partial(jax.jit, static_argnames=("m",))
def expand_signs(sigs: jnp.ndarray, m: int = 4) -> jnp.ndarray:
    """[N, S] any-dtype signatures -> [N, m*S] int8 in {-1, +1}."""
    h = mix32(_as_u32(sigs), _EXPAND_SEED)
    shifts = jnp.arange(m, dtype=jnp.uint32)
    bits = (h[..., None] >> shifts) & jnp.uint32(1)  # [N, S, m]
    signs = (bits.astype(jnp.int8) << 1) - jnp.int8(1)
    return signs.reshape(sigs.shape[0], sigs.shape[1] * m)


def expand_signs_chunked(sigs: np.ndarray, m: int = 4, chunk: int = 8192) -> jax.Array:
    """Host->device expansion in row chunks to bound peak memory."""
    outs = []
    for start in range(0, sigs.shape[0], chunk):
        outs.append(expand_signs(jnp.asarray(sigs[start : start + chunk]), m=m))
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=("m", "spad"))
def _init_write(db_exp, full3, rows_u32, start, *, m, spad):
    """Expand one row chunk and write it into the preallocated device
    buffers IN PLACE (donated): concatenating per-chunk results would
    double the peak device memory of the two representations."""
    exp = expand_signs(rows_u32, m=m)
    f3 = _pad_reshape_full(rows_u32, spad=spad)
    db_exp = jax.lax.dynamic_update_slice(db_exp, exp, (start, jnp.int32(0)))
    full3 = jax.lax.dynamic_update_slice(
        full3, f3, (start, jnp.int32(0), jnp.int32(0)))
    return db_exp, full3


@functools.partial(jax.jit, static_argnames=("spad",))
def _pad_reshape_full(rows_u32: jnp.ndarray, *, spad: int) -> jnp.ndarray:
    """[R, S] u32 -> [R, 8, spad/8] with zero column pads (rerank layout)."""
    r, s = rows_u32.shape
    if spad > s:
        rows_u32 = jnp.concatenate(
            [rows_u32, jnp.zeros((r, spad - s), jnp.uint32)], axis=1)
    return rows_u32.reshape(r, 8, spad // 8)


@functools.partial(jax.jit, static_argnames=("spad", "pad_val"))
def _pack_hash16(rows_u32: jnp.ndarray, *, spad: int, pad_val: int) -> jnp.ndarray:
    """[R, S] u32 -> [R, 8, spad/16] u32: 16-bit slot hashes packed in pairs.

    Compact-mode rerank representation (half the bytes of the full
    matrix).  Column pads use pad_val: 0 for the database, 1 for queries,
    so padded halves never count equal.  spad must be a multiple of 2048
    so the packed lane count spad/2 keeps the kernel's 1024-lane rule."""
    r, s = rows_u32.shape
    h = mix32(rows_u32, _RERANK_SEED) >> jnp.uint32(16)  # [R, S] in [0, 2^16)
    if spad > s:
        h = jnp.concatenate(
            [h, jnp.full((r, spad - s), jnp.uint32(pad_val))], axis=1)
    packed = h[:, 0::2] | (h[:, 1::2] << jnp.uint32(16))  # [R, spad/2]
    return packed.reshape(r, 8, spad // 16)


@functools.partial(jax.jit, static_argnames=("spad", "pad_val"))
def _pack_hash8(rows_u32: jnp.ndarray, *, spad: int, pad_val: int) -> jnp.ndarray:
    """[R, S] u32 -> [R, 8, spad/32] u32: 8-bit slot hashes packed in fours.

    Quarter-width sibling of _pack_hash16 for databases whose 16-bit
    full-width form would not fit the device (a 524k x 12000 matrix is
    12.9 GB at 16 bits, 6.4 GB at 8).  Unequal slots' hashes collide with
    probability 2^-8: at S=12000 and neighbor distances ~0.1 the expected
    inflation is ~5 equal slots with sd ~2 — far below the ~20-slot
    sampling noise of a 16-bit tier over a slot SAMPLE (8192/12000 slots)
    of the same bytes.  spad must be a multiple of 4096 so the packed lane
    count spad/4 keeps the 1024-lane rule."""
    r, s = rows_u32.shape
    h = mix32(rows_u32, _RERANK_SEED) >> jnp.uint32(24)  # [R, S] in [0, 2^8)
    if spad > s:
        h = jnp.concatenate(
            [h, jnp.full((r, spad - s), jnp.uint32(pad_val))], axis=1)
    packed = (h[:, 0::4] | (h[:, 1::4] << jnp.uint32(8))
              | (h[:, 2::4] << jnp.uint32(16))
              | (h[:, 3::4] << jnp.uint32(24)))  # [R, spad/4]
    return packed.reshape(r, 8, spad // 32)


@functools.partial(jax.jit, static_argnames=("spad", "pad_val"))
def _pack_hash4(rows_u32: jnp.ndarray, *, spad: int, pad_val: int) -> jnp.ndarray:
    """[R, S] u32 -> [R, 8, spad/64] u32: 4-bit slot hashes packed eight
    to a lane.

    Eighth-width sibling of _pack_hash16 for databases where even the
    8-bit full-width form does not fit the device (a 1M x 12000 matrix is
    12.9 GB at 8 bits, 8.6 GB at 4, padded to the 1024-lane rule).
    Unequal slots' hashes collide with probability 2^-4, so the measured
    equal count is E[meq] = eq + (S - eq)/16 — AFFINE in the true count,
    so expected ranking is unchanged; the noise is sd = sqrt((S-eq)
    15/256) ~ 19 slots at S=12000, eq~S/2 — half the ~37-slot sampling
    noise of a 16-bit tier over the 4096/12000 slot SAMPLE that fits the
    same bytes.  Callers polish the final top-k with an exact host
    re-score.  spad must be a multiple of 8192 so the packed lane count
    spad/8 keeps the 1024-lane rule."""
    r, s = rows_u32.shape
    h = mix32(rows_u32, _RERANK_SEED) >> jnp.uint32(28)  # [R, S] in [0, 16)
    if spad > s:
        h = jnp.concatenate(
            [h, jnp.full((r, spad - s), jnp.uint32(pad_val))], axis=1)
    packed = h[:, 0::8]
    for b in range(1, 8):
        packed = packed | (h[:, b::8] << jnp.uint32(4 * b))  # [R, spad/8]
    return packed.reshape(r, 8, spad // 64)


@functools.partial(jax.jit, donate_argnums=(0,), static_argnames=("m",))
def _init_write_exp(db_exp, rows_u32, start, *, m):
    """Estimator-only sibling of _init_write: expand one row chunk into
    the donated sign-expansion buffer, building NO rerank matrix (the
    caller reranks with its own device tier — e.g. the hnsw packed4
    tier, where this searcher's 16-bit prefix rerank matrix would take
    device memory that tier needs)."""
    exp = expand_signs(rows_u32, m=m)
    return jax.lax.dynamic_update_slice(db_exp, exp, (start, jnp.int32(0)))


@functools.partial(jax.jit, donate_argnums=(0, 1), static_argnames=("m", "spad"))
def _init_write_compact(db_exp, packed3, rows_u32, start, *, m, spad):
    """Compact-mode sibling of _init_write: expand + pack one row chunk
    into the donated device buffers in place."""
    exp = expand_signs(rows_u32, m=m)
    p3 = _pack_hash16(rows_u32, spad=spad, pad_val=0)
    db_exp = jax.lax.dynamic_update_slice(db_exp, exp, (start, jnp.int32(0)))
    packed3 = jax.lax.dynamic_update_slice(
        packed3, p3, (start, jnp.int32(0), jnp.int32(0)))
    return db_exp, packed3


def _sign_scores(q_exp: jnp.ndarray, db_exp: jnp.ndarray) -> jnp.ndarray:
    """[Q, mS] x [N, mS] int8 -> [Q, N] f32 sign-dot scores: one int8 GEMM
    with int32 accumulation.  Scores are bounded by m*S < 2^24, so the f32
    conversion (which top_k sorts faster than int32) is lossless."""
    return jax.lax.dot_general(
        q_exp, db_exp, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=("nb_cand",))
def _mxu_candidates(q_exp: jnp.ndarray, db_exp: jnp.ndarray, nb_cand: int):
    _, cand = jax.lax.top_k(_sign_scores(q_exp, db_exp), nb_cand)
    return cand


@functools.partial(jax.jit, static_argnames=("m", "knbn", "s_true"))
def _search_estimator(q_sigs, db_exp, n_valid, *, m, knbn, s_true):
    """Estimator-only search: sign-dot scores -> masked top-k, NO rerank.

    The candidate POOL for callers that own a separate rerank tier (the
    hnsw coarse path at 1M x 12000, index/hnsw.py:_coarse_searcher).
    Returned distances are the unbiased Jaccard estimate from the sign
    dot (noise sd ~ sqrt(mS)/2 score units) — pool ordering only; the
    caller's tier re-scores.  Pad rows (id >= n_valid) are masked to
    -inf BEFORE top-k: unlike the fused path there is no downstream
    rerank to mask them out."""
    scores = _sign_scores(expand_signs(q_sigs, m=m), db_exp)
    col = jnp.arange(db_exp.shape[0], dtype=jnp.int32)
    scores = jnp.where((col < n_valid)[None, :], scores, -jnp.inf)
    neg, cand = jax.lax.top_k(scores, knbn)
    d = 1.0 - neg / (jnp.float32(m) * jnp.float32(s_true))
    return d, cand


@functools.partial(jax.jit, static_argnames=("knbn", "s_true", "compact"))
def _rerank(q_sigs: jnp.ndarray, db_rr3: jnp.ndarray, cand: jnp.ndarray,
            n_valid: jnp.ndarray, knbn: int, s_true: int,
            compact: bool = False):
    """Equal-count distances on the candidate rows, then top-k.

    db_rr3 is the rerank matrix pre-shaped [N, 8, Sp/8]: the column-padded
    full signatures (db col pads 0; exact distances), or in compact mode
    the pair-packed 16-bit slot hashes [N, 8, Sp/16] (near-exact, see
    module docstring).  Candidate rows are scored by gather_eqcount."""
    qs = _as_u32(q_sigs)
    sp = db_rr3.shape[1] * db_rr3.shape[2]
    if compact:
        q_pad = _pack_hash16(qs, spad=2 * sp, pad_val=1).reshape(qs.shape[0], sp)
    elif sp > qs.shape[1]:  # query col pads 1: never equal to the db's 0
        q_pad = jnp.concatenate(
            [qs, jnp.ones((qs.shape[0], sp - qs.shape[1]), jnp.uint32)], axis=1)
    else:
        q_pad = qs
    d = gather_eqcount(db_rr3, q_pad, cand, s_true=s_true,
                       parts=2 if compact else 1)
    d = jnp.where(cand < n_valid, d, jnp.inf)
    neg, sel = jax.lax.top_k(-d, knbn)
    return -neg, jnp.take_along_axis(cand, sel, axis=1)


@functools.partial(
    jax.jit, static_argnames=("m", "nb_cand", "knbn", "s_true", "compact"))
def _search_fused(q_sigs, db_exp, db_rr3, n_valid, *, m, nb_cand, knbn,
                  s_true, compact=False):
    """One-dispatch search: expand + matmul candidates + rerank, with no
    host round trip between the stages."""
    q_exp = expand_signs(q_sigs, m=m)
    cand = _mxu_candidates(q_exp, db_exp, nb_cand)
    return _rerank(q_sigs, db_rr3, cand, n_valid, knbn, s_true, compact)


def planned_footprint(n: int, s: int, m: int = 4) -> Tuple[bool, int]:
    """(compact?, device bytes) the constructor would choose for [n, s]
    signatures — lets callers decide whether the SOURCE array can stay
    resident on the device next to the searcher's representations."""
    nb = 16
    while nb < n:
        nb <<= 1
    spad_full = ((s + 1023) // 1024) * 1024
    if nb * (m * s + 4 * spad_full) <= MxuSearcher.compact_bytes():
        return False, nb * (m * s + 4 * spad_full)
    spad = ((s + 2047) // 2048) * 2048
    return True, nb * (2 * s + 2 * spad)


class MxuSearcher:
    """Holds the expanded database on device; searches in two stages."""

    #: auto-switch to compact mode when the standard two representations
    #: would exceed this share of one device's memory (the rest is headroom
    #: for score and gather buffers)
    COMPACT_FRACTION = 0.5

    @classmethod
    def compact_bytes(cls) -> int:
        return device_profile().budget(cls.COMPACT_FRACTION)

    def __init__(self, sigs: np.ndarray, m: int = 4, rerank_factor: int = 8,
                 compact: bool | None = None, nb_cand: int | None = None,
                 estimator_only: bool = False):
        self.s = sigs.shape[1]
        self.n = sigs.shape[0]
        self.estimator_only = bool(estimator_only)
        nb, spad, m = self._resolve_mode(m, compact)
        self.rerank_factor = rerank_factor
        self.nb_cand_override = nb_cand
        pad = nb - self.n
        on_device = isinstance(sigs, jax.Array) and not isinstance(sigs, np.ndarray)
        if on_device:
            # device-resident signatures (e.g. straight from the on-device
            # sketcher): derive both representations with zero host hops.
            # Chunked like the host path: one-shot expansion materializes
            # [N, S, m] u32 temps (11.7 GB at 65k x 12000).
            if pad:
                sigs = jnp.concatenate(
                    [sigs, jnp.zeros((pad,) + sigs.shape[1:], sigs.dtype)], 0)
            u = (sigs.view(jnp.uint32) if sigs.dtype == jnp.float32
                 else sigs.astype(jnp.uint32))
            chunks = (u[start : start + 8192] for start in range(0, nb, 8192))
        else:
            # ONE host->device pass: upload u32 row chunks and derive both
            # device-resident representations from them.
            if pad:
                sigs = np.concatenate(
                    [sigs, np.zeros((pad,) + sigs.shape[1:], sigs.dtype)], 0)
            u = (sigs.view(np.uint32) if sigs.dtype == np.float32
                 else sigs.astype(np.uint32))
            chunks = (jnp.asarray(np.ascontiguousarray(u[start : start + 8192]))
                      for start in range(0, nb, 8192))
        self._fill(chunks, nb, spad)

    def _resolve_mode(self, m: int, compact: bool | None):
        """Pick (n-bucket, column pad, expansion width) and set self.compact."""
        # pad N so every database size in a power-of-two bucket shares one
        # compiled program
        nb = 16
        while nb < self.n:
            nb <<= 1
        spad_full = ((self.s + 1023) // 1024) * 1024
        if compact is None:
            compact = nb * (m * self.s + 4 * spad_full) > self.compact_bytes()
        self.compact = bool(compact)
        if self.compact and m == 4:
            m = 2  # compact default: half-width expansion (see module doc)
        self.m = m
        # packed pairs: spad/2 u32 lanes must stay a multiple of 1024
        spad = (((self.s + 2047) // 2048) * 2048) if self.compact else spad_full
        return nb, spad, m

    def _fill(self, chunks, nb: int, spad: int) -> None:
        """Write u32 row chunks into the two preallocated device buffers
        with donated in-place updates (_init_write/_init_write_compact).
        estimator_only builds the sign expansion ALONE (no rerank matrix;
        see _search_estimator)."""
        m = self.m
        if self.estimator_only:
            if nb <= 8192:
                self._db_exp = expand_signs(next(chunks), m=m)
            else:
                db_exp = jnp.zeros((nb, self.s * m), jnp.int8)
                for start, rows in zip(range(0, nb, 8192), chunks):
                    db_exp = _init_write_exp(db_exp, rows, jnp.int32(start),
                                             m=m)
                self._db_exp = db_exp
            self._rr3 = None
            return
        if nb <= 8192:
            rows = next(chunks)
            self._db_exp = expand_signs(rows, m=m)
            self._rr3 = (_pack_hash16(rows, spad=spad, pad_val=0)
                         if self.compact
                         else _pad_reshape_full(rows, spad=spad))
            return
        db_exp = jnp.zeros((nb, self.s * m), jnp.int8)
        if self.compact:
            rr3 = jnp.zeros((nb, 8, spad // 16), jnp.uint32)
            write = _init_write_compact
        else:
            rr3 = jnp.zeros((nb, 8, spad // 8), jnp.uint32)
            write = _init_write
        for start, rows in zip(range(0, nb, 8192), chunks):
            db_exp, rr3 = write(db_exp, rr3, rows, jnp.int32(start),
                                m=m, spad=spad)
        self._db_exp = db_exp
        self._rr3 = rr3

    @classmethod
    def from_chunks(cls, chunk_iter, n: int, s: int, *, m: int = 4,
                    rerank_factor: int = 8, compact: bool | None = None,
                    nb_cand: int | None = None) -> "MxuSearcher":
        """Build from an iterator of row chunks (each [8192, S] u32/f32,
        device or host; the final chunk may be short) without ever holding
        the full source matrix next to the searcher's representations —
        the init path for databases near the device memory limit."""
        self = cls.__new__(cls)
        self.s = s
        self.n = n
        self.estimator_only = False
        nb, spad, m = self._resolve_mode(m, compact)
        self.rerank_factor = rerank_factor
        self.nb_cand_override = nb_cand

        def as_u32(rows):
            if isinstance(rows, np.ndarray):
                u = (rows.view(np.uint32) if rows.dtype == np.float32
                     else rows.astype(np.uint32))
                return jnp.asarray(np.ascontiguousarray(u))
            return (rows.view(jnp.uint32) if rows.dtype == jnp.float32
                    else rows.astype(jnp.uint32))

        if nb <= 8192:
            rows_list = [as_u32(r) for r in chunk_iter]
            rows = (rows_list[0] if len(rows_list) == 1
                    else jnp.concatenate(rows_list, 0))
            assert rows.shape == (n, s)
            if nb > n:
                rows = jnp.concatenate(
                    [rows, jnp.zeros((nb - n, s), jnp.uint32)], 0)
            self._fill(iter([rows]), nb, spad)
            return self

        def padded_chunks():
            got = yielded = 0
            for rows in chunk_iter:
                assert got % 8192 == 0, "only the final chunk may be short"
                rows = as_u32(rows)
                assert rows.shape[1] == s
                got += rows.shape[0]
                if rows.shape[0] != 8192:  # pad the tail to the chunk shape
                    rows = jnp.concatenate(
                        [rows, jnp.zeros((8192 - rows.shape[0], s), jnp.uint32)], 0)
                yield rows
                yielded += 1
            assert got == n, f"chunks delivered {got} rows, expected {n}"
            while yielded < nb // 8192:  # remaining bucket pad rows
                yield jnp.zeros((8192, s), jnp.uint32)
                yielded += 1

        self._fill(padded_chunks(), nb, spad)
        return self

    def search(self, queries, knbn: int) -> Tuple[np.ndarray, np.ndarray]:
        """queries: [Q, S] numpy OR device array (jax.Array) — serving paths
        keep freshly-sketched queries on device and skip the host hop."""
        nq = queries.shape[0]
        qb = 8
        while qb < nq:
            qb <<= 1
        if qb != nq:
            pad = qb - nq
            if isinstance(queries, np.ndarray):
                queries = np.concatenate(
                    [queries, np.zeros((pad,) + queries.shape[1:], queries.dtype)], 0
                )
            else:
                queries = jnp.concatenate(
                    [queries, jnp.zeros((pad,) + queries.shape[1:], queries.dtype)], 0
                )
        q_dev = jnp.asarray(queries)
        knbn = min(knbn, self.n)
        d, ids = self._search_batched(q_dev, knbn, jnp)
        return np.asarray(d)[:nq], np.asarray(ids)[:nq]

    def search_device(self, q_dev: jax.Array, knbn: int):
        """Fully device-resident variant: returns device arrays (no fetch)."""
        knbn = min(knbn, self.n)
        return self._search_batched(q_dev, knbn, jnp)

    def _search_batched(self, q_dev, knbn, xp):
        """Dispatch _search_fused in query chunks sized so the rerank's
        gathered candidate rows [Qc, C, L] u32 stay within
        RERANK_WORKSET_FRACTION of the device's memory."""
        if self._rr3 is None:  # estimator-only: pool selection, no rerank
            nb = self._db_exp.shape[0]
            # bound the [Qc, N] score buffer: 128 queries x 1M cols f32 is
            # 0.5 GB, transient next to the resident expansion + the
            # caller's own rerank tier
            chunk = max(8, min(q_dev.shape[0], (1 << 27) // nb))
            ds, ids = [], []
            for start in range(0, q_dev.shape[0], chunk):
                rows = q_dev[start : start + chunk]
                if rows.shape[0] != chunk:  # keep one compiled program
                    rows = jnp.concatenate(
                        [rows, jnp.zeros((chunk - rows.shape[0],)
                                         + rows.shape[1:], rows.dtype)], 0)
                d, i = _search_estimator(
                    _as_u32(rows), self._db_exp, jnp.int32(self.n),
                    m=self.m, knbn=knbn, s_true=self.s)
                ds.append(d)
                ids.append(i)
            if len(ds) == 1:
                return ds[0][: q_dev.shape[0]], ids[0][: q_dev.shape[0]]
            return (xp.concatenate(ds, 0)[: q_dev.shape[0]],
                    xp.concatenate(ids, 0)[: q_dev.shape[0]])
        if self.nb_cand_override:
            # explicit candidate width (e.g. the bulk graph constructor's
            # wide-k sweeps, where the default knbn-proportional widening
            # would gather far more rows than the pool needs)
            nb_cand = min(max(self.nb_cand_override, knbn), self._rr3.shape[0])
        else:
            nb_cand = min(max(self.rerank_factor * knbn, 64), self._rr3.shape[0])
            if self.compact:
                # m=2 halves the estimator's sign bits (noise sd grows
                # sqrt(2)x): double the rerank list so the true top-k stay
                # inside it
                nb_cand = min(max(2 * nb_cand, 128), self._rr3.shape[0])
        qb = q_dev.shape[0]
        chunk = rerank_chunk(qb, nb_cand, self._rr3[0].size)
        if chunk >= qb:
            return _search_fused(
                q_dev, self._db_exp, self._rr3, jnp.int32(self.n),
                m=self.m, nb_cand=nb_cand, knbn=knbn, s_true=self.s,
                compact=self.compact,
            )
        ds, ids = [], []
        for start in range(0, qb, chunk):
            rows = q_dev[start : start + chunk]
            if rows.shape[0] != chunk:  # keep one compiled program
                rows = jnp.concatenate(
                    [rows, jnp.zeros((chunk - rows.shape[0],) + rows.shape[1:],
                                     rows.dtype)], 0)
            d, i = _search_fused(
                rows, self._db_exp, self._rr3, jnp.int32(self.n),
                m=self.m, nb_cand=nb_cand, knbn=knbn, s_true=self.s,
                compact=self.compact,
            )
            ds.append(d)
            ids.append(i)
        return (xp.concatenate(ds, axis=0)[:qb], xp.concatenate(ids, axis=0)[:qb])
