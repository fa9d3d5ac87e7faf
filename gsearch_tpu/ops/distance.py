"""Sketch distance kernels: Hamming fraction over signature vectors.

The metric everywhere in the reference is DistHamming over sketch vectors —
the fraction of differing slots, which estimates 1 - Jaccard for every
MinHash-family signature (reference: src/dna/dnasketch.rs:103-104,139;
src/bin/bindash.rs:93-99).

`hamming_frac_xla` is the exact all-pairs sweep and the correctness oracle;
`brute_force_knn` is both the small-database fast path and the recall
oracle for the ANN index (SURVEY.md §7 step 4).  `gather_eqcount` scores
each query against its own candidate rows only: the exact rerank behind
the int8 candidate GEMM (ops/mxu.py) and the graph index (index/hnsw.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import get_logger

log = get_logger(__name__)


def _pad_axis(x: jnp.ndarray, axis: int, mult: int, value) -> jnp.ndarray:
    n = x.shape[axis]
    rem = (-n) % mult
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return jnp.pad(x, pad, constant_values=value)


def eq_to_dist(eq: jnp.ndarray, s: int) -> jnp.ndarray:
    """Equal-slot counts -> Hamming fraction (s - eq) / s, f32.

    Written as a multiply by the f32 reciprocal of s: XLA rewrites a
    division by a constant into exactly that in some fusions and not in
    others, so only this form gives the same bits in every compiled
    program (the index paths and the oracle agree bit for bit), and
    identical sketches sit at distance exactly 0."""
    return (jnp.float32(s) - eq.astype(jnp.float32)) * np.float32(1.0 / s)


def hamming_frac_xla(q: jnp.ndarray, db: jnp.ndarray, chunk: int = 2048) -> jnp.ndarray:
    """Reference implementation: [Q, S] x [N, S] -> [Q, N] float32 distances."""
    s = q.shape[-1]
    nq = q.shape[0]
    n = db.shape[0]
    if n <= chunk:
        eq = (q[:, None, :] == db[None, :, :]).sum(axis=-1)
    else:
        # padding rows compare arbitrarily; they are sliced off below
        db_p = _pad_axis(db, 0, chunk, 0)
        nch = db_p.shape[0] // chunk
        eq = jax.lax.map(
            lambda i: (q[:, None, :] == jax.lax.dynamic_slice_in_dim(db_p, i * chunk, chunk, 0)[None, :, :]).sum(-1),
            jnp.arange(nch),
        )
        eq = jnp.moveaxis(eq, 0, 1).reshape(nq, nch * chunk)[:, :n]
    return eq_to_dist(eq, s)


def _eq_fields(x: jnp.ndarray, parts: int) -> jnp.ndarray:
    """Equal sub-fields of x = a ^ b as int32: the whole u32 (parts=1),
    16-bit halves (2), 8-bit quarters (4) or 4-bit nibbles (8)."""
    if parts == 1:
        return (x == 0).astype(jnp.int32)
    bits = 32 // parts
    mask = jnp.uint32((1 << bits) - 1)
    return sum((((x >> jnp.uint32(bits * b)) & mask) == 0).astype(jnp.int32)
               for b in range(parts))


def gather_eqcount(db: jnp.ndarray, q: jnp.ndarray, ids: jnp.ndarray, *,
                   s_true: int, parts: int = 1) -> jnp.ndarray:
    """Hamming fraction of each query against its gathered candidate rows.

    db [N, L] u32, or the same rows pre-shaped [N, 8, L/8] (a free
    row-major reshape); q [Qc, L] u32; ids [Qc, C] int32 row ids, clamped
    into [0, N) -> [Qc, C] f32 distances eq_to_dist(eq, s_true), where eq counts
    the equal fields of q[i] and db[ids[i, j]] and each u32 lane holds
    `parts` packed fields (1, 2, 4 or 8).  Column pads of db and q must
    differ so that they never count.  Distances are bit-equal to the
    oracle's (hamming_frac_xla).

    One plain XLA gather + compare + reduce: on the GPU, XLA fuses the
    gather into the reduction and reads each candidate row once, as fast
    as a hand-written fused Triton kernel measured at these widths."""
    if parts not in (1, 2, 4, 8):
        raise ValueError(f"parts must be 1, 2, 4 or 8 (got {parts})")
    db2 = db.reshape(db.shape[0], -1)
    if q.shape[1] != db2.shape[1]:
        raise ValueError(f"query lanes {q.shape[1]} != db lanes {db2.shape[1]}")
    ids = jnp.clip(ids.astype(jnp.int32), 0, db2.shape[0] - 1)
    rows = jnp.take(db2, ids, axis=0)  # [Qc, C, L]
    eq = _eq_fields(rows ^ q[:, None, :], parts).sum(axis=-1)
    return eq_to_dist(eq, s_true)


def hamming_frac(q: jnp.ndarray, db: jnp.ndarray) -> jnp.ndarray:
    """[Q, S] x [N, S] -> [Q, N] fraction of differing slots (exact)."""
    return hamming_frac_xla(q, db)


def brute_force_knn(q: jnp.ndarray, db: jnp.ndarray, knbn: int):
    """Exact top-k by sketch distance. Returns (distances [Q,k], ids [Q,k])."""
    d = hamming_frac(q, db)
    neg, ids = jax.lax.top_k(-d, knbn)
    return -neg, ids


def _next_bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


def bucketed_knn(q: np.ndarray, db: np.ndarray, knbn: int):
    """brute_force_knn with Q and N padded to power-of-two buckets so
    growing databases / varying batch sizes reuse compiled programs.
    Pad rows get +inf distance, so results are exact."""

    def _pad_rows(x, rows):
        # device arrays pad with jnp (no host download); numpy stays host-side
        if isinstance(x, jax.Array) and not isinstance(x, np.ndarray):
            return jnp.concatenate(
                [x, jnp.zeros((rows,) + x.shape[1:], x.dtype)], axis=0)
        return np.concatenate(
            [x, np.zeros((rows,) + x.shape[1:], x.dtype)], axis=0)

    nq, n = q.shape[0], db.shape[0]
    qb = _next_bucket(nq, 8)
    nb = _next_bucket(n, 16)
    if qb != nq:
        q = _pad_rows(q, qb - nq)
    if nb != n:
        db = _pad_rows(db, nb - n)
    # the static top_k width derives from the BUCKET (not the live n) so a
    # growing database reuses one compiled program; pad rows are +inf and
    # sort last, so slicing restores the exact semantics
    k_static = min(knbn, nb)
    d, ids = _bucketed_knn_jit(
        jnp.asarray(q), jnp.asarray(db), jnp.int32(n), knbn=k_static)
    k_real = min(knbn, n)
    return np.asarray(d)[:nq, :k_real], np.asarray(ids)[:nq, :k_real]


@functools.partial(jax.jit, static_argnames=("knbn",))
def _bucketed_knn_jit(q, db, n, *, knbn: int):
    # n is a traced scalar: one compiled program serves every fill level of
    # the bucket; pad rows are masked to +inf
    d = hamming_frac(q, db)
    col = jnp.arange(db.shape[0], dtype=jnp.int32)
    d = jnp.where(col[None, :] < n, d, jnp.inf)
    neg, ids = jax.lax.top_k(-d, knbn)
    return -neg, ids
