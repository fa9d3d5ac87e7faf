"""Coreset extraction + clustering over a sketch database.

Capability-equivalent of the reference's `hnswcore` binary (reference:
binaux/src/bin/hnswcore.rs:161-465 — reload a dumped database, sample
distance quantiles, build a coreset (Coreset1 / BMOR streaming k-median)
or cluster it (ClusterCoreset::compute + dispatch), dump coreset.csv /
clustercoreset.csv).

Device formulation: the BMOR streaming pass is sequential by design
(CPU single-pass constraint that does not apply here); we build the
coreset by D^2 (k-means++-style) sampling — each round scores ALL points'
distance to the current coreset with the fused distance kernel and samples
proportionally to squared distance — followed by weight assignment (count
of points whose nearest coreset member is c) and medoid-style Lloyd
refinement for clustering.  Every step is a dense [N, C] distance sweep on
device; nothing is streamed point-by-point.
"""

from __future__ import annotations

import dataclasses


import jax
import jax.numpy as jnp
import numpy as np

from ..ops.distance import hamming_frac
from ..utils import get_logger

log = get_logger(__name__)

_HIGHEST = jax.lax.Precision.HIGHEST


def pairwise_distance(q, db, metric: str = "hamming") -> jnp.ndarray:
    """Dense [Q, N] distance block under the chosen metric.

    `hamming` is the sketch metric (fraction of differing slots, the
    reference's DistHamming).  l1 / l2 / cosine mirror the reference
    hnswcore's DataMap dispatch over other stored vector types
    (reference: binaux/src/bin/hnswcore.rs:432-462).  l2/cosine are
    matmul-form, at HIGHEST precision (full f32, not the GPU's TF32 default);
    l1 chunks the [Q, chunk, S] broadcast.
    """
    if metric == "hamming":
        return hamming_frac(q, db)
    qf = jnp.asarray(q, jnp.float32)
    df = jnp.asarray(db, jnp.float32)
    if metric == "l2":
        sq = (qf * qf).sum(-1)[:, None] + (df * df).sum(-1)[None, :]
        d2 = sq - 2.0 * jnp.matmul(qf, df.T, precision=_HIGHEST)
        return jnp.sqrt(jnp.maximum(d2, 0.0))
    if metric == "cosine":
        qn = qf / jnp.maximum(jnp.linalg.norm(qf, axis=-1, keepdims=True), 1e-30)
        dn = df / jnp.maximum(jnp.linalg.norm(df, axis=-1, keepdims=True), 1e-30)
        return 1.0 - jnp.matmul(qn, dn.T, precision=_HIGHEST)
    if metric == "l1":
        chunks = []
        for st in range(0, df.shape[0], 512):
            blk = df[st:st + 512]
            chunks.append(jnp.abs(qf[:, None, :] - blk[None, :, :]).sum(-1))
        return jnp.concatenate(chunks, axis=1)
    raise ValueError(
        f"unknown metric {metric!r}: expected hamming | l1 | l2 | cosine")


@dataclasses.dataclass
class CoresetResult:
    ids: np.ndarray          # [C] database ids of coreset points
    weights: np.ndarray      # [C] number of points assigned
    assignment: np.ndarray   # [N] coreset member index per point
    cost: float              # sum of assignment distances


def distance_quantiles(sigs: np.ndarray, nb_rows: int = 256, seed: int = 0,
                       metric: str = "hamming") -> dict:
    """Sampled pairwise-distance quantiles (reference: CKMS sampling at
    hnswcore.rs:188-228): nb_rows randomly-chosen rows are scored against
    the whole database in one dense block (nb_rows * N sampled pairs)."""
    rng = np.random.default_rng(seed)
    n = sigs.shape[0]
    rows = rng.choice(n, size=min(nb_rows, n), replace=False)
    d = np.asarray(pairwise_distance(jnp.asarray(sigs[rows]), jnp.asarray(sigs), metric))
    qs = [0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99]
    return {str(q): float(np.quantile(d.ravel(), q)) for q in qs}


def build_coreset(
    sigs: np.ndarray, nb_coreset: int, seed: int = 0,
    metric: str = "hamming",
) -> CoresetResult:
    """D^2-sampled coreset with assignment weights."""
    rng = np.random.default_rng(seed)
    n = sigs.shape[0]
    c = min(nb_coreset, n)
    sig_dev = jnp.asarray(sigs)
    chosen = [int(rng.integers(0, n))]
    best_d = np.asarray(pairwise_distance(jnp.asarray(sigs[chosen]), sig_dev, metric))[0]
    # sample in growing rounds: a batch of new centers per sweep keeps the
    # number of device sweeps at O(log C) rather than O(C)
    while len(chosen) < c:
        batch = min(max(1, len(chosen)), c - len(chosen))
        p = best_d.astype(np.float64) ** 2
        p_sum = p.sum()
        if p_sum <= 0:
            extra = rng.choice(n, size=batch, replace=False)
        else:
            extra = rng.choice(n, size=batch, replace=False, p=p / p_sum)
        chosen.extend(int(e) for e in extra)
        d_new = np.asarray(pairwise_distance(jnp.asarray(sigs[extra]), sig_dev, metric))
        best_d = np.minimum(best_d, d_new.min(axis=0))
    ids = np.array(sorted(set(chosen))[:c], dtype=np.int64)
    d_all = np.asarray(pairwise_distance(jnp.asarray(sigs[ids]), sig_dev, metric))  # [C, N]
    assignment = d_all.argmin(axis=0)
    weights = np.bincount(assignment, minlength=len(ids))
    cost = float(d_all.min(axis=0).sum())
    return CoresetResult(ids=ids, weights=weights, assignment=assignment, cost=cost)


def cluster_coreset(
    sigs: np.ndarray, coreset: CoresetResult, nb_cluster: int, nb_iter: int = 10,
    seed: int = 0, metric: str = "hamming",
) -> CoresetResult:
    """Weighted medoid clustering OF the coreset, then dispatch of all
    points to the final medoids (reference: ClusterCoreset::{compute,
    dispatch}, hnswcore.rs:232-287)."""
    rng = np.random.default_rng(seed)
    core_sigs = sigs[coreset.ids]
    c = len(coreset.ids)
    k = min(nb_cluster, c)
    w = coreset.weights.astype(np.float64)
    d_cc = np.asarray(pairwise_distance(jnp.asarray(core_sigs), jnp.asarray(core_sigs), metric))
    medoids = list(rng.choice(c, size=k, replace=False))
    for _ in range(nb_iter):
        assign = d_cc[:, medoids].argmin(axis=1)
        new_medoids = []
        for j in range(k):
            members = np.where(assign == j)[0]
            if len(members) == 0:
                new_medoids.append(medoids[j])
                continue
            # weighted 1-medoid of the members
            sub = d_cc[np.ix_(members, members)] * w[members][None, :]
            new_medoids.append(int(members[sub.sum(axis=1).argmin()]))
        if new_medoids == medoids:
            break
        medoids = new_medoids
    medoid_ids = coreset.ids[medoids]
    d_all = np.asarray(pairwise_distance(jnp.asarray(sigs[medoid_ids]), jnp.asarray(sigs), metric))
    assignment = d_all.argmin(axis=0)
    weights = np.bincount(assignment, minlength=k)
    return CoresetResult(
        ids=medoid_ids, weights=weights, assignment=assignment,
        cost=float(d_all.min(axis=0).sum()),
    )


def dump_coreset_csv(res: CoresetResult, seqdict, path: str) -> None:
    with open(path, "w") as f:
        f.write("coreset_rank,data_id,path,weight\n")
        for rank, (i, w) in enumerate(zip(res.ids, res.weights)):
            f.write(f"{rank},{i},{seqdict[int(i)].id.path},{int(w)}\n")


def dump_cluster_csv(res: CoresetResult, seqdict, path: str) -> None:
    with open(path, "w") as f:
        f.write("data_id,path,cluster,medoid_data_id,medoid_path\n")
        for i, a in enumerate(res.assignment):
            m = int(res.ids[int(a)])
            f.write(f"{i},{seqdict[i].id.path},{int(a)},{m},{seqdict[m].id.path}\n")
