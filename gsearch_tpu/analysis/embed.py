"""UMAP-like 2-D embedding of a sketch database — the `ann` subcommand.

Capability-equivalent of annembed's Embedder as driven by the reference
(reference: src/utils/embed.rs:14-77 — EmbedderParams{nb_grad_batch=15,
scale_rho=0.75, beta=1, grad_step=3, nb_sampling_by_edge=10,
dmap_init=true}, output `database_embedded.csv`, quality estimate from
edge lengths; CLI dispatch src/bin/gsearch.rs:784-852).

Device formulation: annembed runs asynchronous per-edge SGD with
negative sampling; here each optimization step is a *full-batch* fused
update — attractive forces from all k-NN edges and repulsive forces from
fresh uniform negatives per edge, accumulated with scatter-adds.  One
asynchronous annembed "grad batch" (each edge visited ~nb_sampling_by_edge
times with per-visit updates) is strictly stronger than one synchronous
full-batch step, so each grad batch maps to EPOCHS_PER_BATCH full-batch
steps with a linearly decaying step size (UMAP's schedule) and UMAP's
per-component gradient clipping — still an embarrassingly parallel
gather/scatter-add over [N*K] edges per step, the shape a VPU wants, and
it needs no BLAS feature gate (the reference only compiles `ann` with
one, src/utils/mod.rs:10-11).

Initialization is hierarchical above HIER_THRESHOLD points, following the
reference's own recipe for large layers (embed.rs:51-54 uses hierarchical
init from the hnsw upper layer when it holds >30k points): landmarks are
sampled, every point is assigned to its graph-nearest landmark
(vectorized Bellman-Ford over the k-NN edges), the coarse landmark graph
(aggregated inter-cluster edge weights) is embedded first with full
optimization, and fine points start at their landmark's position plus
jitter.  Below the threshold a diffusion-map-flavored init (power
iterations of the normalized affinity) is used directly — at small N it
is well-conditioned; at 65k it degenerated (most mass collapsing toward
the origin) and 15 raw steps could not recover, which produced the
round-4 embed_quality 1.60 > 1 failure this design removes.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..utils import get_logger
from .kgraph import Hubness, KGraph, kgraph_from_index

log = get_logger(__name__)


@dataclasses.dataclass
class EmbedderParams:
    """(reference defaults at embed.rs:40-47)"""

    nb_grad_batch: int = 15
    scale_rho: float = 0.75
    beta: float = 1.0
    grad_step: float = 3.0
    nb_sampling_by_edge: int = 10
    dmap_init: bool = True
    dim: int = 2
    #: full-batch steps per reference "grad batch" (see module docstring)
    epochs_per_batch: int = 20
    #: hierarchical init above this many points (reference: embed.rs:51-54)
    hier_threshold: int = 30_000
    #: landmark count for hierarchical init; 0 = auto (~n/32, in [1k, 16k])
    n_landmarks: int = 0


class Embedder:
    def __init__(self, kgraph: KGraph, params: EmbedderParams | None = None, seed: int = 0):
        self.kgraph = kgraph
        self.params = params or EmbedderParams()
        self.seed = seed
        self._embedded: np.ndarray | None = None

    # -- affinity weights (UMAP-style local scaling) --------------------------

    def _edge_weights(self) -> np.ndarray:
        d = self.kgraph.distances.astype(np.float64)
        rho = d.min(axis=1, keepdims=True)
        scale = np.maximum((d - rho).mean(axis=1, keepdims=True) * self.params.scale_rho, 1e-9)
        w = np.exp(-np.maximum(d - rho, 0.0) / scale)
        return w.astype(np.float32)

    def _dmap_init(self, w: np.ndarray, nbrs: np.ndarray) -> np.ndarray:
        """Diffusion-map-flavored init: power iterations of the normalized
        affinity, orthogonalized, as starting coordinates (small-N path)."""
        n = nbrs.shape[0]
        rng = np.random.default_rng(self.seed)
        y = rng.normal(size=(n, self.params.dim)).astype(np.float32)
        deg = np.maximum(w.sum(axis=1), 1e-9)
        for _ in range(12):
            # y <- D^-1 (W y) over the sparse k-NN edges
            msg = (w[:, :, None] * y[nbrs]).sum(axis=1)
            y = msg / deg[:, None]
            y = y - y.mean(axis=0, keepdims=True)
            # orthogonalize to stop collapse onto the lead eigenvector
            qy, _ = np.linalg.qr(y)
            y = qy.astype(np.float32)
        # scale to a sane extent
        return (y / max(np.abs(y).max(), 1e-9) * 10.0).astype(np.float32)

    # -- hierarchical init ----------------------------------------------------

    def _assign_landmarks(self, nbrs: np.ndarray, dist: np.ndarray,
                          marks: np.ndarray) -> np.ndarray:
        """Graph-nearest landmark per point: vectorized multi-source
        Bellman-Ford over the (symmetrized-by-use) k-NN edges."""
        n, k = nbrs.shape
        dl = np.full(n, np.inf, np.float32)
        lab = np.full(n, -1, np.int64)
        dl[marks] = 0.0
        lab[marks] = np.arange(len(marks))
        d32 = np.maximum(dist.astype(np.float32), 1e-7)
        for _ in range(30):
            # relax forward edges i -> nbrs[i]
            cand = dl[nbrs] + d32            # [n, k]
            j = np.argmin(cand, axis=1)
            best = cand[np.arange(n), j]
            take = best < dl
            if not take.any():
                break
            dl = np.where(take, best, dl)
            lab = np.where(take, lab[nbrs[np.arange(n), j]], lab)
        # disconnected leftovers: round-robin over landmarks
        miss = lab < 0
        if miss.any():
            lab[miss] = np.arange(int(miss.sum())) % len(marks)
        return lab

    def _coarse_graph(self, nbrs, w, lab, m, kc=16):
        """Aggregate inter-cluster edge weights into a fixed-shape coarse
        k-NN-graph-like (neighbors, weights) pair over the m landmarks."""
        n, k = nbrs.shape
        li = np.repeat(lab, k)
        lj = lab[nbrs.ravel()]
        ww = w.ravel().astype(np.float64)
        keep = li != lj
        li, lj, ww = li[keep], lj[keep], ww[keep]
        # aggregate parallel edges
        key = li * m + lj
        uk, inv = np.unique(key, return_inverse=True)
        agg = np.zeros(len(uk))
        np.add.at(agg, inv, ww)
        ci, cj = uk // m, uk % m
        # top-kc per coarse node by aggregated weight
        cn = np.zeros((m, kc), np.int32)
        cw = np.zeros((m, kc), np.float32)
        order = np.lexsort((-agg, ci))
        ci_o, cj_o, agg_o = ci[order], cj[order], agg[order]
        starts = np.searchsorted(ci_o, np.arange(m + 1))
        for a in range(m):
            s, e = starts[a], min(starts[a + 1], starts[a] + kc)
            cnt = e - s
            cn[a, :cnt] = cj_o[s:e]
            cw[a, :cnt] = agg_o[s:e]
            if cnt == 0:  # isolated landmark: self-loop carries no force
                cn[a, :] = a
        return cn, cw

    def _hier_init(self, nbrs, dist, w, rng) -> np.ndarray:
        p = self.params
        n = nbrs.shape[0]
        m = p.n_landmarks or int(np.clip(n // 32, 1024, 16384))
        m = min(m, n)
        marks = rng.choice(n, size=m, replace=False)
        lab = self._assign_landmarks(nbrs, dist, marks)
        cn, cw = self._coarse_graph(nbrs, w, lab, m)
        log.info("hierarchical init: %d landmarks, coarse graph built", m)
        y0c = self._dmap_init(np.maximum(cw, 1e-9), cn)
        yc = self._optimize(cn, cw, y0c, rng_seed=self.seed + 1)
        # fine points start at their landmark, jittered by the coarse
        # layout's local scale so clusters are blobs, not points
        ext = float(np.abs(yc).max()) or 1.0
        y = yc[lab] + rng.normal(size=(n, p.dim)).astype(np.float32) * (0.01 * ext)
        return y.astype(np.float32)

    # -- optimization ----------------------------------------------------------

    def _optimize(self, nbrs: np.ndarray, w: np.ndarray, y0: np.ndarray,
                  rng_seed: int) -> np.ndarray:
        """Full-batch UMAP-style layout of one graph level on device."""
        import jax
        import jax.numpy as jnp

        p = self.params
        n, k = nbrs.shape
        src = np.repeat(np.arange(n, dtype=np.int32), k)
        dst = nbrs.ravel().astype(np.int32)
        ew = w.ravel().astype(np.float32)
        # normalize so the strongest edge pulls with unit weight; zero-weight
        # pad edges (coarse graphs) contribute nothing
        ew = ew / max(float(ew.max()), 1e-12)

        total = max(int(p.nb_grad_batch * p.epochs_per_batch), 1)
        src_j = jnp.asarray(src)
        dst_j = jnp.asarray(dst)
        ew_j = jnp.asarray(ew)
        beta = jnp.float32(p.beta)
        nneg = max(int(p.nb_sampling_by_edge), 1)
        # per-point step size: the scatter-add accumulates ~k clipped
        # per-edge forces, so normalize by k (UMAP applies them one at a
        # time at lr ~ grad_step/k-equivalent)
        base_lr = jnp.float32(p.grad_step / (4.0 * k))

        def step(y, ins):
            key, t = ins
            yi = y[src_j]
            yj = y[dst_j]
            diff = yi - yj
            d2 = (diff * diff).sum(-1, keepdims=True)
            # attraction: UMAP gradient with a=b=1 generalized by beta,
            # per-component clipped to +-4 (UMAP's stability trick)
            attr = jnp.clip((-2.0 * beta) * diff / (1.0 + d2), -4.0, 4.0)
            attr = ew_j[:, None] * attr
            g = jnp.zeros_like(y).at[src_j].add(attr)
            g = g.at[dst_j].add(-attr)

            # repulsion: fresh uniform negatives per edge per sampling round
            def neg_round(gacc, kk):
                negs = jax.random.randint(kk, (src_j.shape[0],), 0, n)
                yn = y[negs]
                diffn = yi - yn
                dn2 = (diffn * diffn).sum(-1, keepdims=True)
                rep = jnp.clip(2.0 * diffn / ((0.01 + dn2) * (1.0 + dn2)),
                               -4.0, 4.0)
                gacc = gacc.at[src_j].add(rep / nneg)
                return gacc, None

            keys = jax.random.split(key, nneg)
            g, _ = jax.lax.scan(neg_round, g, keys)
            lr = base_lr * (1.0 - t / total)  # UMAP's linear decay
            y = y + lr * g
            return y, None

        y = jnp.asarray(y0)
        keys = jax.random.split(jax.random.PRNGKey(rng_seed), total)
        ts = jnp.arange(total, dtype=jnp.float32)
        y, _ = jax.jit(
            lambda y, ks, ts: jax.lax.scan(step, y, (ks, ts))
        )(y, keys, ts)
        return np.asarray(y)

    def embed(self) -> np.ndarray:
        p = self.params
        nbrs = self.kgraph.neighbors.astype(np.int32)
        dist = self.kgraph.distances
        w = self._edge_weights()
        n = nbrs.shape[0]
        rng = np.random.default_rng(self.seed)

        if n > p.hier_threshold:
            y0 = self._hier_init(nbrs, dist, w, rng)
        elif p.dmap_init:
            y0 = self._dmap_init(w, nbrs)
        else:
            y0 = rng.normal(size=(n, p.dim)).astype(np.float32) * 10

        self._embedded = self._optimize(nbrs, w, y0, rng_seed=self.seed)
        return self._embedded

    def get_embedded_reindexed(self) -> np.ndarray:
        assert self._embedded is not None
        return self._embedded

    def get_quality_estimate_from_edge_length(self, nb_sample: int = 200) -> float:
        """Mean embedded-length of graph edges over mean length of random
        pairs — small is good (reference: embed.rs:69-70)."""
        assert self._embedded is not None
        y = self._embedded
        rng = np.random.default_rng(1)
        e_len = np.linalg.norm(
            y[self.kgraph.neighbors[:, 0]] - y, axis=1
        ).mean()
        a = rng.integers(0, len(y), nb_sample)
        b = rng.integers(0, len(y), nb_sample)
        r_len = np.linalg.norm(y[a] - y[b], axis=1).mean()
        return float(e_len / max(r_len, 1e-12))


def get_graph_stats_embed(
    db_dir: str,
    ask_stats: bool = True,
    embed: bool = False,
    knbn: int = 8,
    params: EmbedderParams | None = None,
    out_dir: str = ".",
) -> dict:
    """The `ann` workflow (reference: SURVEY.md §3.4)."""
    from ..index.serialize import load_index

    index = load_index(db_dir)
    kgraph = kgraph_from_index(index, knbn=knbn)
    stats = kgraph.stats()
    hub = Hubness(kgraph)
    s3m = hub.get_standard3m()
    hist = hub.get_hubness_histogram()
    summary = (
        f"kgraph: {stats['nb_nodes']} nodes, knbn={knbn}; "
        f"first-dist median {stats['first_dist_quantiles']['0.5']:.4f}; "
        f"hubness (standard 3rd moment): {s3m:.3e}"
    )
    result = {"stats": stats, "hubness_s3m": s3m, "hubness_hist": hist.tolist(), "summary": summary}
    if embed:
        embedder = Embedder(kgraph, params)
        y = embedder.embed()
        csv_path = os.path.join(out_dir, "database_embedded.csv")
        np.savetxt(csv_path, y, delimiter=",", fmt="%.6e")
        q = embedder.get_quality_estimate_from_edge_length(200)
        result["embedded_csv"] = csv_path
        result["quality"] = q
        result["summary"] += f"; embedded -> {csv_path} (quality {q:.3f})"
    return result
