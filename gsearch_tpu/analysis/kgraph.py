"""k-NN graph extraction + statistics from a database index.

Capability-equivalent of annembed's fromhnsw module as used by the
reference (`kgraph_from_hnsw_all(hnsw, knbn)`, KGraph stats, Hubness;
reference call sites: src/utils/embed.rs:19-33, src/bin/hnsw2knn.rs:101-171).

On an accelerator the extraction is one batched self-search of the
database — the graph falls out of the same fused distance + top-k path as
requests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class KGraph:
    neighbors: np.ndarray  # int32 [N, K]
    distances: np.ndarray  # f32 [N, K]

    @property
    def nb_nodes(self) -> int:
        return self.neighbors.shape[0]

    @property
    def knbn(self) -> int:
        return self.neighbors.shape[1]

    def get_out_edges_by_idx(self, i: int):
        return list(zip(self.neighbors[i], self.distances[i]))

    def stats(self) -> dict:
        """Quantile statistics on first-neighbor distances
        (reference: kgraph.get_kraph_stats, embed.rs:26)."""
        d1 = self.distances[:, 0]
        qs = [0.05, 0.25, 0.5, 0.75, 0.95, 0.99]
        return {
            "nb_nodes": self.nb_nodes,
            "knbn": self.knbn,
            "first_dist_quantiles": {str(q): float(np.quantile(d1, q)) for q in qs},
            "mean_first_dist": float(d1.mean()),
            "max_dist": float(self.distances.max()),
        }


class Hubness:
    """In-degree (hubness) statistics of the k-NN digraph
    (reference: annembed Hubness::{get_standard3m, get_hubness_histogram},
    embed.rs:28-33)."""

    def __init__(self, kgraph: KGraph):
        self.kgraph = kgraph
        self.in_degree = np.bincount(
            kgraph.neighbors.ravel(), minlength=kgraph.nb_nodes
        ).astype(np.float64)

    def get_standard3m(self) -> float:
        """Standardized third moment (skewness) of the in-degree
        distribution — the classic hubness measure."""
        d = self.in_degree
        mu = d.mean()
        sd = d.std()
        if sd == 0:
            return 0.0
        return float(((d - mu) ** 3).mean() / sd**3)

    def get_hubness_histogram(self, nb_bins: int = 20) -> np.ndarray:
        hist, _ = np.histogram(self.in_degree, bins=nb_bins)
        return hist


def _exact_searcher(sigs: np.ndarray):
    """int8-GEMM sign-expansion + exact-rerank self-sweep when the database
    fits one device — a dense sweep instead of one graph beam per node.
    Returns None (caller falls back to index.search) without an
    accelerator or beyond the compact-mode ceiling."""
    from ..utils import device_profile

    prof = device_profile()
    if not prof.accelerated:
        return None
    from ..index.flat import FlatIndex
    from ..ops.mxu import MxuSearcher, planned_footprint

    n, s = sigs.shape
    if n < FlatIndex.MXU_MIN_POINTS:
        return None  # small index: plain search path is already instant
    _, rep_bytes = planned_footprint(n, s)
    if rep_bytes > prof.budget(FlatIndex.RESIDENT_FRACTION):
        return None
    searcher = MxuSearcher(sigs)
    return lambda q, k: searcher.search(q.astype(sigs.dtype), k)


def kgraph_from_index(index, knbn: int = 8, ef_search: int = 0,
                      batch: int = 4096) -> KGraph:
    """Self-search the database: k-NN graph over its own points.

    Queries stream in batches (one fused device dispatch each) so the N x N
    sweep never materializes on either side; self-match removal is
    vectorized (no per-node Python loop — the reference operating point is
    65k+ nodes, src/bin/gsearch.rs:537-561)."""
    import time as _time

    sigs = index.get_sigs()
    n = sigs.shape[0]
    ef = ef_search or max(64, 2 * (knbn + 1))
    out_ids = np.empty((n, knbn), dtype=np.int32)
    out_d = np.empty((n, knbn), dtype=np.float32)
    t0 = _time.perf_counter()
    search = _exact_searcher(sigs) or (
        lambda q, k: index.search(q, knbn=k, ef_search=ef))
    t_init = _time.perf_counter() - t0
    t_first = t_steady = 0.0
    for s in range(0, n, batch):
        e = min(n, s + batch)
        t0 = _time.perf_counter()
        d, ids = search(sigs[s:e], knbn + 1)
        if s == 0:
            t_first = _time.perf_counter() - t0  # includes jit compiles
        else:
            t_steady += _time.perf_counter() - t0
        ids = ids.astype(np.int32)
        # drop the self column: order non-self first (stable, keeps the
        # distance sort), then take knbn
        not_self = ids != np.arange(s, e, dtype=np.int32)[:, None]
        # rows where self never appeared (all k+1 are neighbors): drop last
        order = np.argsort(~not_self, axis=1, kind="stable")
        keep = order[:, :knbn]
        out_ids[s:e] = np.take_along_axis(ids, keep, axis=1)
        out_d[s:e] = np.take_along_axis(d, keep, axis=1)
    log.info(
        "kgraph %d nodes: searcher init %.1fs, first batch %.1fs "
        "(incl. jit), remaining %d batches %.1fs (%.0f q/s steady)",
        n, t_init, t_first, max((n - 1) // batch, 0), t_steady,
        (n - batch) / t_steady if t_steady > 0 else float("nan"))
    return KGraph(neighbors=out_ids, distances=out_d)
