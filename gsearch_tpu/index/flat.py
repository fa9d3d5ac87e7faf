"""Flat (exact) sketch index: brute-force top-k on device.

Role: the correctness oracle for the ANN index and the small/medium-database
fast path.  On an accelerator, search over tens of thousands of genome
sketches is one int8 GEMM sweep plus an exact rerank (ops/mxu.py), so
"exact" is both faster and higher-recall than graph traversal at GTDB
scale — pointer-chasing only pays off for much larger corpora (then see
hnsw.py).

API parity targets: Hnsw::parallel_insert (src/dna/dnasketch.rs:435) ->
`insert`; Hnsw::parallel_search (src/dna/dnarequest.rs:353) -> `search`
(ef_search is accepted and ignored — exact search has no beam).
"""

from __future__ import annotations

from typing import Tuple


import jax.numpy as jnp
import numpy as np


from ..utils import get_logger

log = get_logger(__name__)


class FlatIndex:
    KIND = "flat"

    def __init__(self, sketch_size: int, sig_dtype, capacity: int = 0):
        self.sketch_size = sketch_size
        self.sig_dtype = np.dtype(sig_dtype)
        self._sigs = np.empty((0, sketch_size), dtype=self.sig_dtype)
        self._device_sigs = None
        self._mxu = None

    @property
    def nb_points(self) -> int:
        return self._sigs.shape[0]

    def get_nb_point(self) -> int:  # reference-parity name (dnasketch.rs:437)
        return self.nb_points

    # databases at least this large route searches through the int8 GEMM
    # sign-expansion estimator + exact rerank (on an accelerator)
    MXU_MIN_POINTS = 4096
    # the source signatures stay on device next to the searcher only while
    # both fit this share of its memory
    RESIDENT_FRACTION = 0.8125

    def insert(self, sigs) -> None:
        """Append a batch of signatures; ids are assigned consecutively
        (the SeqDict rank IS the data id, idsketch.rs:152-154).

        Accepts numpy OR a device array (jax.Array): device-resident
        signatures (e.g. straight from the on-device sketcher or a
        device-side corpus generator) are kept on device — no host
        round-trip."""
        assert sigs.shape[1] == self.sketch_size
        import jax

        if isinstance(sigs, jax.Array) and not isinstance(sigs, np.ndarray):
            sigs = sigs.astype(self.sig_dtype)
            if self.nb_points == 0:
                self._sigs = sigs
            else:
                prev = (self._sigs if isinstance(self._sigs, jax.Array)
                        else jnp.asarray(self._sigs))
                self._sigs = jnp.concatenate([prev, sigs], axis=0)
            self._device_sigs = self._sigs
            self._mxu = None
            return
        if not isinstance(self._sigs, np.ndarray):
            self._sigs = np.asarray(self._sigs)  # mixed insert: back to host
        self._sigs = np.concatenate([self._sigs, sigs.astype(self.sig_dtype)], axis=0)
        self._device_sigs = None  # device copy is stale
        self._mxu = None

    def _device(self):
        if self._device_sigs is None:
            self._device_sigs = jnp.asarray(self._sigs)
        return self._device_sigs

    def search(
        self, queries: np.ndarray, knbn: int, ef_search: int = 0
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched k-NN. Returns (distances [Q, k], ids [Q, k])."""
        del ef_search
        if self.nb_points == 0:
            q = queries.shape[0]
            return np.full((q, 0), np.inf, np.float32), np.zeros((q, 0), np.int32)
        import jax

        from ..utils import device_profile

        if (device_profile().accelerated
                and self.nb_points >= self.MXU_MIN_POINTS):
            # throughput path: int8 GEMM estimator + exact rerank
            # (ops/mxu.py); returned distances are bit-exact equal-count
            # values (compact mode near the memory limit: near-exact)
            if self._mxu is None:
                from ..ops.mxu import MxuSearcher, planned_footprint

                sigs = self._sigs
                _, rep_bytes = planned_footprint(self.nb_points, self.sketch_size)
                if (isinstance(sigs, jax.Array) and not isinstance(sigs, np.ndarray)
                        and sigs.nbytes + rep_bytes
                        > device_profile().budget(self.RESIDENT_FRACTION)):
                    # source + searcher representations cannot coexist on
                    # the device: stage through the host once and free the
                    # device copy
                    sigs = np.asarray(sigs)
                    self._sigs = sigs
                    self._device_sigs = None
                self._mxu = MxuSearcher(sigs)
            return self._mxu.search(queries.astype(self.sig_dtype), knbn)
        from ..ops.distance import bucketed_knn

        return bucketed_knn(queries.astype(self.sig_dtype), self._sigs, knbn)

    def get_sigs(self) -> np.ndarray:
        return self._sigs

    # --- persistence ---------------------------------------------------------

    def save_arrays(self, prefix: str) -> dict:
        np.save(prefix + ".sigs.npy", self._sigs)
        return {"sig_file": "index.sigs.npy"}

    @classmethod
    def load_arrays(cls, prefix: str, meta: dict) -> "FlatIndex":
        sigs = np.load(prefix + ".sigs.npy")
        idx = cls(sketch_size=sigs.shape[1], sig_dtype=sigs.dtype)
        idx._sigs = sigs
        return idx
