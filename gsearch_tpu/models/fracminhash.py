"""FracMinHash (sourmash-style scaled MinHash) — the `superaai` engine.

Capability-equivalent of sourmash's KmerMinHash as used by the reference
(Murmur64Protein hashing, scaled + num sketch, `similarity`; reference call
sites: binaux/src/bin/superaai.rs:119-159).

A FracMinHash sketch keeps every k-mer whose hash falls below
2^32 / scaled — a variable-size bottom sketch whose intersection/union
over two genomes is an unbiased Jaccard estimator.  Device formulation: the
hash + threshold mask is one fused VPU pass over all k-mer windows; the
surviving hashes are extracted host-side (they are ~genome/scaled values,
a few thousand), deduplicated and sorted by numpy, and compared with
sorted-set intersections.  An optional `num` cap keeps only the smallest
`num` hashes (sourmash's num-MinHash mode).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.params import DataType, SeqSketcherParams
from ..models.base import SketcherBase, block_length
from ..ops.hash import mix2

_HASH_SEED = 0xF3AC5EED


class FracMinHashSketcher(SketcherBase):
    """sketch_size is reinterpreted as `scaled` (keep ~1/scaled of k-mers)."""

    SIG_DTYPE = np.uint32

    def __init__(self, params: SeqSketcherParams, seed: int = 0x5EED,
                 scaled: int = 500, num: Optional[int] = None):
        super().__init__(params, seed=seed)
        self.scaled = scaled
        self.num = num
        self._threshold = np.uint32(min(2**32 - 1, int(2**32 // scaled)))

    def _hash_fn(self, nb: int):
        if not hasattr(self, "_fn_cache"):
            self._fn_cache = {}
        if nb in self._fn_cache:
            return self._fn_cache[nb]
        def run(codes: jnp.ndarray):
            hi, lo, valid = self._windows(codes)
            h = mix2(hi, lo, self.seed ^ _HASH_SEED)
            keep = valid & (h < jnp.uint32(self._threshold))
            return jnp.where(keep, h, jnp.uint32(0xFFFFFFFF))

        self._fn_cache[nb] = jax.jit(run)
        return self._fn_cache[nb]

    def sketch_codes(self, codes: np.ndarray) -> np.ndarray:
        """Returns the sorted, deduplicated sub-threshold hash set."""
        n = len(codes)
        parts = []
        max_block = 1 << 22
        step = max_block - (self.k - 1)
        for start in range(0, max(n, 1), step):
            piece = codes[start : start + max_block]
            nb = block_length(len(piece))
            if len(piece) < nb:
                piece = np.pad(piece, (0, nb - len(piece)), constant_values=255)
            h = np.asarray(self._hash_fn(nb)(jnp.asarray(piece)))
            parts.append(h[h != 0xFFFFFFFF])
        hashes = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.uint32)
        if self.num is not None and len(hashes) > self.num:
            hashes = hashes[: self.num]
        return hashes


def similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Jaccard of two FracMinHash hash sets (sorted uint32 arrays)."""
    if len(a) == 0 and len(b) == 0:
        return 0.0
    inter = len(np.intersect1d(a, b, assume_unique=True))
    union = len(a) + len(b) - inter
    return inter / union if union else 0.0


def containment(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0:
        return 0.0
    return len(np.intersect1d(a, b, assume_unique=True)) / len(a)
