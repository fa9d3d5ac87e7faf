"""Sparse seed-and-chain ANI — the skani role ("superani" tool).

Capability-equivalent of the reference's superani binary, which drives a
skani fork (fastx_to_sketches -> chain_seeds -> ANI + aligned fractions;
reference: binaux/src/bin/superani.rs:39-147 with c=30, k=16, marker
m=1000).  skani estimates ANI from the identity rate of *chained* spaced
k-mer seeds, robust to rearrangement and incomplete assemblies, and
reports the aligned fraction of query and reference.

Device formulation:
  * seeds: canonical k-mers thinned to ~1/c by a hash threshold (the same
    fused window/hash kernel as every sketcher; positions kept) — the
    FracMinHash-style sketching skani calls fastx_to_sketches,
  * matching: seed hash sets of the two genomes joined by sorted merge,
  * chaining (chain_seeds role): anchors group into diagonal bands
    (qpos - rpos); within a band anchors are made collinear by a monotone
    filter over reference positions and split into chains at large
    query-position gaps.  Chains with too few anchors are noise and drop.
  * ANI: matched anchors over the query seeds that fall inside the chained
    query intervals (counted exactly from the seed position index, not a
    span/c estimate), inverted through the Binomial k-mer survival model
    ident^(1/k) — for point mutations (1-p)^k survival makes this exact.
  * AF_q / AF_r: merged-interval coverage of the chained anchors on each
    sequence (interval union, so overlapping chains never double-count).

skani's learned regression correction (superani.rs:107,129-131
regression::{get_model,predict_from_ani_res}): `AniRegression.load(path)`
reads a JSON coefficient file and post-corrects (ani, af) predictions.
The superani CLI applies the bundled fitted model by default (like the
reference, which always applies regression::get_model); pass
`--model none` for the raw chained seed-identity ANI, which is exact on
clean point-mutation ladders.  SeedChainer constructed directly defaults
to identity.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.base import block_length
from ..ops.hash import mix2
from ..ops.kmer import canonical_dna_windows

_SEED = 0x5CA41
_BAND = 2048      # diagonal band width (bases); tolerates ~2kb of indel drift
_MAX_GAP = 5000   # query-gap that breaks a chain (skani's chaining gap role)
_MIN_CHAIN = 3    # anchors needed for a chain to count


@dataclasses.dataclass
class SeedSketch:
    hashes: np.ndarray     # sorted uint32 (unique)
    positions: np.ndarray  # position of first occurrence of each hash
    length: int            # genome length in bases
    c: int                 # spacing (1 seed per ~c bases)


class AniRegression:
    """Debiasing correction in the role of skani's learned regression
    model (superani.rs:107,129-131: regression::get_model(c, true) is
    ALWAYS applied by the reference).  Coefficients live in a JSON file —
    either one linear map {"intercept": b, "ani": w1, "af": w2} over
    (raw_ani, mean_af), or the piecewise form {"split": s, "segments":
    [low, high]} with one linear map per raw-ANI segment.

    The bundled default (models/data/ani_regression_default.json) was fit
    by scripts/fit_ani_regression.py on synthetic ladders spanning
    80-100% ANI x {clean, fragmented, rearranged} genome pairs; fit
    quality is recorded in ANI_REGRESSION_FIT.json.  `load(None)` returns
    it; `load("none")` returns the identity (raw chained seed-identity
    ANI, exact on clean mutation ladders)."""

    DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "ani_regression_default.json")

    def __init__(self, segments=None, split: float = float("inf")):
        # identity default: one segment, w_ani=1
        self.split = split
        self.segments = segments or [(0.0, 1.0, 0.0)]

    @classmethod
    def identity(cls) -> "AniRegression":
        return cls()

    @classmethod
    def load(cls, path: Optional[str]) -> "AniRegression":
        if path is None:
            path = cls.DEFAULT_PATH if os.path.exists(cls.DEFAULT_PATH) else ""
        if not path or path == "none":
            return cls()
        with open(path) as f:
            d = json.load(f)
        if "segments" in d:
            segs = [(s.get("intercept", 0.0), s.get("ani", 1.0),
                     s.get("af", 0.0)) for s in d["segments"]]
            return cls(segs, float(d.get("split", float("inf"))))
        return cls([(d.get("intercept", 0.0), d.get("ani", 1.0),
                     d.get("af", 0.0))])

    def predict(self, ani: float, af: float) -> float:
        i = 0 if (ani < self.split or len(self.segments) == 1) else 1
        b, w_ani, w_af = self.segments[i]
        out = b + w_ani * ani + w_af * af
        return float(min(max(out, 0.0), 100.0))


def _merge_intervals(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Union of [start, end) intervals; returns merged (starts, ends)."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts)
    s, e = starts[order], ends[order]
    ms, me = [s[0]], [e[0]]
    for i in range(1, len(s)):
        if s[i] <= me[-1]:
            me[-1] = max(me[-1], e[i])
        else:
            ms.append(s[i])
            me.append(e[i])
    return np.asarray(ms), np.asarray(me)


class SeedChainer:
    def __init__(self, k: int = 16, c: int = 30, seed: int = _SEED,
                 regression: Optional[AniRegression] = None):
        self.k = k
        self.c = c
        self.seed = seed
        self.regression = regression or AniRegression()
        self._threshold = np.uint32(int(2**32 // c))

    def _seed_fn(self, nb: int):
        if not hasattr(self, "_fn_cache"):
            self._fn_cache = {}
        if nb in self._fn_cache:
            return self._fn_cache[nb]

        def run(codes: jnp.ndarray):
            hi, lo, valid = canonical_dna_windows(codes, self.k)
            h = mix2(hi, lo, self.seed)
            keep = valid & (h < jnp.uint32(self._threshold))
            return jnp.where(keep, h, jnp.uint32(0xFFFFFFFF))

        self._fn_cache[nb] = jax.jit(run)
        return self._fn_cache[nb]

    def sketch(self, codes: np.ndarray) -> SeedSketch:
        n = len(codes)
        hs, ps = [], []
        max_block = 1 << 22
        step = max_block - (self.k - 1)
        for start in range(0, max(n, 1), step):
            piece = codes[start : start + max_block]
            nb = block_length(len(piece))
            if len(piece) < nb:
                piece = np.pad(piece, (0, nb - len(piece)), constant_values=255)
            h = np.asarray(self._seed_fn(nb)(jnp.asarray(piece)))
            sel = np.nonzero(h != 0xFFFFFFFF)[0]
            hs.append(h[sel])
            ps.append(sel + start)
        h = np.concatenate(hs) if hs else np.empty(0, np.uint32)
        p = np.concatenate(ps) if ps else np.empty(0, np.int64)
        # unique seeds only (repeats are ambiguous anchors; skani filters too)
        uh, idx, counts = np.unique(h, return_index=True, return_counts=True)
        keep = counts == 1
        return SeedSketch(hashes=uh[keep], positions=p[idx[keep]], length=n, c=self.c)

    def _chains(self, qp: np.ndarray, rp: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Collinear chains from matched anchors: band by diagonal, make
        each band monotone in reference position, split at query gaps."""
        diag = (qp - rp) // _BAND
        chains: List[Tuple[np.ndarray, np.ndarray]] = []
        for b in np.unique(diag):
            m = diag == b
            q_b, r_b = qp[m], rp[m]
            order = np.argsort(q_b)
            q_b, r_b = q_b[order], r_b[order]
            # monotone filter: drop anchors whose ref position regresses
            # (running-max check keeps the collinear subsequence greedily)
            keep = np.maximum.accumulate(r_b) == r_b
            q_b, r_b = q_b[keep], r_b[keep]
            if len(q_b) < _MIN_CHAIN:
                continue
            # split at large query gaps
            brk = np.nonzero(np.diff(q_b) > _MAX_GAP)[0] + 1
            for seg_q, seg_r in zip(np.split(q_b, brk), np.split(r_b, brk)):
                if len(seg_q) >= _MIN_CHAIN:
                    chains.append((seg_q, seg_r))
        return chains

    def compare(self, q: SeedSketch, r: SeedSketch) -> Tuple[float, float, float]:
        """Returns (ani_percent, af_query, af_ref)."""
        if len(q.hashes) == 0 or len(r.hashes) == 0:
            return 0.0, 0.0, 0.0
        # sorted-merge join of the seed sets
        common, qi, ri = np.intersect1d(q.hashes, r.hashes, assume_unique=True,
                                        return_indices=True)
        if len(common) < _MIN_CHAIN:
            return 0.0, 0.0, 0.0
        qp = q.positions[qi].astype(np.int64)
        rp = r.positions[ri].astype(np.int64)

        chains = self._chains(qp, rp)
        if not chains:
            return 0.0, 0.0, 0.0

        ext = self.k  # an anchor covers [pos, pos + k)
        qs = np.asarray([c[0][0] for c in chains])
        qe = np.asarray([c[0][-1] + ext for c in chains])
        rs = np.asarray([c[1].min() for c in chains])
        re = np.asarray([c[1].max() + ext for c in chains])
        mqs, mqe = _merge_intervals(qs, qe)
        mrs, mre = _merge_intervals(rs, re)
        aligned_q = int((mqe - mqs).sum())
        aligned_r = int((mre - mrs).sum())
        af_q = min(1.0, aligned_q / max(q.length, 1))
        af_r = min(1.0, aligned_r / max(r.length, 1))

        # identity = matched anchors / query seeds inside the chained query
        # intervals (exact count via the sorted position index)
        n_match = int(sum(len(c[0]) for c in chains))
        qpos_sorted = np.sort(q.positions)
        in_aligned = int(
            (np.searchsorted(qpos_sorted, mqe) - np.searchsorted(qpos_sorted, mqs)).sum()
        )
        ident = min(1.0, n_match / max(in_aligned, 1))
        # Binomial k-mer survival inversion: (1-p)^k = ident  =>
        # ANI = 100 * ident^(1/k)  (reference reformat model 2,
        # src/bin/reformat.rs:84; exact for point mutations)
        ani = 100.0 * float(ident) ** (1.0 / self.k)
        ani = self.regression.predict(ani, 0.5 * (af_q + af_r))
        return float(max(ani, 0.0)), af_q, af_r
