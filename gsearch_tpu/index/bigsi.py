"""BIGSI — bit-sliced Bloom-filter signature index for read classification.

Capability-equivalent of the bigsig crate as used by the reference's
`bigsig` binary (reference: binaux/src/bin/bigsig.rs:18-511 — construct a
bit-sliced Bloom index over genomes in k-mer or minimizer mode with
configurable Bloom length / hash count; identify streaming reads against it
with a false-positive correction; README.md:456-531).

Index layout (device-first): the classic BIGSI bit matrix is stored as
uint32 words [bloom_len, ceil(N/32)] — row r is the N-genome bit slice of
Bloom position r.  A read batch classifies as:

    k-mers [R, L] -> h hash positions -> gather h row-slices [R, L, h, Nw]
    -> AND over h -> popcount (lax.population_count) -> per-genome hit
    counts [R, N] in one fused pass.  No per-read loops, no bit twiddling
    on the host.

Minimizer mode thins the k-mer stream to window minima of the k-mer hashes
(jax.lax.reduce_window min), cutting query and index density ~w-fold as in
the reference's `_mini` builders.
"""

from __future__ import annotations

import functools
import json

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hash import mix2
from ..ops.kmer import canonical_dna_windows
from ..utils import get_logger

log = get_logger(__name__)

_POS_SEED = 0xB165B165


def _binom_sf_log10(k: int, n: int, p: float) -> float:
    """log10 P(X >= k), X ~ Binomial(n, p) — exact via log-gamma sums.
    n is a read's k-mer count (hundreds), so the direct sum is cheap."""
    import math

    if k <= 0:
        return 0.0
    if p <= 0.0:
        return -math.inf
    if p >= 1.0:
        return 0.0
    lp, lq = math.log(p), math.log1p(-p)
    lgn = math.lgamma(n + 1)
    terms = [
        lgn - math.lgamma(j + 1) - math.lgamma(n - j + 1) + j * lp + (n - j) * lq
        for j in range(k, n + 1)
    ]
    m = max(terms)
    return (m + math.log(sum(math.exp(t - m) for t in terms))) / math.log(10)


class BigsiIndex:
    def __init__(self, bloom_len: int, nb_hashes: int, kmer_size: int,
                 minimizer_window: int = 0, seed: int = 0x5EED):
        # per-instance jit caches; classify programs capture the bloom
        # matrix, so they are invalidated on every insert
        self._fn_cache: dict = {}
        self.bloom_len = bloom_len
        self.nb_hashes = nb_hashes
        self.kmer_size = kmer_size
        self.minimizer_window = minimizer_window  # 0 = plain k-mer mode
        self.seed = seed
        self.names: List[str] = []
        self._bits: Optional[np.ndarray] = None  # uint32 [bloom_len, Nw]
        self._ones_per_genome: List[int] = []

    @property
    def nb_genomes(self) -> int:
        return len(self.names)

    # ------------------------------------------------------------- device ops

    def _positions_fn(self, nb: int):
        """codes [nb] -> (positions [h, nb] int32, valid [nb] bool)."""
        ck = ("pos", nb)
        if ck in self._fn_cache:
            return self._fn_cache[ck]

        def run(codes: jnp.ndarray):
            hi, lo, valid = canonical_dna_windows(codes, self.kmer_size)
            if self.minimizer_window > 1:
                w = self.minimizer_window
                h = mix2(hi, lo, self.seed ^ 0x3141)
                h = jnp.where(valid, h, jnp.uint32(0xFFFFFFFF))
                # a window position survives iff it is the minimum of its
                # w-window (standard minimizer selection)
                wmin = jax.lax.reduce_window(
                    h, jnp.uint32(0xFFFFFFFF), jax.lax.min, (w,), (1,), "SAME"
                )
                valid = valid & (h == wmin)
            pos = []
            for j in range(self.nb_hashes):
                p = mix2(hi, lo, self.seed ^ _POS_SEED ^ (j * 0x9E3779B9)) % jnp.uint32(
                    self.bloom_len
                )
                pos.append(p.astype(jnp.int32))
            return jnp.stack(pos), valid

        self._fn_cache[ck] = jax.jit(run)
        return self._fn_cache[ck]

    def _genome_positions(self, codes: np.ndarray) -> np.ndarray:
        """All Bloom positions set by a genome (host-side build path)."""
        from ..models.base import block_length

        out = []
        max_block = 1 << 22
        step = max_block - (self.kmer_size - 1)
        for start in range(0, max(len(codes), 1), step):
            piece = codes[start : start + max_block]
            nb = block_length(len(piece))
            if len(piece) < nb:
                piece = np.pad(piece, (0, nb - len(piece)), constant_values=255)
            pos, valid = self._positions_fn(nb)(jnp.asarray(piece))
            pos, valid = np.asarray(pos), np.asarray(valid)
            out.append(pos[:, valid].ravel())
        return np.unique(np.concatenate(out)) if out else np.empty(0, np.int64)

    # ------------------------------------------------------------------ build

    def insert_genome(self, name: str, codes: np.ndarray) -> None:
        """Set this genome's bit column (reference: build::build_single /
        build_single_mini, bigsig.rs:236-317)."""
        j = len(self.names)
        self.names.append(name)
        # classify programs baked the previous bloom matrix: invalidate
        self._fn_cache = {k: v for k, v in self._fn_cache.items() if k[0] != "cls"}
        nw_needed = (j // 32) + 1
        if self._bits is None:
            self._bits = np.zeros((self.bloom_len, nw_needed), dtype=np.uint32)
        elif self._bits.shape[1] < nw_needed:
            pad = np.zeros((self.bloom_len, nw_needed - self._bits.shape[1]), np.uint32)
            self._bits = np.concatenate([self._bits, pad], axis=1)
        pos = self._genome_positions(codes)
        self._bits[pos, j // 32] |= np.uint32(1 << (j % 32))
        self._ones_per_genome.append(len(pos))

    # ------------------------------------------------------------------ query

    def _classify_fn(self, read_len: int, batch: int, down_sample: int = 1):
        ck = ("cls", read_len, batch, down_sample)
        if ck in self._fn_cache:
            return self._fn_cache[ck]
        nw = self._bits.shape[1]
        bloom = jnp.asarray(self._bits)

        def run_bits(codes: jnp.ndarray):  # [batch, read_len]
            hi, lo, valid = canonical_dna_windows(codes, self.kmer_size)
            if down_sample > 1:
                # probe every Nth k-mer position (identify --down_sample,
                # reference: bigsig.rs:332-335)
                keep = jnp.arange(valid.shape[1]) % down_sample == 0
                valid = valid & keep[None, :]
            if self.minimizer_window > 1:
                # thin query k-mers exactly like the index build
                w = self.minimizer_window
                hmin = mix2(hi, lo, self.seed ^ 0x3141)
                hmin = jnp.where(valid, hmin, jnp.uint32(0xFFFFFFFF))
                wmin = jax.lax.reduce_window(
                    hmin, jnp.uint32(0xFFFFFFFF), jax.lax.min, (1, w), (1, 1), "SAME"
                )
                valid = valid & (hmin == wmin)
            agg = None
            for j in range(self.nb_hashes):
                p = mix2(hi, lo, self.seed ^ _POS_SEED ^ (j * 0x9E3779B9)) % jnp.uint32(
                    self.bloom_len
                )
                s = jnp.take(bloom, p.astype(jnp.int32), axis=0)
                agg = s if agg is None else (agg & s)
            agg = jnp.where(valid[..., None], agg, jnp.uint32(0))
            # expand word bits -> per-genome membership, sum over k-mers
            shifts = jnp.arange(32, dtype=jnp.uint32)
            bits = (agg[..., None] >> shifts) & jnp.uint32(1)  # [B, L, Nw, 32]
            counts = bits.astype(jnp.int32).sum(axis=1).reshape(codes.shape[0], nw * 32)
            return counts, valid.sum(axis=-1).astype(jnp.int32)

        self._fn_cache[ck] = jax.jit(run_bits)
        return self._fn_cache[ck]

    def raw_counts(
        self, reads: np.ndarray, down_sample: int = 1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-read per-genome k-mer hit counts + probed k-mer totals
        ([R, G] i32, [R] i32) — the device pass behind classify; exposed so
        paired-end callers can sum both mates' counts before scoring
        (reference: per_read_stream_pe, bigsig.rs:382-397)."""
        r, l = reads.shape
        counts, totals = self._classify_fn(l, r, down_sample)(jnp.asarray(reads))
        return np.asarray(counts)[:, : self.nb_genomes], np.asarray(totals)

    def fp_rates(self) -> np.ndarray:
        """Per-genome Bloom false-positive rate (ones/m)^h."""
        ones = np.array(self._ones_per_genome, dtype=np.float64)
        return (ones / self.bloom_len) ** self.nb_hashes

    def score_counts(
        self,
        counts: np.ndarray,
        totals: np.ndarray,
        min_fraction: float = 0.7,
        fp_exponent: float = 0.0,
    ) -> List[List[Tuple[str, int, int, float]]]:
        """Score hit counts: genomes whose FP-corrected hit fraction passes
        min_fraction, optionally ALSO requiring the binomial tail
        P(X >= hits | Bin(total, fp_rate)) < 10^-fp_exponent (the
        reference's fp_correct test, bigsig.rs:336-341)."""
        fp = self.fp_rates()
        out = []
        for i in range(counts.shape[0]):
            t = int(totals[i])
            hits = []
            if t > 0:
                expected_fp = fp * t
                corrected = (counts[i] - expected_fp) / t
                for g in np.nonzero(corrected >= min_fraction)[0]:
                    if fp_exponent > 0.0 and _binom_sf_log10(
                            int(counts[i][g]), t, fp[g]) >= -fp_exponent:
                        continue
                    hits.append((self.names[g], int(counts[i][g]), t, float(corrected[g])))
                hits.sort(key=lambda x: -x[3])
            out.append(hits)
        return out

    def classify(
        self, reads: np.ndarray, min_fraction: float = 0.7,
        down_sample: int = 1, fp_exponent: float = 0.0,
    ) -> List[List[Tuple[str, int, int, float]]]:
        """Classify a batch of fixed-length reads (uint8 code array [R, L]).

        Returns, per read, the genomes whose FP-corrected k-mer hit fraction
        passes min_fraction: (name, hits, total_kmers, corrected_fraction)
        (reference scoring: binomial FP correction, bigsig.rs:336-341)."""
        counts, totals = self.raw_counts(reads, down_sample)
        return self.score_counts(counts, totals, min_fraction, fp_exponent)

    # --------------------------------------------------------------------- io

    def save(self, path_prefix: str) -> None:
        np.savez_compressed(
            path_prefix + ".bigsi.npz",
            bits=self._bits,
            ones=np.array(self._ones_per_genome, dtype=np.int64),
        )
        with open(path_prefix + ".bigsi.json", "w") as f:
            json.dump(
                {
                    "bloom_len": self.bloom_len,
                    "nb_hashes": self.nb_hashes,
                    "kmer_size": self.kmer_size,
                    "minimizer_window": self.minimizer_window,
                    "seed": self.seed,
                    "names": self.names,
                },
                f,
            )

    @classmethod
    def load(cls, path_prefix: str) -> "BigsiIndex":
        with open(path_prefix + ".bigsi.json") as f:
            meta = json.load(f)
        idx = cls(
            bloom_len=meta["bloom_len"],
            nb_hashes=meta["nb_hashes"],
            kmer_size=meta["kmer_size"],
            minimizer_window=meta["minimizer_window"],
            seed=meta["seed"],
        )
        data = np.load(path_prefix + ".bigsi.npz")
        idx._bits = data["bits"]
        idx._ones_per_genome = data["ones"].tolist()
        idx.names = meta["names"]
        return idx
