"""One-permutation hashing with optimal / reverse-optimal densification.

The reference's recommended default sketcher (OptDensHashSketch /
RevOptDensHashSketch; reference: src/dna/dnasketch.rs:600-642,
README.md:676-680; algorithm: Shrivastava, "Optimal Densification for Fast
and Accurate Minwise Hashing", arXiv 1703.04664).

Device formulation: each k-mer throws exactly one dart —
slot = H1(kmer) mod S, key = H2(kmer) — so OPH is a single `bucket_min`
race.  Densification of empty slots runs on the final [S] vector as R
rounds of vectorized gather-probes: empty slot i probes mix(i, r) mod S
until it hits an originally-occupied slot, copying its key.  Both genomes
probe with the same hash family, preserving the collision-probability
analysis of the paper.  Signature value is the winning key mapped to f32 in
[0, 1), matching the reference's f32 signatures.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.hash import mix2, mix32, uniform01
from ..ops.race import RaceResult, sketch_fingerprint
from .base import SketcherBase

_SLOT_SEED = 0x0BADF00D
_KEY_SEED = 0x5CA1AB1E
_DENS_ROUNDS = 32

_M32 = 0xFFFFFFFF


def _mix32_py(x: int) -> int:
    """Host-side lowbias32 (matches ops.hash.mix32 for static scalars)."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M32
    x ^= x >> 16
    return x


class OptDensSketcher(SketcherBase):
    SIG_DTYPE = np.float32
    USE_PACKED_RACE = True  # payload-free: packed single-key sort fast path
    _DENS_FAMILY = 0x0D15EA5E  # probe-hash family seed

    def _darts(self, hi, lo, valid):
        h_slot = mix2(hi, lo, self.seed ^ _SLOT_SEED)
        slots = (h_slot % jnp.uint32(self.nb_slots)).astype(jnp.int32)
        keys = mix2(hi, lo, self.seed ^ _KEY_SEED)
        return slots, keys, None, valid

    def _densify(self, race: RaceResult):
        """Fill empty slots by probing originally-occupied ones
        (batch-agnostic along the last axis)."""
        s = self.nb_slots
        idx = jnp.arange(s, dtype=jnp.uint32)
        key = jnp.where(race.found, race.key, jnp.uint32(0))
        out_key = key
        still_empty = ~race.found
        for r in range(_DENS_ROUNDS):
            tgt = (mix32(idx, self.seed ^ self._DENS_FAMILY ^ (r * 0x9E37)) % jnp.uint32(s)).astype(jnp.int32)
            tgt_found = jnp.take(race.found, tgt, axis=-1)
            take = still_empty & tgt_found
            out_key = jnp.where(take, jnp.take(key, tgt, axis=-1), out_key)
            still_empty = still_empty & ~tgt_found
        # pathological case (near-empty sketch): genome-DEPENDENT filler so
        # two sparse genomes never spuriously agree on commonly-empty slots
        filler = mix32(idx ^ sketch_fingerprint(race), self.seed ^ 0xDEADBEEF)
        out_key = jnp.where(still_empty, filler, out_key)
        return out_key

    def _finalize_race(self, race: RaceResult) -> jnp.ndarray:
        return uniform01(self._densify(race))


class RevOptDensSketcher(OptDensSketcher):
    """Reverse-optimal densification (reference:
    src/dna/dnasketch.rs:620-642; Mai et al. densification family).

    In the reverse scheme non-empty bins PUSH their value outward; an
    empty bin takes the value of whichever non-empty bin reaches it first.
    Push is scatter-shaped, but with an invertible per-round probe
    (a rotation i -> i + a_r mod S) the push inverts into a gather: empty
    bin i checks source (i - a_r) mod S each round and takes the first
    non-empty hit — faithful semantics, still one fused vectorized loop.
    """

    def _densify(self, race):
        s = self.nb_slots
        idx = jnp.arange(s, dtype=jnp.uint32)
        key = jnp.where(race.found, race.key, jnp.uint32(0))
        out_key = key
        still_empty = ~race.found
        for r in range(_DENS_ROUNDS):
            # per-round rotation offset (same for every bin => invertible);
            # computed host-side (static) with the same lowbias32 mix
            a_r = _mix32_py(r ^ self.seed ^ 0x7E57AB1E) % max(s - 1, 1) + 1
            src = ((idx + jnp.uint32(s - a_r)) % jnp.uint32(s)).astype(jnp.int32)
            src_found = jnp.take(race.found, src, axis=-1)
            take = still_empty & src_found
            out_key = jnp.where(take, jnp.take(key, src, axis=-1), out_key)
            still_empty = still_empty & ~src_found
        filler = mix32(idx ^ sketch_fingerprint(race), self.seed ^ 0xDEADBEEF)
        return jnp.where(still_empty, filler, out_key)
