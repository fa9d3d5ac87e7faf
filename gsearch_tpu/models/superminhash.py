"""SuperMinHash (f32 "SUPER" and integer "SUPER2" variants).

Capability-equivalent of the reference's SuperHashSketch / SuperHash2Sketch
(reference: src/dna/dnasketch.rs:520-540 and :575-599; algorithm: Ertl,
"SuperMinHash — A New Minwise Hashing Algorithm for Jaccard Similarity
Estimation", arXiv 1706.05698).

SuperMinHash assigns element x, for arrival j = 0, 1, ..., the value
v_j = j + u_j(x) (u_j uniform) at a slot drawn without replacement, and
keeps the per-slot minimum.  The sequential algorithm early-stops the
arrival loop; on the device we truncate it at a static C arrivals per element and
fold everything into one `bucket_min` race:

  key  = (j << 24) | 24-bit u_j(x)          (monotone encoding of j + u_j)
  slot = H(x, j) mod S                       (with-replacement approximation
                                              of the truncated Fisher-Yates —
                                              collision prob ~ C^2/2S per
                                              element, negligible for C << S)

Truncation bias: an arrival j >= C could only win a slot whose current
minimum exceeds j; with |set| = K distinct k-mers, per-slot minima are
~ U-order-statistics of K/S draws, so C = 2 is already exact-in-practice
for K >> S (whole genomes).  For K << S many slots stay empty; empty
slots are filled with a genome-dependent filler (never matching), so
sparse inputs lose precision but gain no spurious similarity.

SUPER stores the winning value as f32 (reference Sig = f32); SUPER2 stores
an integer fingerprint of the winning element (reference Sig = u32/u64 via
FxHasher), both compared by slot equality.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..ops.hash import mix2, mix32
from ..ops.race import RaceResult, sketch_fingerprint
from .base import SketcherBase

_SLOT_SEED = 0x51075EED
_VAL_SEED = 0x4A1B2C3D
_PAY_SEED = 0xFEEDC0DE
_ARRIVALS = 2


class SuperMinHashSketcher(SketcherBase):
    SIG_DTYPE = np.float32

    arrivals: int = _ARRIVALS

    def _darts(self, hi, lo, valid):
        slots_l, keys_l, valid_l = [], [], []
        for j in range(self.arrivals):
            h_slot = mix2(hi, lo, (self.seed ^ _SLOT_SEED ^ (j * 0x9E3779B9)) & 0xFFFFFFFF)
            h_val = mix2(hi, lo, (self.seed ^ _VAL_SEED ^ (j * 0x85EBCA6B)) & 0xFFFFFFFF)
            slots_l.append((h_slot % jnp.uint32(self.nb_slots)).astype(jnp.int32))
            keys_l.append((jnp.uint32(j) << 24) | (h_val >> 8))
            valid_l.append(valid)
        payload = mix2(hi, lo, self.seed ^ _PAY_SEED)
        slots = jnp.concatenate(slots_l, axis=-1)
        keys = jnp.concatenate(keys_l, axis=-1)
        dvalid = jnp.concatenate(valid_l, axis=-1)
        pays = jnp.concatenate([payload] * self.arrivals, axis=-1)
        return slots, keys, pays, dvalid

    def _finalize_race(self, race: RaceResult) -> jnp.ndarray:
        v = (race.key >> 24).astype(jnp.float32) + (
            race.key & jnp.uint32(0xFFFFFF)
        ).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
        # empty slots: genome-DEPENDENT filler far above any real value, so
        # two sparse genomes never agree on commonly-empty slots
        idx = jnp.arange(self.nb_slots, dtype=jnp.uint32)
        fp = mix32(idx ^ sketch_fingerprint(race), self.seed ^ 0xF111E4)
        filler = jnp.float32(1e6) + fp.astype(jnp.float32)
        return jnp.where(race.found, v, filler)


class SuperMinHash2Sketcher(SuperMinHashSketcher):
    SIG_DTYPE = np.uint32

    def _finalize_race(self, race: RaceResult) -> jnp.ndarray:
        idx = jnp.arange(self.nb_slots, dtype=jnp.uint32)
        filler = mix32(idx ^ sketch_fingerprint(race), self.seed ^ 0xBAD5EED5)
        return jnp.where(race.found, race.payload, filler)
