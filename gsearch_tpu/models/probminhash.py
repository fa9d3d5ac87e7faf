"""ProbMinHash — weighted (probability) Jaccard sketching.

Capability-equivalent of the reference's ProbHash3aSketch (reference:
src/dna/dnasketch.rs:499-519, README.md:122-127; algorithm family: Ertl,
"ProbMinHash — A Class of Locality-Sensitive Hash Algorithms for the
(Probability) Jaccard Similarity", arXiv 1911.00675).  Signature slot s is
the element winning an exponential race with rates proportional to the
element's k-mer multiplicity; two genomes agree on slot s with probability
J_P, the probability Jaccard of their weighted k-mer spectra.

Device formulation (the CPU algorithm's hash-table of counts + per-element
heap does not map to a vector unit):

 1. One batched sort of the k-mer stream groups equal k-mers; each run's
    start position and length (= multiplicity m_x) fall out of two
    cumulative scans — no hash table.
 2. Element x runs a Poisson arrival process whose randomness is seeded by
    x ALONE and whose times are deterministically scaled by 1/m_x:
    t_j(x) = Gamma_j(x) / m_x with Gamma_j a cumsum of Exp(1) draws.  Two
    genomes share the Gammas and differ only in the deterministic scale —
    exactly Ertl's coupling, so P(slot winners agree) is the probability
    Jaccard J_P.  (Superposing m independent unit processes instead would
    estimate the multiset Jaccard sum-min/sum-max — close, but not the
    reference's estimator.)  The per-genome normalization by total weight
    W is a uniform time scale and cannot change any argmin, so it drops.
 3. Each distinct element emits C=3 arrivals (slots uniform per arrival),
    all funneling into the same `bucket_min` race as every other sketcher.
    Truncation bias requires an element's 4th arrival to have won a slot —
    negligible unless a single k-mer dominates the genome's spectrum.

The signature is a 32-bit fingerprint of the winning element (the reference
stores the u32/u64 winning k-mer value; 32 bits keep slot-collision
probability at 2^-32, invisible next to 1/sqrt(S) sketch noise).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.hash import exp_from_bits, mix2, mix32
from ..ops.race import RaceResult, sketch_fingerprint
from .base import SketcherBase

_RANK_SEED = 0xA11CE5
_SLOT_SEED = 0xB0B5EED
_PAY_SEED = 0xCAFEF00D
_SENTINEL = jnp.uint32(0xFFFFFFFF)
_ARRIVALS = 3


class ProbMinHashSketcher(SketcherBase):
    SIG_DTYPE = np.uint32
    MULTIPLICITY_SENSITIVE = True  # see SketcherBase: no 4-aligned pieces

    arrivals: int = _ARRIVALS
    # Multiplicities are per-piece for streamed (>8 Mb) genomes.  Because
    # the Gamma sequence is seeded by the element alone, min-combining
    # pieces yields an effective weight max_i(m_i) instead of sum_i(m_i)
    # — and J_P is scale-invariant, so uniform duplication cancels exactly.
    # Measured (test_probminhash_streaming_bias): zero bias on random and
    # uniformly-duplicated genomes; an adversarial half-duplicated-across-
    # pieces layout shifts J_P by ~0.05.  Exact streaming J_P would need
    # global multiplicities (a host count table, as the reference holds);
    # not worth it for the bias profile of real genomes.
    MAX_BLOCK_LOG2 = 23
    # NOTE: the packed-payload pre-reduce fast path (ops/race.py) is NOT
    # safe here: its top-K-per-window bound assumes a dart density that
    # duplication-heavy genomes undercut (valid darts are one per DISTINCT
    # k-mer), and the scale-invariance test catches the resulting winner
    # losses. ProbMinHash keeps the exact sort-based race.
    USE_PACKED_PAYLOAD_RACE = False

    def _darts(self, hi, lo, valid):
        # 1. group equal k-mers by sorting (invalid windows to the far end)
        khi = jnp.where(valid, hi, _SENTINEL)
        klo = jnp.where(valid, lo, _SENTINEL)
        s_hi, s_lo = jax.lax.sort((khi, klo), dimension=-1, num_keys=2)
        s_valid = ~((s_hi == _SENTINEL) & (s_lo == _SENTINEL))

        # 2. run starts + multiplicities via forward cummax / reverse cummin
        # (batch-agnostic: operates along the last axis)
        n = s_hi.shape[-1]
        last = s_hi.ndim - 1
        iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), s_hi.shape)
        pad = [(0, 0)] * (s_hi.ndim - 1) + [(1, 0)]
        sent = np.uint32(0xFFFFFFFF)
        prev_hi = jnp.pad(s_hi, pad, constant_values=sent)[..., :-1]
        prev_lo = jnp.pad(s_lo, pad, constant_values=sent)[..., :-1]
        is_start = (s_hi != prev_hi) | (s_lo != prev_lo)
        run_start = jax.lax.cummax(jnp.where(is_start, iota, 0), axis=last)
        is_rep = iota == run_start  # one representative dart source per run
        # next run's start index (n past the end) -> multiplicity
        next_start = jax.lax.cummin(
            jnp.where(is_start, iota, n), axis=last, reverse=True
        )
        pad_r = [(0, 0)] * (s_hi.ndim - 1) + [(0, 1)]
        next_start = jnp.pad(next_start, pad_r, constant_values=n)[..., 1:]
        mult = (next_start - run_start).astype(jnp.float32)
        inv_m = jnp.where(mult > 0, 1.0 / mult, 1.0)

        # 3. C arrivals per distinct element, times scaled by 1/m_x
        slots_l, keys_l, valid_l = [], [], []
        t = jnp.zeros(s_hi.shape, dtype=jnp.float32)
        rep_valid = s_valid & is_rep
        for j in range(self.arrivals):
            sub_seed = jnp.uint32((self.seed ^ _RANK_SEED ^ (j * 0x9E3779B9)) & 0xFFFFFFFF)
            t = t + exp_from_bits(mix2(s_hi, s_lo, sub_seed))
            slot = mix2(s_hi, s_lo, sub_seed ^ jnp.uint32(_SLOT_SEED)) % jnp.uint32(self.nb_slots)
            slots_l.append(slot.astype(jnp.int32))
            keys_l.append((t * inv_m).view(jnp.uint32))  # positive f32 bits sort correctly
            valid_l.append(rep_valid)
        payload = mix2(s_hi, s_lo, self.seed ^ _PAY_SEED)

        slots = jnp.concatenate(slots_l, axis=-1)
        keys = jnp.concatenate(keys_l, axis=-1)
        dvalid = jnp.concatenate(valid_l, axis=-1)
        pays = jnp.concatenate([payload] * self.arrivals, axis=-1)
        return slots, keys, pays, dvalid

    def _finalize_race(self, race: RaceResult) -> jnp.ndarray:
        # genome-dependent filler: commonly-empty slots must not count as
        # agreement between two sparse genomes
        idx = jnp.arange(self.nb_slots, dtype=jnp.uint32)
        filler = mix32(idx ^ sketch_fingerprint(race), self.seed ^ 0xD00DF00D)
        return jnp.where(race.found, race.payload, filler)
