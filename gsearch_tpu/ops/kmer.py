"""Vectorized compressed k-mer extraction on device.

Capability-equivalent of kmerutils' KmerSeqIterator + compressed k-mer types
(Kmer32bit / Kmer16b32bit / Kmer64bit for DNA, KmerAA32bit / KmerAA64bit for
AA; reference call sites: src/dna/dnasketch.rs:493-644 k-mer-width dispatch,
src/bin/hypermash.rs:147-166 canonical min(kmer, revcomp)).

Device formulation: instead of a streaming per-position iterator, every
window start position is computed at once.  A sequence arrives as a uint8
code array `codes[..., L]` (0..alphabet-1, >= 4/20 invalid).  The k-mer at
position i is the base-(2^bits) fold of codes[i:i+k]; we build it with k
static shifted slices, which XLA fuses into one elementwise pass — all VPU,
no gathers, no sequential dependence.

Wide k-mers (> 32 bits) live in (hi, lo) uint32 lane pairs: accelerators have no fast
64-bit integer datapath (see ops/hash.py).

Outputs are aligned to window start positions: position i of the output is
the k-mer starting at codes[..., i]; `valid[..., i]` is False when any
symbol in the window is invalid or the window overruns the sequence end.
Invalid symbols therefore act as hard k-mer breaks (sequence separators are
encoded as invalid codes by gsearch_tpu.io.fasta).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_U = jnp.uint32

DNA_BITS = 2
AA_BITS = 5


def _shifted(codes: jnp.ndarray, j: int) -> jnp.ndarray:
    """codes[..., j:] left-aligned and padded at the end with invalid (255)."""
    if j == 0:
        return codes
    pad = [(0, 0)] * (codes.ndim - 1) + [(0, j)]
    return jnp.pad(codes[..., j:], pad, constant_values=255)


def kmer_windows(
    codes: jnp.ndarray, k: int, bits: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fold all length-k windows into (hi, lo) uint32 pairs.

    codes: uint8 [..., L]; returns (hi, lo, valid), each [..., L].
    For k*bits <= 32, hi is all zeros.
    """
    assert 1 <= k * bits <= 64, "compressed k-mer must fit 64 bits"
    alphabet = 1 << bits if bits < 8 else 255
    # DNA alphabet size is 4, AA is 20 (< 2^5)
    limit = 4 if bits == DNA_BITS else 20
    hi = jnp.zeros(codes.shape, dtype=jnp.uint32)
    lo = jnp.zeros(codes.shape, dtype=jnp.uint32)
    valid = jnp.ones(codes.shape, dtype=jnp.bool_)
    del alphabet
    for j in range(k):
        c = _shifted(codes, j)
        valid = valid & (c < limit)
        cu = c.astype(jnp.uint32)
        # 64-bit left shift by `bits` across the (hi, lo) pair, then or-in c
        hi = (hi << bits) | (lo >> (32 - bits))
        lo = (lo << bits) | cu
    return hi, lo, valid


def _rev2_32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the sixteen 2-bit groups of a uint32."""
    x = ((x & _U(0x33333333)) << 2) | ((x >> 2) & _U(0x33333333))
    x = ((x & _U(0x0F0F0F0F)) << 4) | ((x >> 4) & _U(0x0F0F0F0F))
    x = ((x & _U(0x00FF00FF)) << 8) | ((x >> 8) & _U(0x00FF00FF))
    x = (x << 16) | (x >> 16)
    return x


def _pair_shr(hi: jnp.ndarray, lo: jnp.ndarray, s: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Logical right shift of the (hi, lo) 64-bit pair by static s."""
    if s == 0:
        return hi, lo
    if s < 32:
        return hi >> s, (lo >> s) | (hi << (32 - s))
    if s == 32:
        return jnp.zeros_like(hi), hi
    return jnp.zeros_like(hi), hi >> (s - 32)


def reverse_complement(hi: jnp.ndarray, lo: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reverse complement of 2-bit packed DNA k-mers held in (hi, lo).

    With A=0,C=1,G=2,T=3 the complement is bitwise NOT of each 2-bit group;
    the reverse is a 2-bit-group reversal of the 64-bit pair followed by a
    right shift to re-align to the low 2k bits (reference semantics:
    CompressedKmerT::reverse_complement, call site hypermash.rs:158-166).
    """
    chi, clo = ~hi, ~lo
    rhi, rlo = _rev2_32(clo), _rev2_32(chi)  # 64-bit group reversal swaps words
    return _pair_shr(rhi, rlo, 64 - 2 * k)


def canonical_dna_windows(
    codes: jnp.ndarray, k: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """All k-windows as canonical (min of k-mer and its reverse complement)
    2-bit-packed values — the hash-input convention of every DNA sketcher in
    the reference (src/dna/dnasketch.rs:164-169)."""
    hi, lo, valid = kmer_windows(codes, k, DNA_BITS)
    rhi, rlo = reverse_complement(hi, lo, k)
    fwd_smaller = (hi < rhi) | ((hi == rhi) & (lo <= rlo))
    chi = jnp.where(fwd_smaller, hi, rhi)
    clo = jnp.where(fwd_smaller, lo, rlo)
    return chi, clo, valid
