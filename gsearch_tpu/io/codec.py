"""Host-side sequence codecs: ASCII FASTA bytes -> small integer codes.

Capability-equivalent of the reference's 2-bit DNA `Sequence` /
5-bit AA `SequenceAA` codecs from kmerutils
(reference call sites: src/dna/dnafiles.rs:70-72 `encode_and_add` with
`Alphabet2b` dropping non-ACGT; src/aa/aafiles.rs:11-28 `filter_out_non_aa`).

Device-facing layout choice: we encode to one uint8 code per symbol
(DNA: 0..3, AA: 0..19) rather than bit-packing on the host.  The device
kernels consume code arrays directly and fold them into compressed k-mer
words on-chip (gsearch_tpu/ops/kmer.py), so host bit-packing would only
save PCIe bytes at the cost of an unpack kernel; a packed variant can be
added behind the same interface if ingest bandwidth ever dominates.

Encoding is a single vectorized numpy table lookup (~1 GB/s), the analog of
the reference's per-byte alphabet loop.  Invalid symbols (N, ambiguity
codes, separators) become DNA_INVALID and act as hard k-mer breaks on
device — slightly stricter than the reference, which silently drops
non-ACGT bytes and therefore creates artificial junction k-mers.
"""

from __future__ import annotations

import numpy as np

DNA_INVALID = np.uint8(255)

# DNA: A=0 C=1 G=2 T=3 so that complement(x) == 3 - x == ~x & 3
_DNA_TABLE = np.full(256, DNA_INVALID, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _DNA_TABLE[ord(_c)] = _i
    _DNA_TABLE[ord(_c.lower())] = _i
_DNA_TABLE[ord("U")] = 3  # RNA
_DNA_TABLE[ord("u")] = 3

# AA: the 20 standard residues, 5-bit codes like the reference's SequenceAA
AA_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
_AA_TABLE = np.full(256, DNA_INVALID, dtype=np.uint8)
for _i, _c in enumerate(AA_ALPHABET):
    _AA_TABLE[ord(_c)] = _i
    _AA_TABLE[ord(_c.lower())] = _i

_DNA_DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)


def encode_dna(seq_bytes: bytes | np.ndarray) -> np.ndarray:
    """ASCII DNA -> uint8 codes in {0..3} with 255 for invalid symbols."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(seq_bytes, (bytes, bytearray)) else seq_bytes
    return _DNA_TABLE[arr]


def encode_aa(seq_bytes: bytes | np.ndarray) -> np.ndarray:
    """ASCII protein -> uint8 codes in {0..19} with 255 for invalid symbols."""
    arr = np.frombuffer(seq_bytes, dtype=np.uint8) if isinstance(seq_bytes, (bytes, bytearray)) else seq_bytes
    return _AA_TABLE[arr]


def decode_dna(codes: np.ndarray) -> bytes:
    """uint8 codes -> ASCII (invalid codes decode to 'N'); for tests/tools."""
    out = np.full(codes.shape, ord("N"), dtype=np.uint8)
    valid = codes < 4
    out[valid] = _DNA_DECODE[codes[valid]]
    return out.tobytes()


class PackedCodes:
    """A DNA code row in the device upload form: 2-bit-packed codes
    (4/byte) plus the positions of invalid codes (record separators, Ns).

    This is exactly the "exception form" the sketchers upload
    (models/base.py), produced directly by the fused native parser
    (native/fastaparse.cpp fasta_concat_pack2) without ever
    materializing a 1 B/base code array — the 1-core ingest host is
    memory-bandwidth-bound, so skipping that intermediate is the
    difference between ~4 and ~2 passes over every base."""

    __slots__ = ("p2", "n", "inv")

    def __init__(self, p2: np.ndarray, n: int, inv: np.ndarray):
        self.p2 = p2       # uint8 [>= ceil(n/4)]
        self.n = int(n)    # codes in the row, separators included
        self.inv = inv     # int32 sorted positions of invalid codes

    def __len__(self) -> int:
        return self.n

    def to_codes(self) -> np.ndarray:
        """Unpack to the 1 B/base code form (fallback paths only)."""
        m = (self.n + 3) // 4
        b = self.p2[:m]
        c = np.empty(4 * m, np.uint8)
        c[0::4] = b & 3
        c[1::4] = (b >> 2) & 3
        c[2::4] = (b >> 4) & 3
        c[3::4] = (b >> 6) & 3
        c = c[: self.n]
        c[self.inv[self.inv < self.n]] = DNA_INVALID
        return c

    def piece(self, start: int, length: int) -> "PackedCodes":
        """Zero-copy slice [start, start+length) — start must be a
        multiple of 4 so the byte view stays aligned."""
        assert start % 4 == 0
        end = min(start + length, self.n)
        inv = self.inv[(self.inv >= start) & (self.inv < end)]
        return PackedCodes(
            self.p2[start // 4 : (end + 3) // 4], end - start,
            (inv - start).astype(np.int32),
        )
