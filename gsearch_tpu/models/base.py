"""Sketcher base: host orchestration of the device sketch kernels.

Equivalent in role to the reference's SeqSketcherT / SeqSketcherAAT traits
(`sketch_compressedkmer` — one signature per sequence — and
`sketch_compressedkmer_seqs` — one signature for a concatenation; reference
call sites: src/dna/dnasketch.rs:336,357 and src/aa/aasketch.rs:313,329).

Device streaming model: a genome arrives as a uint8 code array of arbitrary
length.  It is padded to one of a small set of power-of-two block lengths
(so XLA compiles a handful of shapes, then every genome on Earth reuses
them) and pushed through the algorithm's dart kernel; genomes longer than
the largest block stream through it in overlapping pieces whose partial
races merge with the associative `combine_race`.  The final signature
transform (densification, register discretization, ...) is a second, tiny
jitted function.

Every sketcher is deterministic in (algorithm, k, sketch_size, seed): the
same k-mer produces the same darts in any genome, which is the coupling
that makes slot-equality estimate Jaccard.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.params import DataType, SeqSketcherParams, SketchAlgo
from ..ops.kmer import AA_BITS, canonical_dna_windows, kmer_windows
from ..ops.race import (RaceResult, bucket_min, bucket_min_packed,
                        bucket_min_packed_payload, combine_race)
from ..utils import device_profile, get_logger

log = get_logger(__name__)

# block-length buckets: min keeps tiny-genome latency low, max bounds the
# on-device sort size (darts can be 2x the block length).  Buckets step by
# 4x to keep the number of compiled shapes small — XLA compilation is
# remote-serviced in this environment and each distinct sort shape costs
# real wall-clock the first time.
_MIN_BLOCK_LOG2 = 14
_MAX_BLOCK_LOG2 = 22
# x2 steps keep every genome >= half its block: the packed race's windowed
# pre-reduction derives its worst-case darts-per-slot bound from that fill
_BLOCK_STEP_LOG2 = 1


def block_length(n: int, max_log2: int = _MAX_BLOCK_LOG2) -> int:
    """Smallest block bucket >= n: powers of two plus 1.5x midpoints
    (3*2^(k-1)), capping worst-case padding at 33% instead of 100%.
    Midpoints are multiples of 8192, so every lane/packing constraint of
    the race kernels holds.  Upload bytes scale with the bucket, so
    padding is pure loss."""
    cap = 1 << max_log2
    nb = 1 << _MIN_BLOCK_LOG2
    while nb < n and nb < cap:
        mid = nb + (nb >> 1)
        if n <= mid and mid <= cap:
            return mid
        nb <<= _BLOCK_STEP_LOG2
    return min(nb, cap)


class SketchTicket:
    """Handle for an asynchronous sketch_submit: rows land in `out` as the
    collector drains finished dispatches; complete when open_batches == 0.
    A batch failure lands in `err` and is raised by THIS ticket's
    sketch_finish (a shared error slot would raise it on whichever ticket
    finished first and let the failed one return uninitialized rows)."""

    __slots__ = ("out", "open_batches", "err")

    def __init__(self, out: np.ndarray):
        self.out = out
        self.open_batches = 0
        self.err: BaseException | None = None


class SketcherBase:
    """Shared machinery; subclasses define the dart generation + finalize."""

    SIG_DTYPE = np.float32
    # payload-free algorithms can use the packed single-key race (~2x the
    # sort throughput; see ops/race.py bucket_min_packed); payload-carrying
    # ones can opt into the quantized packed-payload variant
    USE_PACKED_RACE = False
    USE_PACKED_PAYLOAD_RACE = False
    #: True when the sketch depends on k-mer MULTIPLICITY (ProbMinHash):
    #: the fused-packed streaming path slices genome pieces at 4-aligned
    #: starts, duplicating up to 3 boundary windows per piece — harmless
    #: for set-semantics races (idempotent min/max), not for counts, so
    #: multiplicity-sensitive sketchers unpack and take the exact path.
    MULTIPLICITY_SENSITIVE = False

    def __init__(self, params: SeqSketcherParams, seed: int = 0x5EED):
        self.params = params
        self.k = params.kmer_size
        self.nb_slots = params.sketch_size
        self.seed = seed
        self.is_aa = params.data_t == DataType.AA
        if self.is_aa and params.kmer_size > 12:
            raise ValueError("AA kmer_size must be <= 12 (reference: aasketch.rs:464)")
        # per-instance jit caches (lru_cache on methods would pin `self`
        # and its device buffers in a global cache forever)
        self._fn_cache: dict = {}
        self.mesh = None  # optional jax Mesh: shard batched sketching over 'd'
        # collector thread state (lazy, _ensure_collector): completed
        # dispatches are downloaded OFF the submit thread, because a host
        # download syncs the dispatch pipeline and the next dispatch would
        # wait on it
        self._collect_q = None
        self._collect_cv = None

    def set_mesh(self, mesh) -> None:
        """Enable data-parallel sketching over the mesh's 'd' axis: genome
        batches shard over devices, the race runs per-device with no
        communication (the multi-device form of the reference's sketcher
        thread fan-out, dnasketch.rs:300-325)."""
        self.mesh = mesh

    # ---- subclass interface -------------------------------------------------

    def _darts(self, hi, lo, valid):
        """(hi, lo, valid) windows -> (slots, keys, payload, dart_valid).

        Returned arrays may be longer than the window count (multiple darts
        per window are concatenated along the last axis)."""
        raise NotImplementedError

    def _finalize_race(self, race: RaceResult) -> jnp.ndarray:
        """RaceResult -> signature vector [nb_slots] of SIG_DTYPE."""
        raise NotImplementedError

    # ---- device functions (cached per block shape) --------------------------

    def _windows(self, codes: jnp.ndarray):
        if self.is_aa:
            return kmer_windows(codes, self.k, AA_BITS)
        return canonical_dna_windows(codes, self.k)

    def _race(self, slots, keys, payload, dvalid) -> RaceResult:
        if self.USE_PACKED_RACE and payload is None:
            return bucket_min_packed(slots, keys, self.nb_slots, valid=dvalid)
        if self.USE_PACKED_PAYLOAD_RACE and payload is not None:
            return bucket_min_packed_payload(
                slots, keys, payload, self.nb_slots, valid=dvalid
            )
        return bucket_min(slots, keys, self.nb_slots, payload=payload, valid=dvalid)

    # ---- 2-bit host packing (DNA): quarter the host->device bytes.  Two
    # formats:
    #   exception form — 2-bit codes + per-row length + a short list of
    #     invalid positions (0.25 B/base; covers the common case: record
    #     separators and scattered Ns),
    #   bit-plane form — 2-bit codes + a validity bit plane (0.375 B/base;
    #     fallback for N-run-heavy rows with > _MAX_EXC invalid positions).

    _MAX_EXC = 1024  # invalid positions carried per row in exception form

    #: DNA upload format.  "packed" 2-bit-packs on host (0.25 B/base over
    #: the link), "raw" ships u8 codes as-is (1 B/base), "auto" (default)
    #: packs iff the native C++ packer is loaded: the numpy pack is slower
    #: than uploading 4x the bytes, while the C++ packer runs at memory
    #: speed.  GSEARCH_TPU_UPLOAD overrides.
    UPLOAD_MODE = os.environ.get("GSEARCH_TPU_UPLOAD", "auto")

    @functools.cached_property
    def _upload_raw(self) -> bool:
        if self.UPLOAD_MODE == "auto":
            from ..io.native import get_lib

            lib = get_lib()
            return not (lib is not None and hasattr(lib, "pack2bit_exc"))
        return self.UPLOAD_MODE == "raw"

    @staticmethod
    def _pack_host(arr: np.ndarray):
        """u8 codes [b, nb] -> (2-bit codes [b, nb//4], valid bits [b, nb//8])."""
        valid = arr < 4
        c = np.where(valid, arr, 0).astype(np.uint8)
        p2 = (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6))
        vb = np.packbits(valid, axis=-1, bitorder="little")
        return p2, vb

    @classmethod
    def _pack_host_exc(cls, arr: np.ndarray, lens: np.ndarray):
        """u8 codes [b, nb] + row lengths -> (p2 [b, nb//4], lens, inv
        [b, _MAX_EXC] positions of invalid codes, padded with nb) or None
        when some row has too many invalid positions (caller falls back to
        the bit-plane form)."""
        b, nb = arr.shape
        from ..io.native import native_pack2bit_exc

        nat = native_pack2bit_exc(arr, lens, cls._MAX_EXC)
        if nat is not None:
            p2, inv = nat
            return p2, lens.astype(np.int32), inv
        inv_mask = arr >= 4
        inv_mask &= np.arange(nb, dtype=np.int32)[None, :] < lens[:, None]
        if int(inv_mask.sum()) > 0:
            counts = inv_mask.sum(axis=1)
            if int(counts.max()) > cls._MAX_EXC:
                return None
            r, c = np.nonzero(inv_mask)
            inv = np.full((b, cls._MAX_EXC), nb, np.int32)
            rank = np.arange(len(r)) - np.searchsorted(r, r, side="left")
            inv[r, rank] = c
        else:
            inv = np.full((b, cls._MAX_EXC), nb, np.int32)
        cc = np.where(arr >= 4, 0, arr).astype(np.uint8)
        p2 = (cc[:, 0::4] | (cc[:, 1::4] << 2) | (cc[:, 2::4] << 4) | (cc[:, 3::4] << 6))
        return p2, lens.astype(np.int32), inv

    @staticmethod
    def _unpack2(p2: jnp.ndarray, nb: int) -> jnp.ndarray:
        b = p2.shape[0]
        c = jnp.stack([(p2 >> (2 * i)) & jnp.uint8(3) for i in range(4)], axis=-1)
        return c.reshape(b, nb)

    @staticmethod
    def _unpack_device(p2: jnp.ndarray, vb: jnp.ndarray, nb: int) -> jnp.ndarray:
        b = p2.shape[0]
        c = SketcherBase._unpack2(p2, nb)
        v = jnp.stack([(vb >> i) & jnp.uint8(1) for i in range(8)], axis=-1)
        v = v.reshape(b, nb).astype(jnp.bool_)
        return jnp.where(v, c, jnp.uint8(255))

    @staticmethod
    def _unpack_device_exc(p2: jnp.ndarray, lens: jnp.ndarray, inv: jnp.ndarray,
                           nb: int) -> jnp.ndarray:
        b = p2.shape[0]
        c = SketcherBase._unpack2(p2, nb)
        pos = jnp.arange(nb, dtype=jnp.int32)
        c = jnp.where(pos[None, :] < lens[:, None], c, jnp.uint8(255))
        # apply invalid-position exceptions; padding indices (= nb) land in
        # a sacrificial extra column
        ext = jnp.concatenate([c, jnp.zeros((b, 1), jnp.uint8)], axis=1)
        ext = ext.at[jnp.arange(b)[:, None], inv].set(jnp.uint8(255))
        return ext[:, :nb]

    def _block_fn(self, nb: int):
        """Streaming-piece kernel: one genome piece -> RaceResult.  Pieces
        arrive as raw u8 codes, or (UPLOAD_MODE=packed) DNA in the packed
        exception form (0.25 B/base over the link)."""
        key = ("block", nb)
        if key in self._fn_cache:
            return self._fn_cache[key]

        if self.is_aa or self._upload_raw:
            def run(codes: jnp.ndarray) -> RaceResult:
                hi, lo, valid = self._windows(codes)
                slots, keys, payload, dvalid = self._darts(hi, lo, valid)
                return self._race(slots, keys, payload, dvalid)
        else:
            def run(p2: jnp.ndarray, lens: jnp.ndarray, inv: jnp.ndarray) -> RaceResult:
                codes = self._unpack_device_exc(p2, lens, inv, nb)[0]
                hi, lo, valid = self._windows(codes)
                slots, keys, payload, dvalid = self._darts(hi, lo, valid)
                return self._race(slots, keys, payload, dvalid)

        self._fn_cache[key] = jax.jit(run)
        return self._fn_cache[key]

    def _block_fn_plane(self, nb: int):
        """Bit-plane fallback for N-run-heavy pieces."""
        key = ("block_plane", nb)
        if key in self._fn_cache:
            return self._fn_cache[key]

        def run(p2: jnp.ndarray, vb: jnp.ndarray) -> RaceResult:
            codes = self._unpack_device(p2, vb, nb)[0]
            hi, lo, valid = self._windows(codes)
            slots, keys, payload, dvalid = self._darts(hi, lo, valid)
            return self._race(slots, keys, payload, dvalid)

        self._fn_cache[key] = jax.jit(run)
        return self._fn_cache[key]

    def _batch_fn_impl(self, b: int, nb: int, form: str):
        """Sketch a whole [b, nb] batch of same-bucket genomes in ONE
        dispatch — the device analog of the reference's sketcher thread
        pool (dnasketch.rs:300-325): dispatch latency and sort fixed costs
        amortize over the batch."""

        def body(codes):
            hi, lo, valid = self._windows(codes)
            slots, keys, payload, dvalid = self._darts(hi, lo, valid)
            return self._finalize_race(self._race(slots, keys, payload, dvalid))

        if self.is_aa or form == "raw":
            run = body
        elif form == "exc":
            def run(p2, lens, inv):
                return body(self._unpack_device_exc(p2, lens, inv, nb))
        else:
            def run(p2, vb):
                return body(self._unpack_device(p2, vb, nb))

        if self.mesh is not None:
            # explicit SPMD: each chip sketches its batch shard locally (the
            # race's scatter-min stays shard-local, no collectives at all)
            from jax.sharding import PartitionSpec as P

            if self.is_aa or form == "raw":
                in_specs = (P("d", None),)
            elif form == "exc":
                in_specs = (P("d", None), P("d"), P("d", None))
            else:
                in_specs = (P("d", None), P("d", None))
            run = jax.shard_map(
                run, mesh=self.mesh, in_specs=in_specs, out_specs=P("d", None),
            )
        return jax.jit(run)

    def _batch_fn(self, b: int, nb: int, form: str = "exc"):
        key = ("batch", b, nb, form, self.mesh is not None)
        if key not in self._fn_cache:
            self._fn_cache[key] = self._batch_fn_impl(b, nb, form)
        return self._fn_cache[key]

    def _race_stream_fn(self, b: int, nb: int, form: str):
        """Batched STREAMING kernel: [b] pieces of ONE genome -> their
        races, row-reduced in-graph with the associative combine -> one
        partial RaceResult.  Replaces the row-at-a-time piece loop (one
        dispatch per 4-Mb piece) with one dispatch per genome — most real
        bacterial genomes (2-10 Mb) are larger than a block, so this is
        the corpus-scale build path."""
        key = ("stream", b, nb, form)
        if key in self._fn_cache:
            return self._fn_cache[key]

        def reduce_rows(race: RaceResult) -> RaceResult:
            acc = RaceResult(race.found[0], race.key[0], race.payload[0])
            for j in range(1, b):  # b is small and static: unrolled
                acc = combine_race(
                    acc, RaceResult(race.found[j], race.key[j], race.payload[j]))
            return acc

        def body(codes):
            hi, lo, valid = self._windows(codes)
            slots, keys, payload, dvalid = self._darts(hi, lo, valid)
            return reduce_rows(self._race(slots, keys, payload, dvalid))

        if form == "raw":
            run = body
        else:
            def run(p2, lens, inv):
                return body(self._unpack_device_exc(p2, lens, inv, nb))

        self._fn_cache[key] = jax.jit(run)
        return self._fn_cache[key]

    def _race_stream_seg_fn(self, g: int, p: int, nb: int, form: str):
        """Cross-genome batched streaming kernel: [g*p] piece rows (p
        pieces for each of g genomes) -> per-genome races via an in-graph
        segment reduce -> finalized signatures [g, nb_slots].  One device
        dispatch sketches g whole multi-block genomes."""
        key = ("stream_seg", g, p, nb, form)
        if key in self._fn_cache:
            return self._fn_cache[key]

        def reduce_segments(race: RaceResult) -> RaceResult:
            f = race.found.reshape((g, p) + race.found.shape[1:])
            k = race.key.reshape((g, p) + race.key.shape[1:])
            pl = race.payload.reshape((g, p) + race.payload.shape[1:])
            acc = RaceResult(f[:, 0], k[:, 0], pl[:, 0])
            for j in range(1, p):  # p is small and static: unrolled
                acc = combine_race(acc, RaceResult(f[:, j], k[:, j], pl[:, j]))
            return acc

        def body(codes):
            hi, lo, valid = self._windows(codes)
            slots, keys, payload, dvalid = self._darts(hi, lo, valid)
            race = self._race(slots, keys, payload, dvalid)
            return self._finalize_race(reduce_segments(race))

        if form == "raw":
            run = body
        else:
            def run(p2, lens, inv):
                return body(self._unpack_device_exc(p2, lens, inv, nb))

        self._fn_cache[key] = jax.jit(run)
        return self._fn_cache[key]

    #: elements budget for cross-genome streaming dispatches — larger than
    #: _BATCH_ELEMS_LOG2 because piece rows are always max-block-sized, so
    #: the batch dimension is what amortizes the per-dispatch sort cost
    @functools.cached_property
    def _STREAM_ELEMS_LOG2(self) -> int:
        env = os.environ.get("GSEARCH_TPU_STREAM_ELEMS_LOG2")
        if env:
            return int(env)
        return 27 if device_profile().accelerated else 24

    def _stream_rows(self, codes):
        """Host-side piece assembly for one long genome: returns
        ("exc", p2, lens, inv) rows ready for a streaming dispatch, or
        None when the genome needs a fallback path.  Rows are max-block
        shaped; piece starts overlap by k-1 (4-aligned in packed form)."""
        from ..io.codec import PackedCodes

        max_block = 1 << self.MAX_BLOCK_LOG2
        nb = max_block
        if (isinstance(codes, PackedCodes)
                and not (self.is_aa or self._upload_raw)
                and not self.MULTIPLICITY_SENSITIVE):
            pk = codes
            step = max_block - (self.k - 1)
            step -= step % 4
            starts = list(range(0, pk.n, step))
            b = len(starts)
            p2 = np.zeros((b, nb // 4), np.uint8)
            lens = np.zeros(b, np.int32)
            inv = np.full((b, self._MAX_EXC), nb, np.int32)
            for j, st in enumerate(starts):
                pc = pk.piece(st, max_block)
                if pc.inv.size > self._MAX_EXC:
                    return None
                m = (pc.n + 3) // 4
                p2[j, :m] = pc.p2[:m]
                lens[j] = pc.n
                inv[j, : pc.inv.size] = pc.inv
            return ("exc", p2, lens, inv)
        if self.is_aa or self._upload_raw:
            return None  # raw rows ship through _race_stream_device
        if isinstance(codes, PackedCodes):
            codes = codes.to_codes()
        n = len(codes)
        step = max_block - (self.k - 1)
        starts = list(range(0, n, step))
        b = len(starts)
        arr = np.full((b, nb), 255, np.uint8)
        lens = np.zeros(b, np.int32)
        for j, st in enumerate(starts):
            pc = codes[st : st + max_block]
            arr[j, : len(pc)] = pc
            lens[j] = len(pc)
        packed = self._pack_host_exc(arr, lens)
        if packed is None:
            return None
        return ("exc",) + packed

    def _race_stream_device(self, codes):
        """Race a longer-than-one-block genome with batched piece
        dispatches (see _race_stream_fn).  Accepts PackedCodes or a u8
        code array; returns a device RaceResult, or None when the input
        needs a fallback path (N-run-heavy beyond the exception budget)."""
        from ..io.codec import PackedCodes

        max_block = 1 << self.MAX_BLOCK_LOG2
        nb = max_block
        bmax = max(1, (1 << self._BATCH_ELEMS_LOG2) // nb)
        packed_direct = (
            isinstance(codes, PackedCodes)
            and not (self.is_aa or self._upload_raw)
            and not self.MULTIPLICITY_SENSITIVE
        )
        race = None
        if packed_direct:
            pk = codes
            step = max_block - (self.k - 1)
            step -= step % 4  # byte-aligned piece starts in the 2-bit form
            starts = list(range(0, pk.n, step))
            for c0 in range(0, len(starts), bmax):
                grp = starts[c0 : c0 + bmax]
                b = len(grp)
                p2 = np.zeros((b, nb // 4), np.uint8)
                lens = np.zeros(b, np.int32)
                inv = np.full((b, self._MAX_EXC), nb, np.int32)
                for j, st in enumerate(grp):
                    pc = pk.piece(st, max_block)
                    if pc.inv.size > self._MAX_EXC:
                        return None  # N-run-heavy piece: bit-plane fallback
                    m = (pc.n + 3) // 4
                    p2[j, :m] = pc.p2[:m]
                    lens[j] = pc.n
                    inv[j, : pc.inv.size] = pc.inv
                r = self._race_stream_fn(b, nb, "exc")(
                    jnp.asarray(p2), jnp.asarray(lens), jnp.asarray(inv))
                race = r if race is None else self._combine_fn(race, r)
            return race
        # u8-codes path: AA / raw uploads / multiplicity-sensitive
        # algorithms (exact k-1-overlap pieces, no 4-alignment duplication)
        if isinstance(codes, PackedCodes):
            codes = codes.to_codes()
        n = len(codes)
        step = max_block - (self.k - 1)
        starts = list(range(0, n, step))
        for c0 in range(0, len(starts), bmax):
            grp = starts[c0 : c0 + bmax]
            b = len(grp)
            arr = np.full((b, nb), 255, np.uint8)
            lens = np.zeros(b, np.int32)
            for j, st in enumerate(grp):
                pc = codes[st : st + max_block]
                arr[j, : len(pc)] = pc
                lens[j] = len(pc)
            if self.is_aa or self._upload_raw:
                r = self._race_stream_fn(b, nb, "raw")(jnp.asarray(arr))
            else:
                packed = self._pack_host_exc(arr, lens)
                if packed is None:
                    return None  # N-run-heavy: caller's bit-plane path
                p2, lens2, inv = packed
                r = self._race_stream_fn(b, nb, "exc")(
                    jnp.asarray(p2), jnp.asarray(lens2), jnp.asarray(inv))
            race = r if race is None else self._combine_fn(race, r)
        return race

    @functools.cached_property
    def _combine_fn(self):
        return jax.jit(combine_race)

    @functools.cached_property
    def _finalize_fn(self):
        return jax.jit(self._finalize_race)

    # ---- public API ----------------------------------------------------------

    def sketch_codes(self, codes: np.ndarray) -> np.ndarray:
        """One genome (uint8 code array) -> one signature [nb_slots]."""
        race = self._race_codes(codes)
        return np.asarray(self._finalize_fn(race))

    # longest contiguous block a genome is processed in before streaming
    # kicks in; subclasses whose statistics span the whole genome (e.g.
    # ProbMinHash multiplicities) raise it
    MAX_BLOCK_LOG2 = _MAX_BLOCK_LOG2

    def _race_codes(self, codes) -> RaceResult:
        from ..io.codec import PackedCodes

        if isinstance(codes, PackedCodes):
            if self.is_aa or self._upload_raw:
                codes = codes.to_codes()  # packed form is DNA-upload-only
            else:
                return self._race_packed(codes)
        n = len(codes)
        max_block = 1 << self.MAX_BLOCK_LOG2
        if n <= max_block:
            return self._run_block(codes)
        # stream long genomes through max-size pieces overlapping by k-1 so
        # no window is lost at piece boundaries; pieces go to the device
        # BATCHED (one dispatch per genome, row-reduced in-graph)
        race = self._race_stream_device(codes)
        if race is not None:
            return race
        race = None  # N-run-heavy fallback: per-piece bit-plane blocks
        step = max_block - (self.k - 1)
        for start in range(0, n, step):
            piece = codes[start : start + max_block]
            r = self._run_block(piece)
            race = r if race is None else self._combine_fn(race, r)
        return race

    def _race_packed(self, pk) -> RaceResult:
        """Streaming race over a PackedCodes genome (no host unpack)."""
        max_block = 1 << self.MAX_BLOCK_LOG2
        if pk.n <= max_block:
            return self._run_block_packed(pk)
        if self.MULTIPLICITY_SENSITIVE:
            # 4-aligned piece starts duplicate up to 3 boundary windows —
            # exact multiplicities require the unpacked k-1-overlap path
            return self._race_codes(pk.to_codes())
        race = self._race_stream_device(pk)  # batched piece dispatches
        if race is not None:
            return race
        step = max_block - (self.k - 1)
        step -= step % 4  # keep piece starts byte-aligned in the 2-bit form
        race = None  # N-run-heavy fallback: per-piece blocks
        for start in range(0, pk.n, step):
            r = self._run_block_packed(pk.piece(start, max_block))
            race = r if race is None else self._combine_fn(race, r)
        return race

    def _run_block_packed(self, pk) -> RaceResult:
        if pk.inv.size > self._MAX_EXC:  # N-run-heavy: bit-plane fallback
            return self._run_block(pk.to_codes())
        n_true = pk.n
        nb = block_length(n_true, self.MAX_BLOCK_LOG2)
        p2 = np.empty(nb // 4, np.uint8)  # garbage past n_true: masked by lens
        m = (n_true + 3) // 4
        p2[:m] = pk.p2[:m]
        inv = np.full(self._MAX_EXC, nb, np.int32)
        inv[: pk.inv.size] = pk.inv
        return self._block_fn(nb)(
            jnp.asarray(p2[None]),
            jnp.asarray(np.array([n_true], np.int32)),
            jnp.asarray(inv[None]),
        )

    def _run_block(self, codes: np.ndarray) -> RaceResult:
        n_true = len(codes)
        nb = block_length(n_true, self.MAX_BLOCK_LOG2)
        if n_true < nb:
            codes = np.pad(codes, (0, nb - n_true), constant_values=255)
        if self.is_aa or self._upload_raw:
            return self._block_fn(nb)(jnp.asarray(codes))
        packed = self._pack_host_exc(codes[None, :], np.array([n_true]))
        if packed is None:
            p2, vb = self._pack_host(codes[None, :])
            return self._block_fn_plane(nb)(jnp.asarray(p2), jnp.asarray(vb))
        p2, lens, inv = packed
        return self._block_fn(nb)(jnp.asarray(p2), jnp.asarray(lens), jnp.asarray(inv))

    # total elements per batched dispatch: bounds sort memory and keeps one
    # compiled (batch, block) shape per block bucket.  2^23 on every
    # device: on an H100 it sketched as fast as 2^25 (PERF.md)
    @functools.cached_property
    def _BATCH_ELEMS_LOG2(self) -> int:
        env = os.environ.get("GSEARCH_TPU_BATCH_ELEMS_LOG2")
        return int(env) if env else 23

    #: bound on dispatches outstanding to the collector thread; the
    #: window lets host pack/assembly and upload of batch i+1..i+w
    #: overlap device compute AND result download of batch i
    INFLIGHT = 4

    def _ensure_collector(self):
        """Start the result-collector thread (the reference's collector
        thread group, dnasketch.rs:330-456): it alone calls np.asarray on
        finished dispatches, so the submit thread's dispatch stream never
        syncs and the device pipeline stays full."""
        if self._collect_q is not None:
            return
        import queue
        import threading

        self._collect_q = queue.Queue(maxsize=2 * self.INFLIGHT)
        self._collect_cv = threading.Condition()

        def loop():
            while True:
                item = self._collect_q.get()
                if item is None:
                    return
                tkt, chunk, dev_sigs = item
                try:
                    sigs = np.asarray(dev_sigs)
                    for row, i in enumerate(chunk):
                        tkt.out[i] = sigs[row]
                    err = None
                except BaseException as e:  # surfaced by sketch_finish
                    err = e
                with self._collect_cv:
                    if err is not None and tkt.err is None:
                        tkt.err = err
                    tkt.open_batches -= 1
                    self._collect_cv.notify_all()

        threading.Thread(
            target=loop, daemon=True, name="gsearch-collector"
        ).start()

    def _dispatch_to_collector(self, ticket, chunk, dev_sigs):
        with self._collect_cv:
            ticket.open_batches += 1
        # blocking put = backpressure: bounds outstanding device inputs
        self._collect_q.put((ticket, chunk, dev_sigs))

    def sketch_many(self, codes_list: Sequence[np.ndarray]) -> np.ndarray:
        """Signatures for a list of genomes, stacked [B, nb_slots]."""
        return self.sketch_finish(self.sketch_submit(codes_list))

    def sketch_submit(self, codes_list: Sequence[np.ndarray]) -> "SketchTicket":
        """Asynchronously dispatch signatures for a list of genomes.

        Genomes are grouped by block bucket and sketched in batched device
        dispatches; only genomes longer than the largest block fall back to
        the streaming per-genome path.  Dispatches stay in flight on a
        sketcher-wide window, so successive submits from the ingest
        pipeline keep the device busy across flush boundaries
        (reference role: the sketcher thread pool of dnasketch.rs:246-325;
        here the overlap is host-pack/upload vs device compute)."""
        from ..io.codec import PackedCodes

        out = np.empty((len(codes_list), self.nb_slots), dtype=self.SIG_DTYPE)
        ticket = SketchTicket(out)
        # the INSTANCE block size, not the module default: subclasses and
        # tests raise/shrink MAX_BLOCK_LOG2, and the short/long routing
        # must agree with _race_codes or a genome near the boundary takes
        # a different window partition than the per-genome path (the
        # packed race's windowed pre-reduce is ~1e-4 partition-sensitive)
        max_block = 1 << self.MAX_BLOCK_LOG2
        pack_ok = not (self.is_aa or self._upload_raw)
        if not pack_ok:  # packed inputs need the raw-code forms
            codes_list = [
                c.to_codes() if isinstance(c, PackedCodes) else c
                for c in codes_list
            ]
        self._ensure_collector()
        groups: dict = {}
        long_groups: dict = {}  # piece count -> [(out_row, piece rows)]
        for i, codes in enumerate(codes_list):
            if len(codes) > max_block:
                # long genome (most real bacteria are 2-10 Mbases, larger
                # than one block): assemble its piece rows now, dispatch
                # them batched ACROSS genomes below.  Fallbacks (mesh
                # sharding, N-run-heavy, raw/AA uploads) stream per genome
                # with an on-device finalize handed to the collector — an
                # inline np.asarray here would sync the dispatch pipeline
                rows = None if self.mesh is not None else self._stream_rows(codes)
                if (rows is not None and rows[1].shape[0] * max_block
                        > (1 << self._STREAM_ELEMS_LOG2)):
                    # one contig bigger than the whole dispatch budget
                    # (chromosome-scale): the per-genome path chunks its
                    # pieces by the budget; a single seg dispatch would
                    # put the entire contig's rows in one program
                    rows = None
                if rows is None:
                    race = self._race_codes(codes)
                    self._dispatch_to_collector(
                        ticket, [i], self._finalize_fn(race)[None])
                else:
                    long_groups.setdefault(rows[1].shape[0], []).append((i, rows))
            else:
                # fused-parsed genomes batch in their packed form directly
                # (no unpack, no repack); over-budget exception lists (rare
                # N-run-heavy files) fall back to the code-array form
                pk = (isinstance(codes, PackedCodes)
                      and codes.inv.size <= self._MAX_EXC)
                nb_i = block_length(len(codes), self.MAX_BLOCK_LOG2)
                groups.setdefault((nb_i, pk), []).append(i)

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            nd = int(np.prod(self.mesh.devices.shape))

            def put(x):
                # batch rows shard over the mesh; the jitted race runs SPMD
                # per-chip with no collectives
                spec = P("d", *([None] * (x.ndim - 1)))
                return jax.device_put(x, NamedSharding(self.mesh, spec))
        else:
            nd = 1
            put = jnp.asarray

        for (nb, grp_pk), idxs in groups.items():
            bcap = (1 << self._BATCH_ELEMS_LOG2) // nb
            # round DOWN to a power of two so full batches share one
            # compiled shape with every other bucket-size run
            bcap = max(nd, 1 << max(bcap.bit_length() - 1, 0))
            for start in range(0, len(idxs), bcap):
                chunk = idxs[start : start + bcap]
                b = nd
                while b < len(chunk):
                    b <<= 1
                b = min(b, bcap)
                if grp_pk:
                    # pre-packed rows: memcpy 0.25 B/base straight into the
                    # exc-form batch — parse already produced upload bytes
                    p2 = np.empty((b, nb // 4), np.uint8)
                    lens = np.zeros(b, np.int32)
                    inv = np.full((b, self._MAX_EXC), nb, np.int32)
                    for row, i in enumerate(chunk):
                        g = codes_list[i]
                        m = (g.n + 3) // 4
                        p2[row, :m] = g.p2[:m]
                        lens[row] = g.n
                        inv[row, : g.inv.size] = g.inv
                    dev = self._batch_fn(b, nb, "exc")(
                        put(p2), put(lens), put(inv))
                    self._dispatch_to_collector(ticket, chunk, dev)
                    continue
                if pack_ok:
                    # exc-form packing masks by per-row length, so padding
                    # (and unused rows) may hold garbage: skip the 32 MB
                    # np.full clear, pay only the genome memcpy
                    arr = np.empty((b, nb), dtype=np.uint8)
                else:
                    arr = np.full((b, nb), 255, dtype=np.uint8)
                lens = np.zeros(b, dtype=np.int32)
                for row, i in enumerate(chunk):
                    c = codes_list[i]
                    if isinstance(c, PackedCodes):  # over-budget exc list
                        c = c.to_codes()
                    arr[row, : len(c)] = c
                    lens[row] = len(c)
                if not pack_ok:
                    form = "raw" if not self.is_aa else "exc"  # key only
                    dev = self._batch_fn(b, nb, form)(put(arr))
                else:
                    packed = self._pack_host_exc(arr, lens)
                    if packed is not None:
                        p2, lens, inv = packed
                        dev = self._batch_fn(b, nb, "exc")(
                            put(p2), put(lens), put(inv))
                    else:  # N-run-heavy batch: validity bit plane
                        arr[arr >= 4] = 255  # garbage padding -> invalid
                        for row in range(len(chunk), b):
                            arr[row] = 255
                        p2, vb = self._pack_host(arr)
                        dev = self._batch_fn(b, nb, "plane")(put(p2), put(vb))
                self._dispatch_to_collector(ticket, chunk, dev)
        # cross-genome streaming dispatches: g genomes x p piece rows per
        # program, unused tail rows dead (lens 0, ignored by the collector)
        nbl = 1 << self.MAX_BLOCK_LOG2
        for p, items in long_groups.items():
            gcap = max(1, (1 << self._STREAM_ELEMS_LOG2) // (p * nbl))
            gcap = 1 << max(gcap.bit_length() - 1, 0)
            for start in range(0, len(items), gcap):
                chunk = items[start : start + gcap]
                g = 1
                while g < len(chunk):
                    g <<= 1
                g = min(g, gcap)
                rows = g * p
                p2 = np.zeros((rows, nbl // 4), np.uint8)
                lens = np.zeros(rows, np.int32)
                inv = np.full((rows, self._MAX_EXC), nbl, np.int32)
                idxs = []
                for r, (i, (_, rp2, rlens, rinv)) in enumerate(chunk):
                    p2[r * p : (r + 1) * p] = rp2
                    lens[r * p : (r + 1) * p] = rlens
                    inv[r * p : (r + 1) * p] = rinv
                    idxs.append(i)
                dev = self._race_stream_seg_fn(g, p, nbl, "exc")(
                    jnp.asarray(p2), jnp.asarray(lens), jnp.asarray(inv))
                self._dispatch_to_collector(ticket, idxs, dev)
        return ticket

    def sketch_finish(self, ticket: "SketchTicket") -> np.ndarray:
        """Block until every batch of `ticket` has landed; return its rows."""
        if self._collect_cv is None:
            return ticket.out  # no batched dispatches were submitted
        with self._collect_cv:
            while ticket.open_batches > 0:
                self._collect_cv.wait(timeout=60.0)
            if ticket.err is not None:
                raise ticket.err
        return ticket.out


def make_sketcher(params: SeqSketcherParams, seed: int = 0x5EED) -> SketcherBase:
    """Algorithm dispatch, the analog of the reference's static dispatch in
    dna_process_tohnsw / aa_process_tohnsw (dnasketch.rs:493-644)."""
    from .optdens import OptDensSketcher, RevOptDensSketcher
    from .probminhash import ProbMinHashSketcher
    from .setsketch import SetSketchSketcher
    from .superminhash import SuperMinHash2Sketcher, SuperMinHashSketcher

    table = {
        SketchAlgo.OPTDENS: OptDensSketcher,
        SketchAlgo.REVOPTDENS: RevOptDensSketcher,
        SketchAlgo.SUPER: SuperMinHashSketcher,
        SketchAlgo.SUPER2: SuperMinHash2Sketcher,
        SketchAlgo.PROB3A: ProbMinHashSketcher,
        SketchAlgo.HLL: SetSketchSketcher,
    }
    return table[params.algo](params, seed=seed)
