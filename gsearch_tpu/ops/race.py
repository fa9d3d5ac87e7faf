"""The unified "dart race" primitive: per-slot minimum over hashed darts.

Every sketching algorithm in this framework (OptDens/RevOptDens OPH,
SuperMinHash, ProbMinHash, SetSketch/HLL) reduces to the same device
pattern: a stream of darts (slot, key[, payload]) where two genomes sharing
a k-mer produce identical darts, and the signature slot s keeps the dart
with the minimal key among all darts aimed at s.  On CPU the reference
implements each of these as a hash-table / heap inner loop inside
probminhash (reference call sites: src/dna/dnasketch.rs:336,357); on the device we
replace all of them with one batched lexicographic sort + run-head lookup —
no scatters, no pointer chasing, fully MXU/VPU-friendly shapes.

bucket_min(slots, keys, payload):
  1. sort darts by (slot, key, payload)  — jax.lax.sort, 3 operands, 2 keys
  2. the first dart of each slot-run is that slot's winner
  3. winners are extracted with a vectorized binary search (searchsorted)
     of [0..S) into the sorted slot column — S gathers, not N scatters.

Chunked/streaming sketching combines partial races with `combine_race`,
an associative elementwise min — so genomes of any length stream through
fixed-shape device batches without recompilation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class RaceResult(NamedTuple):
    found: jnp.ndarray    # bool [..., S] — slot received at least one dart
    key: jnp.ndarray      # uint32 [..., S] — minimal key (undefined where !found)
    payload: jnp.ndarray  # uint32 [..., S] — payload of the winning dart


def bucket_min(
    slots: jnp.ndarray,
    keys: jnp.ndarray,
    nb_slots: int,
    payload: Optional[jnp.ndarray] = None,
    valid: Optional[jnp.ndarray] = None,
) -> RaceResult:
    """Per-slot minimum-key dart over the last axis.

    slots: int32 [..., N] in [0, nb_slots); keys: uint32 [..., N];
    payload: optional uint32 [..., N]; valid: optional bool [..., N].
    Invalid darts are routed to a virtual overflow slot == nb_slots.
    """
    slots = slots.astype(jnp.int32)
    if valid is not None:
        slots = jnp.where(valid, slots, jnp.int32(nb_slots))
    operands = [slots, keys]
    if payload is not None:
        operands.append(payload)
    sorted_ops = jax.lax.sort(tuple(operands), dimension=-1, num_keys=min(len(operands), 3))
    s_slots, s_keys = sorted_ops[0], sorted_ops[1]
    s_pay = sorted_ops[2] if payload is not None else s_keys

    targets = jnp.arange(nb_slots, dtype=jnp.int32)

    def row_search(srow):
        return jnp.searchsorted(srow, targets, side="left").astype(jnp.int32)

    batch_shape = slots.shape[:-1]
    n = slots.shape[-1]
    flat_slots = s_slots.reshape((-1, n))
    idx = jax.vmap(row_search)(flat_slots).reshape(batch_shape + (nb_slots,))

    idx_c = jnp.minimum(idx, n - 1)
    hit = jnp.take_along_axis(s_slots, idx_c, axis=-1)
    found = (hit == targets) & (idx < n)
    key = jnp.take_along_axis(s_keys, idx_c, axis=-1)
    pay = jnp.take_along_axis(s_pay, idx_c, axis=-1)
    return RaceResult(found=found, key=key, payload=pay)


def combine_race(a: RaceResult, b: RaceResult) -> RaceResult:
    """Associative merge of two partial races (elementwise min by
    (key, payload) with found-ness dominance)."""
    a_wins = a.found & (
        ~b.found
        | (a.key < b.key)
        | ((a.key == b.key) & (a.payload <= b.payload))
    )
    return RaceResult(
        found=a.found | b.found,
        key=jnp.where(a_wins, a.key, b.key),
        payload=jnp.where(a_wins, a.payload, b.payload),
    )


_PR_WINDOW = 32      # pre-reduce window width
_PR_KEEP = 6         # darts kept per window


def bucket_min_packed(
    slots: jnp.ndarray,
    keys: jnp.ndarray,
    nb_slots: int,
    valid: Optional[jnp.ndarray] = None,
) -> RaceResult:
    """Fast path for payload-free races (OPH/OptDens): windowed top-K
    pre-reduction + one scatter-min.  No sorts, no gathers — both were
    measured pathological on the earlier accelerator path (sorted-stream lookup gathers:
    ~700ms for 32x1M; plain scatter-min of every dart: ~370ms).

    Each dart packs as (key-high-bits | slot) in one u32 word, so a plain
    min-reduce over a positional window keeps the window's best dart AND
    its slot.  Keeping the top _PR_KEEP distinct words per window shrinks
    the scatter's update stream W/K-fold; a slot's true winner is lost
    only if >= K smaller-keyed darts share its window — with t darts per
    slot that is ~C(W-1,K)/(t+1)^K, <= 1e-4 for the gated shapes (the
    gate requires n/window >= a safe darts-per-slot floor; smaller inputs
    take the plain scatter, which is already cheap at their size).
    """
    slot_bits = max(1, (nb_slots).bit_length())
    low_mask = (1 << slot_bits) - 1
    slots = slots.astype(jnp.uint32)
    keys_hi = keys & jnp.uint32(~np.uint32(low_mask))
    dart = keys_hi | slots
    if valid is not None:
        dart = jnp.where(valid, dart, jnp.uint32(0xFFFFFFFF))
    else:
        dart = jnp.where(slots < nb_slots, dart, jnp.uint32(0xFFFFFFFF))

    batch_shape = dart.shape[:-1]
    n = dart.shape[-1]
    w, k = _PR_WINDOW, _PR_KEEP
    # safety gate: worst-case darts-per-slot for this static shape (a
    # genome can fill as little as ~half its block bucket)
    if n % w == 0 and (n // 2) / nb_slots >= 40:
        # strided bubble-insert: window g = positions [g*w, (g+1)*w); the w
        # strided slices [.., j::w] are lane-friendly [B, n/w] arrays and
        # the K-deep insertion chain is pure elementwise min/max.  Exact
        # duplicates (repeat k-mers) are dropped as they enter the chain so
        # tandem repeats cannot evict other slots' minima.
        sent = jnp.uint32(0xFFFFFFFF)
        mins = [jnp.full(batch_shape + (n // w,), sent, jnp.uint32) for _ in range(k)]
        for j in range(w):
            x = dart[..., j::w]
            for i in range(k):
                dup = x == mins[i]
                new_min = jnp.minimum(mins[i], x)
                x = jnp.where(dup, sent, jnp.maximum(mins[i], x))
                mins[i] = new_min
        dart = jnp.concatenate(mins, axis=-1)

    sentinel = jnp.uint32(0xFFFFFFFF)
    nb_pad = 1 << slot_bits
    init = jnp.full(batch_shape + (nb_pad,), sentinel, dtype=jnp.uint32)
    tgt = (dart & jnp.uint32(low_mask)).astype(jnp.int32)
    if batch_shape:
        b = int(np.prod(batch_shape))
        nn = dart.shape[-1]
        rows = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[:, None], (b, nn))
        out = init.reshape(b, nb_pad).at[rows, tgt.reshape(b, nn)].min(
            dart.reshape(b, nn)
        ).reshape(batch_shape + (nb_pad,))
    else:
        out = init.at[tgt].min(dart)
    out = out[..., :nb_slots]
    # empty slot <=> still sentinel (a real dart with all key-high bits set
    # maps there with prob 2^-(32-slot_bits); indistinguishable, harmless)
    found = out != sentinel
    return RaceResult(found=found, key=out, payload=out)


def bucket_min_packed_payload(
    slots: jnp.ndarray,
    keys: jnp.ndarray,
    payload: jnp.ndarray,
    nb_slots: int,
    valid: Optional[jnp.ndarray] = None,
) -> RaceResult:
    """Payload-carrying variant of the packed race (used by ProbMinHash):
    the same windowed top-K pre-reduction, with the payload swapped along
    the key chain, then ONE scatter-min on a word that carries the
    quantized key in its high bits and the truncated payload in its low
    bits — the payload low bits double as the deterministic tie-break.

    Costs vs exactness: winner selection quantizes the key to its top
    (32 - slot_bits) bits (ties broken by payload, identically in every
    genome), and the recovered payload keeps slot_bits bits (different
    winners collide with prob 2^-slot_bits per slot — ~6e-5 for s=12000,
    far below 1/sqrt(S) sketch noise).

    CAVEAT: the windowed pre-reduction's loss bound assumes the VALID dart
    density ~ the stream length; algorithms whose valid darts are sparse
    or data-dependent (ProbMinHash emits darts only at distinct-k-mer
    representatives) can undercut it on duplication-heavy genomes — use
    the exact sort race there.
    """
    slot_bits = max(1, (nb_slots).bit_length())
    low_mask = np.uint32((1 << slot_bits) - 1)
    hi_mask = np.uint32(0xFFFFFFFF ^ int(low_mask))
    slots = slots.astype(jnp.uint32)
    word = (keys & jnp.uint32(hi_mask)) | slots
    if valid is not None:
        word = jnp.where(valid, word, jnp.uint32(0xFFFFFFFF))
    else:
        word = jnp.where(slots < nb_slots, word, jnp.uint32(0xFFFFFFFF))

    batch_shape = word.shape[:-1]
    n = word.shape[-1]
    w, k = _PR_WINDOW, _PR_KEEP
    if n % w == 0 and (n // 2) / nb_slots >= 40:
        sent = jnp.uint32(0xFFFFFFFF)
        mins = [jnp.full(batch_shape + (n // w,), sent, jnp.uint32) for _ in range(k)]
        pays = [jnp.zeros(batch_shape + (n // w,), jnp.uint32) for _ in range(k)]
        for j in range(w):
            x = word[..., j::w]
            px = payload[..., j::w]
            for i in range(k):
                dup = x == mins[i]
                smaller = x < mins[i]
                new_min = jnp.where(smaller, x, mins[i])
                new_pay = jnp.where(smaller, px, pays[i])
                x, px = (
                    jnp.where(dup, sent, jnp.where(smaller, mins[i], x)),
                    jnp.where(smaller, pays[i], px),
                )
                mins[i], pays[i] = new_min, new_pay
        word = jnp.concatenate(mins, axis=-1)
        payload = jnp.concatenate(pays, axis=-1)

    sent = jnp.uint32(0xFFFFFFFF)
    word2 = jnp.where(
        word == sent, sent, (word & jnp.uint32(hi_mask)) | (payload & jnp.uint32(low_mask))
    )
    tgt = (word & jnp.uint32(low_mask)).astype(jnp.int32)
    nb_pad = 1 << slot_bits
    init = jnp.full(batch_shape + (nb_pad,), sent, dtype=jnp.uint32)
    if batch_shape:
        b = int(np.prod(batch_shape))
        nn = word.shape[-1]
        rows = jnp.broadcast_to(jnp.arange(b, dtype=jnp.int32)[:, None], (b, nn))
        out = init.reshape(b, nb_pad).at[rows, tgt.reshape(b, nn)].min(
            word2.reshape(b, nn)
        ).reshape(batch_shape + (nb_pad,))
    else:
        out = init.at[tgt].min(word2)
    out = out[..., :nb_slots]
    found = out != sent
    return RaceResult(
        found=found, key=out & jnp.uint32(hi_mask), payload=out & jnp.uint32(low_mask)
    )


def sketch_fingerprint(race: RaceResult) -> jnp.ndarray:
    """A per-genome scalar (min over found keys) used to make empty-slot
    fillers genome-DEPENDENT: a genome-independent filler would make two
    sparse genomes agree on every commonly-empty slot, inflating their
    similarity.  Keepdims so it broadcasts over the slot axis."""
    big = jnp.uint32(0xFFFFFFFF)
    return jnp.min(jnp.where(race.found, race.key, big), axis=-1, keepdims=True)


def empty_race(batch_shape: tuple, nb_slots: int) -> RaceResult:
    return RaceResult(
        found=jnp.zeros(batch_shape + (nb_slots,), dtype=jnp.bool_),
        key=jnp.full(batch_shape + (nb_slots,), 0xFFFFFFFF, dtype=jnp.uint32),
        payload=jnp.zeros(batch_shape + (nb_slots,), dtype=jnp.uint32),
    )
