"""Property tests: slot-agreement of sketches ~ exact Jaccard within CLT bounds.

This is the designed-from-scratch test strategy the reference lacks
(SURVEY.md §4): every sketcher's signature similarity must track the exact
(canonical k-mer set) Jaccard of two related genomes.
"""

import numpy as np
import pytest

from gsearch_tpu.core.params import DataType, SeqSketcherParams, SketchAlgo
from gsearch_tpu.io.codec import encode_dna
from gsearch_tpu.models import make_sketcher

from conftest import exact_canonical_kmer_set, exact_jaccard, mutate_dna, random_dna

K = 12
S = 1024
GENOME = 20_000


def _slot_agreement(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
    return float((sig_a == sig_b).mean())


def _params(algo):
    return SeqSketcherParams(kmer_size=K, sketch_size=S, algo=algo, data_t=DataType.DNA)


@pytest.mark.parametrize(
    "algo", [SketchAlgo.OPTDENS, SketchAlgo.REVOPTDENS, SketchAlgo.SUPER, SketchAlgo.SUPER2]
)
@pytest.mark.smoke
def test_unweighted_sketch_tracks_jaccard(rng, algo):
    seq_a = random_dna(rng, GENOME)
    sk = make_sketcher(_params(algo))
    for rate in (0.002, 0.01, 0.05):
        seq_b = mutate_dna(rng, seq_a, rate)
        ka = exact_canonical_kmer_set(seq_a, K)
        kb = exact_canonical_kmer_set(seq_b, K)
        j_exact = exact_jaccard(ka, kb)
        sig_a = sk.sketch_codes(encode_dna(seq_a))
        sig_b = sk.sketch_codes(encode_dna(seq_b))
        j_est = _slot_agreement(sig_a, sig_b)
        tol = 4.5 * np.sqrt(j_exact * (1 - j_exact) / S) + 0.02
        assert abs(j_est - j_exact) < tol, f"{algo}: rate={rate} exact={j_exact:.4f} est={j_est:.4f}"


def test_identical_genomes_distance_zero(rng):
    seq = random_dna(rng, GENOME)
    for algo in SketchAlgo:
        sk = make_sketcher(_params(algo))
        sig1 = sk.sketch_codes(encode_dna(seq))
        sig2 = sk.sketch_codes(encode_dna(seq))
        assert (sig1 == sig2).all(), f"{algo} not deterministic"


def test_revcomp_invariance(rng):
    """A genome and its reverse complement must sketch identically."""
    seq = random_dna(rng, GENOME)
    rc = seq.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
    for algo in (SketchAlgo.OPTDENS, SketchAlgo.PROB3A):
        sk = make_sketcher(_params(algo))
        sig1 = sk.sketch_codes(encode_dna(seq))
        sig2 = sk.sketch_codes(encode_dna(rc))
        np.testing.assert_array_equal(sig1, sig2, err_msg=str(algo))


def test_sparse_genomes_no_spurious_agreement(rng):
    """Inputs much smaller than the sketch leave most slots empty; the
    genome-dependent filler must keep unrelated sparse inputs at ~zero
    agreement (a shared filler previously inflated it to >10%)."""
    seq_a = random_dna(rng, 2_000)
    seq_b = random_dna(rng, 2_000)
    params = SeqSketcherParams(kmer_size=16, sketch_size=4096, algo="SUPER", data_t="DNA")
    for algo in (SketchAlgo.SUPER, SketchAlgo.PROB3A, SketchAlgo.OPTDENS):
        p = SeqSketcherParams(kmer_size=16, sketch_size=4096, algo=algo, data_t="DNA")
        sk = make_sketcher(p)
        sig_a = sk.sketch_codes(encode_dna(seq_a))
        sig_b = sk.sketch_codes(encode_dna(seq_b))
        agree = _slot_agreement(sig_a, sig_b)
        assert agree < 0.02, f"{algo}: sparse agreement {agree}"
        # determinism preserved
        np.testing.assert_array_equal(sig_a, sk.sketch_codes(encode_dna(seq_a)))
    del params


def test_unrelated_genomes_low_agreement(rng):
    seq_a = random_dna(rng, GENOME)
    seq_b = random_dna(rng, GENOME)
    for algo in (SketchAlgo.OPTDENS, SketchAlgo.SUPER, SketchAlgo.PROB3A, SketchAlgo.HLL):
        sk = make_sketcher(_params(algo))
        sig_a = sk.sketch_codes(encode_dna(seq_a))
        sig_b = sk.sketch_codes(encode_dna(seq_b))
        assert _slot_agreement(sig_a, sig_b) < 0.05, str(algo)


def test_probminhash_weighted(rng):
    """PROB3A estimates probability-Jaccard J_P of the k-mer spectra."""
    seq_a = random_dna(rng, GENOME)
    seq_b = mutate_dna(rng, seq_a, 0.01)
    # exact J_P over canonical k-mer multiplicity spectra
    from collections import Counter

    def spectrum(seq):
        comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
        s = seq.decode()
        c = Counter()
        for i in range(len(s) - K + 1):
            km = s[i : i + K]
            rc = "".join(comp[ch] for ch in reversed(km))
            c[min(km, rc)] += 1
        return c

    ca, cb = spectrum(seq_a), spectrum(seq_b)
    keys = sorted(set(ca) | set(cb))
    wa = np.array([ca[x] for x in keys], dtype=np.float64)
    wb = np.array([cb[x] for x in keys], dtype=np.float64)
    # J_P = sum_x 1 / sum_y max(wy_A/wx_A, wy_B/wx_B), terms with wx_A*wx_B=0
    # contribute 0.  denom_x depends only on the pair (wx_A, wx_B), so group.
    both = (wa > 0) & (wb > 0)
    pairs, counts = np.unique(np.stack([wa[both], wb[both]], 1), axis=0, return_counts=True)
    jp = 0.0
    for (c_a, c_b), cnt in zip(pairs, counts):
        denom = np.maximum(wa * c_b, wb * c_a).sum() / (c_a * c_b)
        jp += cnt / denom
    sk = make_sketcher(_params(SketchAlgo.PROB3A))
    sig_a = sk.sketch_codes(encode_dna(seq_a))
    sig_b = sk.sketch_codes(encode_dna(seq_b))
    j_est = _slot_agreement(sig_a, sig_b)
    tol = 4.5 * np.sqrt(max(jp * (1 - jp), 0.01) / S) + 0.02
    assert abs(j_est - jp) < tol, f"exact J_P={jp:.4f} est={j_est:.4f}"


def test_probminhash_scale_invariance(rng):
    """J_P(A+A, A) = 1: doubling every multiplicity must not change the
    sketch (probability-Jaccard normalization, unlike multiset Jaccard)."""
    seq = random_dna(rng, 10_000)
    doubled = seq + b"N" + seq  # separator keeps junction k-mers out
    sk = make_sketcher(_params(SketchAlgo.PROB3A))
    sig_a = sk.sketch_codes(encode_dna(seq))
    sig_aa = sk.sketch_codes(encode_dna(doubled))
    agreement = _slot_agreement(sig_a, sig_aa)
    assert agreement > 0.995, f"agreement {agreement}"


def test_hll_tracks_jaccard_coarsely(rng):
    seq_a = random_dna(rng, GENOME)
    seq_b = mutate_dna(rng, seq_a, 0.01)
    ka = exact_canonical_kmer_set(seq_a, K)
    kb = exact_canonical_kmer_set(seq_b, K)
    j_exact = exact_jaccard(ka, kb)
    sk = make_sketcher(_params(SketchAlgo.HLL))
    sig_a = sk.sketch_codes(encode_dna(seq_a))
    sig_b = sk.sketch_codes(encode_dna(seq_b))
    assert sig_a.dtype == np.uint16
    j_est = _slot_agreement(sig_a, sig_b)
    # same-size genomes: register equality ~ race-winner equality ~ Jaccard
    tol = 4.5 * np.sqrt(j_exact * (1 - j_exact) / S) + 0.03
    assert abs(j_est - j_exact) < tol, f"exact={j_exact:.4f} est={j_est:.4f}"


def test_streaming_long_genome_matches_whole(rng):
    """A genome crossing the max block size must sketch identically when
    streamed (batched-piece + combine_race path) — shrink the block via a
    per-INSTANCE override (the class attr is bound at import, so patching
    the module global would silently leave the whole-genome path active)."""
    seq = random_dna(rng, 40_000)
    sk = make_sketcher(_params(SketchAlgo.OPTDENS))
    sig_whole = sk.sketch_codes(encode_dna(seq))
    sk2 = make_sketcher(_params(SketchAlgo.OPTDENS))
    sk2.MAX_BLOCK_LOG2 = 14  # 16384 < 40k forces streaming
    sig_stream = sk2.sketch_codes(encode_dna(seq))
    np.testing.assert_array_equal(sig_whole, sig_stream)


def test_submit_mixed_lengths_matches_per_genome(rng):
    """sketch_many over a batch mixing short genomes with several LONG
    ones (the cross-genome piece-batching path, _race_stream_seg_fn) must
    equal the one-at-a-time oracle."""
    sk = make_sketcher(_params(SketchAlgo.OPTDENS))
    sk.MAX_BLOCK_LOG2 = 14
    lens = [5_000, 40_000, 33_000, 900, 40_000, 70_001, 16_384]
    genomes = [encode_dna(random_dna(rng, n)) for n in lens]
    got = sk.sketch_many(genomes)
    one = make_sketcher(_params(SketchAlgo.OPTDENS))
    one.MAX_BLOCK_LOG2 = 14
    for row, codes in enumerate(genomes):
        np.testing.assert_array_equal(
            got[row], one.sketch_codes(codes), err_msg=f"genome {row}")


def test_submit_long_multiplicity_sensitive(rng):
    """The k-1-overlap (u8 codes) streaming branch: PROB3A long genomes
    through sketch_many must equal the streaming sketch_codes oracle."""
    sk = make_sketcher(_params(SketchAlgo.PROB3A))
    sk.MAX_BLOCK_LOG2 = 14
    genomes = [encode_dna(random_dna(rng, n)) for n in (40_000, 2_000, 50_000)]
    got = sk.sketch_many(genomes)
    one = make_sketcher(_params(SketchAlgo.PROB3A))
    one.MAX_BLOCK_LOG2 = 14
    for row, codes in enumerate(genomes):
        np.testing.assert_array_equal(
            got[row], one.sketch_codes(codes), err_msg=f"genome {row}")


def test_probminhash_streaming_bias():
    """Streamed (piece-wise) ProbMinHash vs one-block oracle.  A k-mer
    split across pieces races with
    max(per-piece count) instead of the total; J_P's scale invariance
    absorbs uniform duplication, so realistic (low/uniform-duplication)
    genomes must show NO bias, and the adversarial half-duplicated layout
    a bounded one."""
    from gsearch_tpu.core.params import SeqSketcherParams
    from gsearch_tpu.models.probminhash import ProbMinHashSketcher

    S = 2048
    params = SeqSketcherParams(kmer_size=16, sketch_size=S, algo="PROB3A",
                               data_t="DNA")

    class Stream(ProbMinHashSketcher):
        MAX_BLOCK_LOG2 = 16  # 64Kb pieces

    class OneBlock(ProbMinHashSketcher):
        MAX_BLOCK_LOG2 = 18  # whole genome in one block (oracle)

    rng = np.random.default_rng(7)
    # realistic: random genome (3 pieces) -> bit-identical signature
    g = rng.integers(0, 4, size=3 << 16).astype(np.uint8)
    s_str = Stream(params).sketch_codes(g)
    s_one = OneBlock(params).sketch_codes(g)
    assert (s_str == s_one).mean() > 0.995, "streaming must not bias low-dup genomes"

    # uniform duplication (every k-mer x2, copies in different pieces):
    # scale invariance of J_P keeps the signature unchanged
    unit = rng.integers(0, 4, size=1 << 16).astype(np.uint8)
    g2 = np.concatenate([unit, np.full(16, 255, np.uint8), unit])

    class Stream2(ProbMinHashSketcher):
        MAX_BLOCK_LOG2 = 16

    class OneBlock2(ProbMinHashSketcher):
        MAX_BLOCK_LOG2 = 18

    a = Stream2(params).sketch_codes(g2)
    b = OneBlock2(params).sketch_codes(g2)
    assert (a == b).mean() > 0.95, "uniform duplication must cancel (J_P scale invariance)"
