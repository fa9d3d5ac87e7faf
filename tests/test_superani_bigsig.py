"""superani (seed chaining) and bigsig (BIGSI read classification) tests."""

import numpy as np
import pytest

from conftest import mutate_dna, random_dna


def test_seedchain_ani(rng, tmp_path):
    from gsearch_tpu.cli.superani import run_superani

    g0 = random_dna(rng, 60_000)
    g1 = mutate_dna(rng, g0, 0.02)   # ~98% ANI
    g2 = random_dna(rng, 60_000)     # unrelated
    paths = []
    for name, g in (("a", g0), ("b", g1), ("c", g2)):
        p = tmp_path / f"{name}.fna"
        p.write_bytes(b">%s\n" % name.encode() + g + b"\n")
        paths.append(str(p))
    qlist = tmp_path / "q.txt"
    rlist = tmp_path / "r.txt"
    qlist.write_text(f"{paths[1]}\n{paths[2]}\n")
    rlist.write_text(f"{paths[0]}\n")
    out = str(tmp_path / "superani.tsv")
    n = run_superani(str(qlist), str(rlist), kmer=16, c=30, output=out)
    assert n == 2
    rows = {tuple(l.split("\t")[:2]): l.split("\t")[2:] for l in
            open(out).read().strip().splitlines()[1:]}
    ani_rel, afq_rel, afr_rel = map(float, rows[(paths[1], paths[0])])
    ani_unrel = float(rows[(paths[2], paths[0])][0])
    assert 94.0 < ani_rel <= 100.0, f"related ANI {ani_rel}"
    assert afq_rel > 0.5, f"aligned fraction {afq_rel}"
    assert ani_unrel < 80.0, f"unrelated ANI {ani_unrel}"


def test_seedchain_rearrangement(rng, tmp_path):
    """Chaining must tolerate a block swap (two diagonals)."""
    from gsearch_tpu.models.seedchain import SeedChainer
    from gsearch_tpu.io.codec import encode_dna

    g = random_dna(rng, 40_000)
    swapped = g[20_000:] + g[:20_000]
    ch = SeedChainer(k=16, c=30)
    sq = ch.sketch(encode_dna(swapped))
    sr = ch.sketch(encode_dna(g))
    ani, afq, afr = ch.compare(sq, sr)
    assert ani > 97.0, f"rearranged ANI {ani}"
    assert afq > 0.8


def test_bigsi_classify(rng, tmp_path):
    from gsearch_tpu.index.bigsi import BigsiIndex
    from gsearch_tpu.io.codec import encode_dna

    genomes = {f"g{i}": random_dna(rng, 30_000) for i in range(4)}
    idx = BigsiIndex(bloom_len=100_000, nb_hashes=2, kmer_size=21)
    for name, g in genomes.items():
        idx.insert_genome(name, encode_dna(g))
    assert idx.nb_genomes == 4

    # reads from g1 (exact) and g2 (1% mutated), plus junk
    read_len = 256
    reads, expected = [], []
    for i in range(6):
        src = "g1" if i % 2 == 0 else "g2"
        start = rng.integers(0, 30_000 - read_len)
        read = genomes[src][start : start + read_len]
        if src == "g2":
            read = mutate_dna(rng, read, 0.01)
        reads.append(encode_dna(read))
        expected.append(src)
    reads.append(encode_dna(random_dna(rng, read_len)))
    expected.append(None)

    results = idx.classify(np.stack(reads), min_fraction=0.5)
    for hits, exp in zip(results, expected):
        if exp is None:
            assert not hits, f"junk read classified: {hits}"
        else:
            assert hits, f"read from {exp} unclassified"
            assert hits[0][0] == exp, f"expected {exp}, got {hits[0]}"


def test_bigsi_minimizer_mode_and_io(rng, tmp_path):
    from gsearch_tpu.index.bigsi import BigsiIndex
    from gsearch_tpu.io.codec import encode_dna

    g = random_dna(rng, 20_000)
    idx = BigsiIndex(bloom_len=50_000, nb_hashes=2, kmer_size=21, minimizer_window=8)
    idx.insert_genome("g", encode_dna(g))
    prefix = str(tmp_path / "idx")
    idx.save(prefix)
    idx2 = BigsiIndex.load(prefix)
    read = encode_dna(g[1000:1256])
    res = idx2.classify(read[None, :], min_fraction=0.5)
    assert res[0] and res[0][0][0] == "g"


def test_seedchain_mutation_ladder_accuracy(rng):
    """skani-grade claim: chained seed-identity ANI within ~0.5 of the
    planted mutation truth across a ladder."""
    from gsearch_tpu.models.seedchain import SeedChainer
    from gsearch_tpu.io.codec import encode_dna

    g = random_dna(rng, 200_000)
    ch = SeedChainer(k=16, c=30)
    sr = ch.sketch(encode_dna(g))
    for rate in (0.005, 0.01, 0.03, 0.05):
        mut = mutate_dna(rng, g, rate)
        sq = ch.sketch(encode_dna(mut))
        ani, afq, afr = ch.compare(sq, sr)
        # mutate_dna may re-draw the same base (p_change = 3/4 per site)
        true_ani = 100.0 * (1 - rate * 0.75)
        assert abs(ani - true_ani) <= 0.5, (
            f"rate={rate}: ani={ani:.2f} vs true {true_ani:.2f}")
        assert afq > 0.9 and afr > 0.9


def test_seedchain_partial_overlap_af(rng):
    """AF must shrink on partial-overlap genomes: query = half of ref +
    unrelated half -> af_q ~ 0.5, af_r ~ 0.5, ANI still high."""
    from gsearch_tpu.models.seedchain import SeedChainer
    from gsearch_tpu.io.codec import encode_dna

    shared = random_dna(rng, 50_000)
    q = shared + random_dna(rng, 50_000)
    r = shared + random_dna(rng, 50_000)
    ch = SeedChainer(k=16, c=30)
    ani, afq, afr = ch.compare(ch.sketch(encode_dna(q)), ch.sketch(encode_dna(r)))
    assert 0.35 < afq < 0.65, f"af_q {afq}"
    assert 0.35 < afr < 0.65, f"af_r {afr}"
    assert ani > 99.0, f"ani {ani}"


def test_ani_regression_hook(tmp_path):
    from gsearch_tpu.models.seedchain import AniRegression

    # "none" is the explicit identity; load(None) resolves to the bundled
    # fitted model (applied by default, like skani's regression)
    assert AniRegression.load("none").predict(97.0, 0.8) == 97.0
    bundled = AniRegression.load(None)
    # the fitted correction is a debias, not a rescale: within half an
    # ANI point of raw in the calibrated range
    assert abs(bundled.predict(97.0, 0.8) - 97.0) < 0.5
    p = tmp_path / "model.json"
    p.write_text('{"intercept": 1.0, "ani": 0.99, "af": 0.5}')
    m = AniRegression.load(str(p))
    assert abs(m.predict(97.0, 0.8) - (1.0 + 0.99 * 97.0 + 0.4)) < 1e-9


def test_fastq_parse_and_quality_mask(tmp_path):
    from gsearch_tpu.io.fasta import parse_fastq, parse_reads, is_fastq_file

    fq = (b"@r1 desc\nACGTACGT\n+\nIIII!!II\n"
          b"@r2\nTTTTGGGG\n+\nIIIIIIII\n")
    p = tmp_path / "reads.fq"
    p.write_bytes(fq)
    recs = list(parse_fastq(str(p), quality_min=15))
    assert [r.fasta_id for r in recs] == ["r1", "r2"]
    # '!' = phred 0 < 15 -> masked to N
    assert recs[0].seq == b"ACGTNNGT"
    assert recs[1].seq == b"TTTTGGGG"
    # no masking when quality_min=0
    assert list(parse_fastq(str(p)))[0].seq == b"ACGTACGT"
    assert is_fastq_file("x.fastq.gz") and is_fastq_file("x.fq")
    assert not is_fastq_file("x.fna.gz")
    # dispatcher returns fastq records for .fq paths
    assert [r.fasta_id for r in parse_reads(str(p))] == ["r1", "r2"]


def test_bigsi_downsample_and_fp_correct(rng):
    from gsearch_tpu.index.bigsi import BigsiIndex, _binom_sf_log10
    from gsearch_tpu.io.codec import encode_dna

    g = random_dna(rng, 20_000)
    idx = BigsiIndex(bloom_len=60_000, nb_hashes=2, kmer_size=21)
    idx.insert_genome("g", encode_dna(g))
    read = encode_dna(g[500:756])[None, :]
    full = idx.classify(read, min_fraction=0.5)
    half = idx.classify(read, min_fraction=0.5, down_sample=2)
    assert full[0][0][0] == "g" and half[0][0][0] == "g"
    # down-sampling probes ~half the k-mers
    assert abs(half[0][0][2] - full[0][0][2] / 2) <= 1
    # fp test: a perfect hit passes even a strict exponent
    strict = idx.classify(read, min_fraction=0.5, fp_exponent=6.0)
    assert strict[0] and strict[0][0][0] == "g"
    # sanity of the binomial tail: P(X>=large | tiny p) is tiny
    assert _binom_sf_log10(50, 100, 0.01) < -30
    assert _binom_sf_log10(0, 100, 0.5) == 0.0


def test_bigsig_cli_paired_end(rng, tmp_path):
    """identify with two FASTQ files = paired-end; writes _reads.txt and
    the five-field _counts.txt summary."""
    import gzip

    from gsearch_tpu.cli.bigsig import main

    genomes = {f"g{i}": random_dna(rng, 25_000) for i in range(3)}
    refs = tmp_path / "refs"
    refs.mkdir()
    for name, g in genomes.items():
        (refs / f"{name}.fna").write_bytes(b">" + name.encode() + b"\n" + g + b"\n")
    prefix = str(tmp_path / "idx")
    assert main(["construct", "-r", str(refs), "-b", prefix,
                 "--bloom", "200000", "-k", "21"]) == 0

    # paired reads from g1: mates from the two ends of a 600-base fragment
    r1_lines, r2_lines = [], []
    for i in range(8):
        start = int(rng.integers(0, 25_000 - 600))
        frag = genomes["g1"][start : start + 600]
        q = b"I" * 250
        r1_lines.append(b"@p%d\n" % i + frag[:250] + b"\n+\n" + q + b"\n")
        r2_lines.append(b"@p%d\n" % i + frag[-250:] + b"\n+\n" + q + b"\n")
    (tmp_path / "r1.fq.gz").write_bytes(gzip.compress(b"".join(r1_lines)))
    (tmp_path / "r2.fq.gz").write_bytes(gzip.compress(b"".join(r2_lines)))

    out = str(tmp_path / "cls")
    rc = main(["identify", "-b", prefix, "-q",
               str(tmp_path / "r1.fq.gz"), str(tmp_path / "r2.fq.gz"),
               "-o", out, "--read_len", "250", "--min_fraction", "0.5",
               "--fp_correct", "3.0"])
    assert rc == 0
    body = open(out + "_reads.txt").read()
    assert body.count("g1.fna\t") >= 8  # every pair classified to g1
    assert "g2.fna" not in body
    counts = open(out + "_counts.txt").read().splitlines()
    assert counts[0].startswith("genome\treads\t")
    top = counts[1].split("\t")
    assert top[0].endswith("g1.fna") and int(top[1]) == 8
