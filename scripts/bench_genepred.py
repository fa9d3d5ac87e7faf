"""Gene-prediction sensitivity/precision benchmark on a realistic genome.

No real assemblies ship in this environment (zero egress), so the genome
is synthesized to the published statistics of E. coli K-12: ~87% of the
reference strain is coding (here a configurable density over both
strands), gene lengths log-normal around ~900 nt, codons drawn from the
REAL K-12 codon-usage table bundled in models/genepred.py
(_ECOLI_USAGE_PER_1000, standard published data), dicodon correlation via
the default chain, and ~50%-GC intergenic spacers.  Matching criterion is
the standard gene-caller one: a predicted gene is a true positive when it
shares the 3' end (stop codon) and strand with a planted gene; 5' match
is scored separately (start-call accuracy is the hard part for all
callers, FragGeneScan included).

Also sweeps (start_codon_bonus, stop_codon_bonus, p_gene_start) around
the defaults to confirm/tune the operating point (r2 verdict item 6).

Usage: python scripts/bench_genepred.py [genome_kb] [coding_density]
Writes GENEPRED_BENCH.json.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import itertools
import json
import time

import numpy as np


def log(m):
    print(f"[genepred-bench {time.strftime('%H:%M:%S')}] {m}",
          file=sys.stderr, flush=True)


BASES = "ACGT"
STOPS = {"TAA", "TAG", "TGA"}


def _codon_str(cid):
    return BASES[(cid >> 4) & 3] + BASES[(cid >> 2) & 3] + BASES[cid & 3]


def sample_gene(rng, usage_p, n_codons):
    """Coding sequence: ATG + usage-sampled non-stop codons + stop."""
    inner = rng.choice(64, size=n_codons - 2, p=usage_p)
    body = "".join(_codon_str(c) for c in inner)
    stop = rng.choice(["TAA", "TAG", "TGA"], p=[0.61, 0.09, 0.30])  # K-12 rates
    return "ATG" + body + stop


def revcomp(s):
    comp = str.maketrans("ACGT", "TGCA")
    return s.translate(comp)[::-1]


def _strip_stops(usage):
    usage = np.array(usage, dtype=np.float64)
    for s in STOPS:  # never sample in-frame stops inside a gene body
        cid = (BASES.index(s[0]) << 4) | (BASES.index(s[1]) << 2) | BASES.index(s[2])
        usage[cid] = 0.0
    return usage / usage.sum()


def k12_usage():
    from gsearch_tpu.models.genepred import default_codon_logusage

    return _strip_stops(np.exp(default_codon_logusage()))


def heldout_usages(rng):
    """Codon-usage tables the DEFAULT model has never seen — the held-out
    organisms of this benchmark (no real assemblies ship in this
    zero-egress environment, so held-out = differently-biased generators,
    not merely a different random seed of the SAME bias):

    * synonymous-shuffled: K-12 probabilities permuted among each amino
      acid's synonymous codons — same protein statistics, destroyed codon
      bias (the exact signal the default tables encode);
    * gc-skewed: every codon reweighted by exp(gc_count) — a GC-rich
      organism analog (~GC3 like Pseudomonas-class genomes)."""
    from gsearch_tpu.models.genepred import _CODON_AA

    k12 = k12_usage()
    fam = {}
    for cid in range(64):
        fam.setdefault(_CODON_AA[_codon_str(cid)], []).append(cid)
    shuffled = np.zeros(64)
    for aa, cids in fam.items():
        if aa == "*":
            continue
        vals = k12[cids]
        shuffled[np.array(cids)] = rng.permutation(vals)
    gc = np.array([sum(b in "GC" for b in _codon_str(c)) for c in range(64)])
    skewed = k12 * np.exp(1.2 * gc)
    return {"heldout_shuffled": _strip_stops(shuffled),
            "heldout_gc_skewed": _strip_stops(skewed)}


def build_genome(rng, genome_kb, coding_density, usage=None):
    usage = k12_usage() if usage is None else usage

    target = genome_kb * 1000
    parts, genes, pos = [], [], 0
    while pos < target:
        # intergenic spacer (uniform random, ~50% GC like K-12)
        ig = int(rng.integers(60, 400) if coding_density < 0.9
                 else rng.integers(20, 120))
        parts.append("".join(rng.choice(list(BASES), ig)))
        pos += ig
        if rng.random() < coding_density + 0.05:
            n_codons = int(np.clip(rng.lognormal(np.log(300), 0.55), 40, 1500))
            g = sample_gene(rng, usage, n_codons)
            strand = "+" if rng.random() < 0.5 else "-"
            placed = g if strand == "+" else revcomp(g)
            genes.append({"start": pos, "end": pos + len(g), "strand": strand})
            parts.append(placed)
            pos += len(g)
    return "".join(parts).encode(), genes


def score(pred, truth):
    """TP by shared (3'-end, strand); 5' accuracy among the TPs."""
    def three_prime(g):
        return (g["end"] if g["strand"] == "+" else g["start"], g["strand"])

    t3 = {three_prime(g): g for g in truth}
    tp, start_ok = 0, 0
    for p in pred:
        key = (p.end if p.strand == "+" else p.start, p.strand)
        g = t3.get(key)
        if g is not None:
            tp += 1
            p5 = p.start if p.strand == "+" else p.end
            g5 = g["start"] if g["strand"] == "+" else g["end"]
            start_ok += int(p5 == g5)
    sens = tp / max(len(truth), 1)
    prec = tp / max(len(pred), 1)
    return {"tp": tp, "n_true": len(truth), "n_pred": len(pred),
            "sensitivity": round(sens, 4), "precision": round(prec, 4),
            "f1": round(2 * sens * prec / max(sens + prec, 1e-9), 4),
            "start_accuracy": round(start_ok / max(tp, 1), 4)}


def main():
    genome_kb = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    density = float(sys.argv[2]) if len(sys.argv) > 2 else 0.7

    from gsearch_tpu.models.genepred import GenePredParams, predict_genes
    from gsearch_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    rng = np.random.default_rng(0xEC011)
    seq, truth = build_genome(rng, genome_kb, density)
    log(f"genome: {len(seq)} nt, {len(truth)} planted genes, "
        f"coding {sum(g['end']-g['start'] for g in truth)/len(seq):.2f}")

    t0 = time.time()
    pred = predict_genes(seq, GenePredParams())
    dt = time.time() - t0
    base = score(pred, truth)
    base["wall_s"] = round(dt, 2)
    base["nt_per_s"] = round(len(seq) / dt)
    log(f"defaults: {base}")
    # warm timing (compiles cached): the throughput a long run sees
    t0 = time.time()
    predict_genes(seq, GenePredParams())
    dtw = time.time() - t0
    base["warm_wall_s"] = round(dtw, 2)
    base["warm_nt_per_s"] = round(len(seq) / dtw)
    log(f"warm: {base['warm_nt_per_s']} nt/s")

    # HELD-OUT evaluation — the HEADLINE metrics (the in-distribution
    # section above shares its generator with the default model's prior,
    # so it upper-bounds nothing; these genomes use usages the model has
    # never seen).  Two rows per suite: the frozen built-in prior, and
    # the shipped organism-adaptive path (`genepred -t self`,
    # self_trained_params) whose quality bars are F1 >= 0.85 and start
    # accuracy >= 0.7 on BOTH suites.
    from gsearch_tpu.models.genepred import self_trained_params

    heldout = {}
    for name, u in heldout_usages(np.random.default_rng(0xBEEF)).items():
        hseq, htruth = build_genome(np.random.default_rng(0xD0C5), genome_kb,
                                    density, usage=u)
        prior_s = score(predict_genes(hseq, GenePredParams()), htruth)
        t0 = time.time()
        ps = self_trained_params(hseq, GenePredParams())
        hs = score(predict_genes(hseq, ps), htruth)
        hs["selftrain_wall_s"] = round(time.time() - t0, 2)
        heldout[name] = {"frozen_prior": prior_s, "self_trained": hs}
        log(f"{name}: prior {prior_s}")
        log(f"{name}: self-trained {hs}")
        assert hs["f1"] >= 0.85, f"{name} f1 {hs['f1']} below bar"
        assert hs["start_accuracy"] >= 0.7, \
            f"{name} start {hs['start_accuracy']} below bar"

    # small sweep around the defaults on the IN-DISTRIBUTION genome only
    # (reported for knob sensitivity; the held-out rows above are the
    # honest generalization estimate)
    sweep = []
    for sb, eb, pg in itertools.product((2.0, 3.0, 4.5), (4.0, 6.0, 9.0),
                                        (1 / 700, 1 / 400, 1 / 250)):
        p = GenePredParams(start_codon_bonus=sb, stop_codon_bonus=eb,
                           p_gene_start=pg)
        s = score(predict_genes(seq, p), truth)
        s.update({"start_codon_bonus": sb, "stop_codon_bonus": eb,
                  "p_gene_start": round(pg, 5)})
        sweep.append(s)
        log(f"sb={sb} eb={eb} pg={pg:.4f}: f1={s['f1']} "
            f"sens={s['sensitivity']} prec={s['precision']}")
    best = max(sweep, key=lambda s: s["f1"])

    # whole-genome sustained throughput (r3 verdict item 4: >= 1e5 nt/s).
    # The quality genome above is deliberately small so the 27-point sweep
    # stays cheap; real FragGeneScanRs-style usage is one multi-Mb genome,
    # where the windowed batched Viterbi amortizes its compiles.  A warm-up
    # call on a slice populates the program cache (the on-disk compilation
    # cache makes even the first run warm), then the full
    # genome is timed cold-start-excluded AND included.
    thrpt_mb = float(os.environ.get("GENEPRED_THROUGHPUT_MB", "2"))
    big_seq, big_truth = build_genome(
        np.random.default_rng(0x5CA1E), int(thrpt_mb * 1000), density)
    t0 = time.time()
    predict_genes(big_seq[: 300_000], GenePredParams())  # warm-up slice
    t_warmup = time.time() - t0
    t0 = time.time()
    big_pred = predict_genes(big_seq, GenePredParams())
    dt_big = time.time() - t0
    thrpt = {"genome_nt": len(big_seq), "wall_s": round(dt_big, 2),
            "nt_per_s": round(len(big_seq) / dt_big),
            "warmup_s": round(t_warmup, 2),
            "nt_per_s_incl_warmup": round(len(big_seq) / (dt_big + t_warmup))}
    thrpt.update(score(big_pred, big_truth))
    log(f"throughput {thrpt_mb} Mb: {thrpt['nt_per_s']} nt/s "
        f"({thrpt['nt_per_s_incl_warmup']} incl. {t_warmup:.0f}s warmup); "
        f"f1={thrpt['f1']}")

    out = {"genome_nt": len(seq), "coding_density_requested": density,
           "heldout": heldout,
           "in_distribution": base, "throughput": thrpt,
           "note": ("HEADLINE = heldout.*.self_trained (usages the model "
                    "never saw, called via the shipped `-t self` "
                    "organism-adaptive path; bars f1>=0.85, start>=0.7 "
                    "asserted).  'in_distribution' evaluates on a genome "
                    "generated from the model's own K-12 prior and is a "
                    "sanity bound only, NOT a generalization claim."),
           "best": best, "sweep": sweep}
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "GENEPRED_BENCH.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(f"defaults f1={base['f1']}; best f1={best['f1']} at "
        f"sb={best['start_codon_bonus']} eb={best['stop_codon_bonus']} "
        f"pg={best['p_gene_start']}")


if __name__ == "__main__":
    main()
