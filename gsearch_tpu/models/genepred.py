"""Prokaryotic gene prediction — the FragGeneScan role, on the device.

Capability-equivalent of FragGeneScanRs as shipped with the reference
(reference: binaux/src/bin/FragGeneScanRs.rs:26-272 — HMM/Viterbi gene
calls over genomes/reads producing .faa/.ffn/.gff/.out, used to generate
the proteomes that AA mode consumes, README.md:533-560).

Model: an 11-state, 3-periodic codon HMM
    0: noncoding
    1..3: coding forward, codon positions 1..3
    4..6: coding reverse-complement, codon positions 1..3
    7..8: forward insert states (between codon positions 1-2 / 2-3)
    9..10: reverse insert states
with full-codon emissions attached to the third codon position (a 64-entry
log-usage table — in-frame stop codons get a hard floor, which is what
keeps genes open), and position-dependent transition bonuses for start
codons (ATG/GTG/TTG at nc->M1 / reverse stops for the minus strand) and
stop codons (M3->nc).  The reference's trained dicodon tables drop in as a
4096-entry P(codon | previous codon) table (GeneModel below).

Sequencing-error (indel) states — the role of FragGeneScan's I1..I6 match/
insert architecture for error-prone reads (FragGeneScanRs.rs viterbi's
insertion/deletion handling): when `allow_indels` is on, an inserted base
is a detour through an insert state (F1 -> FI1 -> F2, penalized by
log(indel_rate) per inserted base, self-loop for runs), and a deleted base
is a penalized phase-skip transition (F3 -> F2, F1 -> F3, F2 -> F1 skip one
codon position).  The decoded path then drives *read correction* exactly
like the reference tool's: inserted bases are dropped from the reported
CDS and deleted bases come back as `N` (translating to `X`), so the
downstream protein stays in frame across the error.

Device formulation: emissions and bonuses for all positions are precomputed
as vectorized table lookups; the Viterbi recursion is a `lax.scan` over
positions carrying a [batch, 7] DP vector and emitting int8 backpointers;
backtrace is a second reverse `lax.scan`.  Everything is batched over
contigs/reads; no per-position Python.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import get_logger

log = get_logger(__name__)

NSTATE = 11
NC, F1, F2, F3, R1, R2, R3, FI1, FI2, RI1, RI2 = range(11)

# standard bacterial code
_CODON_AA = {}
_BASES = "TCAG"
_AA_TABLE = (
    "FFLLSSSSYY**CC*W"
    "LLLLPPPPHHQQRRRR"
    "IIIMTTTTNNKKSSRR"
    "VVVVAAAADDEEGGGG"
)
for _i, _b1 in enumerate(_BASES):
    for _j, _b2 in enumerate(_BASES):
        for _k, _b3 in enumerate(_BASES):
            _CODON_AA[_b1 + _b2 + _b3] = _AA_TABLE[16 * _i + 4 * _j + _k]

_STOPS = ("TAA", "TAG", "TGA")
_STARTS = ("ATG", "GTG", "TTG")

# codes are A=0 C=1 G=2 T=3 (io/codec.py); codon id = b0*16 + b1*4 + b2
_CODE_BASE = "ACGT"


def _codon_id(codon: str) -> int:
    return (
        _CODE_BASE.index(codon[0]) * 16
        + _CODE_BASE.index(codon[1]) * 4
        + _CODE_BASE.index(codon[2])
    )


# E. coli K-12 codon usage (occurrences per 1000 codons, standard published
# table) — the built-in prior when no trained model is supplied.  The
# reference tool never runs untrained either: it ships CG-binned tables
# (FragGeneScanRs.rs:116-119); these are the 50%-CG-bin analog.
_ECOLI_USAGE_PER_1000 = {
    "TTT": 22.2, "TTC": 16.6, "TTA": 13.9, "TTG": 13.7, "CTT": 11.0,
    "CTC": 11.0, "CTA": 3.9, "CTG": 52.6, "ATT": 30.3, "ATC": 25.1,
    "ATA": 4.4, "ATG": 27.9, "GTT": 18.3, "GTC": 15.3, "GTA": 10.9,
    "GTG": 26.4, "TCT": 8.5, "TCC": 8.6, "TCA": 7.2, "TCG": 8.9,
    "CCT": 7.0, "CCC": 5.5, "CCA": 8.4, "CCG": 23.2, "ACT": 9.0,
    "ACC": 23.4, "ACA": 7.1, "ACG": 14.4, "GCT": 15.3, "GCC": 25.5,
    "GCA": 20.1, "GCG": 33.6, "TAT": 16.2, "TAC": 12.2, "TAA": 2.0,
    "TAG": 0.2, "CAT": 12.9, "CAC": 9.7, "CAA": 15.3, "CAG": 28.8,
    "AAT": 17.7, "AAC": 21.7, "AAA": 33.6, "AAG": 10.3, "GAT": 32.1,
    "GAC": 19.1, "GAA": 39.4, "GAG": 17.8, "TGT": 5.2, "TGC": 6.4,
    "TGA": 0.9, "TGG": 15.2, "CGT": 20.9, "CGC": 22.0, "CGA": 3.6,
    "CGG": 5.4, "AGT": 8.8, "AGC": 16.1, "AGA": 2.1, "AGG": 1.2,
    "GGT": 24.7, "GGC": 29.6, "GGA": 8.0, "GGG": 11.1,
}


def synonymous_smooth(p: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Blend codon probabilities toward each amino acid's synonymous
    marginal (last axis).

    The coding signal has three parts: in-frame-stop avoidance, amino-acid
    composition, and organism-specific codon bias.  An unsmoothed table
    stakes everything on the third: on a genome whose synonymous bias
    differs from the table's, per-codon log-odds go NEGATIVE even inside
    real genes (measured: a synonymous-permuted control dropped
    sensitivity to 0.12, scripts/bench_genepred.py heldout section).
    Blending half the mass to the AA marginal keeps the first two signals
    organism-independent while retaining half the bias signal
    in-distribution."""
    out = np.asarray(p, np.float64)
    sm = out.copy()
    for aa, ids in _AA_FAMILIES.items():
        if aa == "*":
            continue
        sm[..., ids] = out[..., ids].sum(axis=-1, keepdims=True) / len(ids)
    res = (1.0 - alpha) * out + alpha * sm
    return res / res.sum(axis=-1, keepdims=True)


_AA_FAMILIES: dict = {}
for _codon, _aa in _CODON_AA.items():
    _AA_FAMILIES.setdefault(_aa, []).append(_codon_id(_codon))


def default_codon_logusage() -> np.ndarray:
    """Built-in 64-entry codon log-usage: E. coli K-12 bias, synonymous-
    smoothed (see synonymous_smooth), with in-frame stops floored.
    Replaceable via GenePredParams / GeneModel."""
    usage = np.full(64, 1e-7, dtype=np.float64)
    for codon, per1000 in _ECOLI_USAGE_PER_1000.items():
        usage[_codon_id(codon)] = max(per1000, 1e-4)
    usage = synonymous_smooth(usage / usage.sum())
    for s in _STOPS:
        usage[_codon_id(s)] = 1e-4  # in-frame stop: hard floor keeps ORFs open
    usage /= usage.sum()
    return np.log(usage).astype(np.float32)


def _floor_stops(p: np.ndarray, floor: float = 1e-4) -> np.ndarray:
    """Pin in-frame stop codons to a small FIXED probability (last axis).

    Training drives stop counts to ~0; the raw log would make emitting a
    gene's own terminal stop so expensive that Viterbi refuses to open the
    gene at all.  A fixed floor keeps the stop penalty comparable to the
    explicit stop-transition bonus instead of dominating it."""
    out = np.array(p, dtype=np.float64)
    idx = [_codon_id(s) for s in _STOPS]
    out[..., idx] = floor
    return out / out.sum(axis=-1, keepdims=True)


class GeneModel:
    """CG-content-binned emission tables — the role of FragGeneScan's
    trained models (the reference loads per-CG-content train files and
    picks tables by each record's CG content,
    binaux/src/bin/FragGeneScanRs.rs:116-119,225-243).

    Required: cg_bins [B] (percent), codon_logusage [B, 64].
    Optional (all per CG bin):
      dicodon_logusage [B, 64, 64]  log P(codon | previous codon)
      noncoding_lm     [B, 4, 4]    log P(base | previous base), noncoding
      start_ctx / stop_ctx / rstart_ctx / rstop_ctx [B, 61, 64]
          flanking-context trinucleotide LOG-ODDS (vs uniform 1/64) in a
          +-30 nt window around forward starts / forward stops / reverse-
          gene close (minus start) / reverse-gene open (minus stop) — the
          role of the original tool's tr_S / tr_E / tr_S_1 / tr_E_1
      dists            [B, 4, 6]    the `pwm` score-distribution params
          (stored for fidelity; scoring here adds the log-odds sums
          directly as Viterbi transition bonuses)."""

    _OPT = ("dicodon_logusage", "rdicodon_logusage", "noncoding_lm",
            "start_ctx", "stop_ctx", "rstart_ctx", "rstop_ctx", "dists",
            "ctx_aff")

    def __init__(self, cg_bins, codon_logusage, dicodon_logusage=None,
                 rdicodon_logusage=None, noncoding_lm=None, start_ctx=None,
                 stop_ctx=None, rstart_ctx=None, rstop_ctx=None, dists=None,
                 ctx_aff=None):
        self.cg_bins = np.asarray(cg_bins, dtype=np.float32)
        self.codon_logusage = np.asarray(codon_logusage, dtype=np.float32)
        loc = locals()
        for name in self._OPT:
            v = loc[name]
            setattr(self, name,
                    None if v is None else np.asarray(v, dtype=np.float32))

    def bin_for(self, cg_percent: float) -> int:
        return int(np.argmin(np.abs(self.cg_bins - cg_percent)))

    def tables_for(self, cg_percent: float):
        b = self.bin_for(cg_percent)
        di = None if self.dicodon_logusage is None else self.dicodon_logusage[b]
        rdi = (None if self.rdicodon_logusage is None
               else self.rdicodon_logusage[b])
        return self.codon_logusage[b], di, rdi

    def ctx_for(self, cg_percent: float):
        """(noncoding_lm, ctx[4, 61, 64], ctx_aff[4, 2]) for the bin,
        entries None when untrained.  ctx order: start, stop, rstop (rev
        open), rstart (rev close) — the order _precompute_scores
        consumes."""
        b = self.bin_for(cg_percent)
        nc = None if self.noncoding_lm is None else self.noncoding_lm[b]
        if any(getattr(self, t) is None
               for t in ("start_ctx", "stop_ctx", "rstart_ctx", "rstop_ctx")):
            return nc, None, None
        ctx = np.stack([self.start_ctx[b], self.stop_ctx[b],
                        self.rstop_ctx[b], self.rstart_ctx[b]])
        aff = None if self.ctx_aff is None else self.ctx_aff[b]
        return nc, ctx, aff

    def save(self, path: str) -> None:
        arrs = {"cg_bins": self.cg_bins, "codon_logusage": self.codon_logusage}
        for name in self._OPT:
            v = getattr(self, name)
            if v is not None:
                arrs[name] = v
        np.savez(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "GeneModel":
        g = np.load(path)
        kw = {name: g[name] for name in cls._OPT if name in g}
        return cls(g["cg_bins"], g["codon_logusage"], **kw)

    @classmethod
    def train_from_cds(cls, cds_list, nb_bins: int = 9,
                       cg_lo: float = 30.0, cg_hi: float = 70.0) -> "GeneModel":
        """Estimate CG-binned codon + dicodon tables from in-frame coding
        sequences (the self-training analog of FragGeneScan's offline
        training pipeline).  Each CDS contributes to its own CG bin;
        add-one smoothing; empty bins inherit the global tables."""
        bins = np.linspace(cg_lo, cg_hi, nb_bins)
        cnt = np.ones((nb_bins, 64), dtype=np.float64)
        dcnt = np.zeros((nb_bins, 64, 64), dtype=np.float64)
        gcnt = np.ones(64, dtype=np.float64)
        gdcnt = np.zeros((64, 64), dtype=np.float64)
        touched = np.zeros(nb_bins, dtype=bool)
        for cds in cds_list:
            seq = cds.decode() if isinstance(cds, (bytes, bytearray)) else cds
            seq = seq.upper()
            if len(seq) < 6:
                continue
            cg = 100.0 * sum(c in "GC" for c in seq) / len(seq)
            b = int(np.argmin(np.abs(bins - cg)))
            touched[b] = True
            prev = None
            for i in range(0, len(seq) - 2, 3):
                tri = seq[i:i + 3]
                if any(c not in _CODE_BASE for c in tri):
                    prev = None
                    continue
                cid = _codon_id(tri)
                cnt[b, cid] += 1
                gcnt[cid] += 1
                if prev is not None:
                    dcnt[b, prev, cid] += 1
                    gdcnt[prev, cid] += 1
                prev = cid
        for b in range(nb_bins):
            if not touched[b]:
                cnt[b] = gcnt
                dcnt[b] = gdcnt
        codon_p = _floor_stops(cnt / cnt.sum(axis=1, keepdims=True))
        # smooth dicodon rows toward the bin's MARGINAL usage (not uniform):
        # unseen prev-codon rows then score like the codon table instead of
        # flat 1/64, so sparse training never scores worse than marginal
        alpha = 8.0
        dcnt = dcnt + alpha * codon_p[:, None, :]
        dicodon_p = _floor_stops(dcnt / dcnt.sum(axis=2, keepdims=True))
        return cls(bins, np.log(codon_p).astype(np.float32),
                   np.log(dicodon_p).astype(np.float32))

    @classmethod
    def from_fgs_gene_file(cls, path: str) -> "GeneModel":
        """Best-effort loader for FragGeneScan-format `gene` train files
        (sections: one CG-percent header line, then 6 codon-period blocks
        of 16 lines x 4 transition probabilities P(base | 2 prev bases);
        reference consumption site: FragGeneScanRs.rs:116-119).  The
        second codon's three periods convert to P(codon2 | codon1):
        P(u|yz) P(v|zu) P(w|uv) for c1=xyz, c2=uvw."""
        sections = []
        cur_cg, rows = None, []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) == 1:
                    if cur_cg is not None and len(rows) >= 96:
                        sections.append((cur_cg, rows[:96]))
                    cur_cg, rows = float(parts[0]), []
                else:
                    rows.append([float(x) for x in parts[:4]])
        if cur_cg is not None and len(rows) >= 96:
            sections.append((cur_cg, rows[:96]))
        if not sections:
            raise ValueError(f"no CG sections parsed from {path}")
        cg_bins, codons, dicodons = [], [], []
        floor = 1e-9
        for cg, rows in sections:
            e = np.asarray(rows, dtype=np.float64).reshape(6, 16, 4)
            e = np.maximum(e, floor)
            di = np.zeros((64, 64), dtype=np.float64)
            for c1 in range(64):
                y, z = (c1 >> 2) & 3, c1 & 3
                for c2 in range(64):
                    u, v, w = (c2 >> 4) & 3, (c2 >> 2) & 3, c2 & 3
                    di[c1, c2] = (e[3, y * 4 + z, u] * e[4, z * 4 + u, v]
                                  * e[5, u * 4 + v, w])
            di = _floor_stops(di / di.sum(axis=1, keepdims=True))
            cg_bins.append(cg)
            dicodons.append(np.log(di))
            # marginal codon table from the stationary dicodon chain
            marg = di.mean(axis=0)
            codons.append(np.log(_floor_stops(marg / marg.sum())))
        return cls(np.asarray(cg_bins), np.asarray(codons, dtype=np.float32),
                   np.asarray(dicodons, dtype=np.float32))

    @staticmethod
    def _read_cg_sections(path: str, rows: int, width: int):
        """FragGeneScan CG-binned table file: repeated blocks of one
        header line (the block's CG percent, a single number) followed by
        `rows` lines of `width` probabilities.  Returns (cg[B],
        table[B, rows, width])."""
        cgs, tabs, cur, rws = [], [], None, []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) == 1 and len(rws) in (0, rows):
                    if cur is not None:
                        if len(rws) != rows:
                            raise ValueError(
                                f"{path}: CG block {cur} has {len(rws)} rows,"
                                f" expected {rows}")
                        cgs.append(cur)
                        tabs.append(rws)
                    cur, rws = float(parts[0]), []
                else:
                    vals = [float(x) for x in parts]
                    if len(vals) != width:
                        raise ValueError(
                            f"{path}: row width {len(vals)} != {width}")
                    rws.append(vals)
        if cur is not None:
            if len(rws) != rows:
                raise ValueError(f"{path}: trailing CG block {cur} has "
                                 f"{len(rws)} rows, expected {rows}")
            cgs.append(cur)
            tabs.append(rws)
        if not cgs:
            raise ValueError(f"no CG blocks parsed from {path}")
        return np.asarray(cgs), np.asarray(tabs, dtype=np.float64)

    @staticmethod
    def _em_to_dicodon(e: np.ndarray) -> np.ndarray:
        """e_M[6][16][4] (P(base | previous 2 bases), 6-periodic over a
        dicodon cycle) -> log P(codon2 | codon1).  Both codon-offset
        readings of the cycle estimate the same conditional; their
        log-average halves estimation noise."""
        e = np.maximum(e, 1e-9)
        di = np.zeros((64, 64), dtype=np.float64)
        for c1 in range(64):
            y, z = (c1 >> 2) & 3, c1 & 3
            for c2 in range(64):
                u, v, w = (c2 >> 4) & 3, (c2 >> 2) & 3, c2 & 3
                a = e[3, y * 4 + z, u] * e[4, z * 4 + u, v] * e[5, u * 4 + v, w]
                b = e[0, y * 4 + z, u] * e[1, z * 4 + u, v] * e[2, u * 4 + v, w]
                di[c1, c2] = np.sqrt(a * b)
        di = _floor_stops(di / di.sum(axis=1, keepdims=True))
        return np.log(di)

    @classmethod
    def from_fgs_train_dir(cls, train_dir: str, name: str = "complete",
                           ctx_clip: float = 4.0) -> "GeneModel":
        """Load a FragGeneScan train DIRECTORY (the form the reference
        consumes: -r dir -t name, binaux/src/bin/FragGeneScanRs.rs:116-119
        `hmm::get_train_from_file(train-file-dir, train-file)`).

        File shapes follow the original tool's public TRAIN struct (one
        CG-percent block per bin in every file):
          gene       96 x 4   e_M[6][16][4]   coding P(base | prev 2), fwd
          rgene      96 x 4   e_M1[6][16][4]  same, reverse strand
          noncoding   4 x 4   tr_R_R[4][4]    noncoding P(base | prev)
          start      61 x 64  tr_S            fwd-start +-30 nt context
          stop       61 x 64  tr_E            fwd-stop context
          start1     61 x 64  tr_S_1          rev-gene close (minus start)
          stop1      61 x 64  tr_E_1          rev-gene open (minus stop)
          pwm         4 x 6   dist_S/E/S1/E1  score-distribution params
        The per-error-model file `name` (complete / 454_10 / ...) holds
        keyed global transition lines; its indel rates are exposed via
        `read_fgs_transitions`.  Context probabilities convert to
        log-odds vs uniform, clipped to +-ctx_clip."""
        j = lambda f: os.path.join(train_dir, f)
        cg, e_m = cls._read_cg_sections(j("gene"), 96, 4)
        _, _e_m1 = cls._read_cg_sections(j("rgene"), 96, 4)
        _, r_r = cls._read_cg_sections(j("noncoding"), 4, 4)
        _, tr_s = cls._read_cg_sections(j("start"), 61, 64)
        _, tr_e = cls._read_cg_sections(j("stop"), 61, 64)
        _, tr_s1 = cls._read_cg_sections(j("start1"), 61, 64)
        _, tr_e1 = cls._read_cg_sections(j("stop1"), 61, 64)
        dists = None
        if os.path.exists(j("pwm")):
            _, dists = cls._read_cg_sections(j("pwm"), 4, 6)
        nb = len(cg)
        codons = np.zeros((nb, 64), np.float32)
        dicodons = np.zeros((nb, 64, 64), np.float32)
        rdicodons = np.zeros((nb, 64, 64), np.float32)
        for b in range(nb):
            di = cls._em_to_dicodon(e_m[b].reshape(6, 16, 4))
            dicodons[b] = di
            # rgene/e_M1: reverse-strand emissions, trained over PLUS-strand
            # bases with the same 6-periodicity, so the codon-granular form
            # indexes plus-coordinate codon pairs (see _precompute_scores)
            rdicodons[b] = cls._em_to_dicodon(_e_m1[b].reshape(6, 16, 4))
            marg = np.exp(di).mean(axis=0)
            codons[b] = np.log(_floor_stops(marg / marg.sum()))

        def lo(tab):
            """[B, 61, 64] probabilities -> log-odds vs uniform, centered
            per offset (a uniform-random window sums to 0) and clipped."""
            p = np.maximum(tab, 1e-9)
            p = p / p.sum(axis=2, keepdims=True)
            v = np.log(p * 64.0)
            v -= v.mean(axis=2, keepdims=True)
            return np.clip(v, -ctx_clip, 1.5 * ctx_clip)

        nc = np.log(np.maximum(
            r_r / np.maximum(r_r.sum(axis=2, keepdims=True), 1e-12), 1e-6))
        ctx_aff = None
        if dists is not None:
            # dists rows per bin: dist_S, dist_E, dist_S_1, dist_E_1 as
            # (sigma_T, mu_T, w_T, sigma_F, mu_F, w_F); map to the ctx
            # table order (start, stop, rev-open=E_1, rev-close=S_1) and
            # collapse to the equal-variance affine log-posterior-odds
            # (see train_tables_from_calls)
            ctx_aff = np.zeros((nb, 4, 2), np.float32)
            for b in range(nb):
                for t, row in enumerate((0, 1, 3, 2)):
                    sT, mT, _, sF, mF, _ = dists[b, row]
                    var = 0.5 * (sT * sT + sF * sF) + 1e-6
                    scale = (mT - mF) / var
                    if scale <= 0:
                        ctx_aff[b, t] = (1.0, 0.0)
                    else:
                        ctx_aff[b, t] = (scale, -scale * 0.5 * (mT + mF))
        return cls(cg, codons, dicodons, rdicodon_logusage=rdicodons,
                   noncoding_lm=nc,
                   start_ctx=lo(tr_s), stop_ctx=lo(tr_e),
                   rstart_ctx=lo(tr_s1), rstop_ctx=lo(tr_e1), dists=dists,
                   ctx_aff=ctx_aff)


def read_fgs_transitions(path: str) -> dict:
    """Keyed global-transition lines of a FragGeneScan per-error-model
    train file (complete / 454_10 / ...): section headers (a line with one
    non-numeric token, e.g. `Transition`) followed by `KEY value` lines.
    Returns {section: {key: value}}; the II/IM/DD/DM keys under the
    insertion/deletion sections carry the indel rates GenePredParams
    consumes (indel_rate)."""
    out: dict = {}
    section = "Transition"
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if len(parts) == 1:
                section = parts[0]
                out.setdefault(section, {})
            elif len(parts) == 2:
                try:
                    out.setdefault(section, {})[parts[0]] = float(parts[1])
                except ValueError:
                    section = parts[0]  # two-word section header
            # other line shapes: ignore (robust to format extensions)
    return out


@dataclasses.dataclass
class GenePredParams:
    codon_logusage: np.ndarray = dataclasses.field(default_factory=default_codon_logusage)
    dicodon_logusage: np.ndarray | None = None  # [64, 64] log P(codon|prev)
    #: [64, 64] separately trained REVERSE-strand dicodon table in plus
    #: coordinates (FragGeneScan's e_M1 role); None: score minus genes by
    #: reading the forward table through revcomp codons
    rdicodon_logusage: np.ndarray | None = None
    model: "GeneModel | None" = None      # CG-binned tables; overrides the two above
    #: [4, 4] log P(base | prev base) noncoding emissions (None: flat 1/4)
    noncoding_lm: np.ndarray | None = None
    #: [4, 61, 64] flanking-context log-odds stacked (start, stop,
    #: rev-open, rev-close); replaces the fixed start/stop bonuses at
    #: positions whose boundary codon matches (see _precompute_scores)
    ctx: np.ndarray | None = None
    #: [4, 2] per-table (scale, offset) calibration of the window sum
    #: into log-posterior-odds (the `pwm` dists role); None = identity
    ctx_aff: np.ndarray | None = None
    ctx_weight: float = 1.0               # scale on context log-odds sums
    #: clip on POSITIVE context evidence.  Must stay below the cost of a
    #: spurious close+reopen (stop-miss 9 + open transition ~6), or a
    #: mid-gene false start with an inflated calibrated context makes
    #: splitting a real gene profitable (observed at cap 18: 28/155
    #: starts late by a median 350 nt on the weak-bias suite)
    ctx_cap: float = 8.0
    #: clip on NEGATIVE context evidence.  Calibration is trained on the
    #: FOUND genes of the previous round (survivor bias inflates the
    #: true-class mean), so an unbounded negative branch turns weak true
    #: boundaries into -ctx_cap and self-training can never recover them
    ctx_neg_cap: float = 6.0
    #: [64] log-prior over START codon identity (centered; non-start
    #: entries ignored — the hit masks already gate on ATG/GTG/TTG).
    #: Trained from the observed start-codon usage of the previous
    #: round's calls; discriminates true ATG starts from in-frame
    #: GTG/TTG candidates both in the Viterbi and in the 5' trim
    start_prior: np.ndarray | None = None
    p_gene_start: float = 1.0 / 400.0     # nc -> gene rate per strand
    start_codon_bonus: float = 3.0        # extra for ATG/GTG/TTG at gene start
    #: extra for a proper stop at gene end; None resolves by mode in
    #: __post_init__.  Whole-genome calling: 9.0, tuned on the realistic
    #: planted-genome benchmark (scripts/bench_genepred.py: 6.0 left sensitivity at 0.53; 9.0 reaches sens 1.0 / prec 0.97+
    #: across the start-bonus / p_gene_start grid).  Read mode with indel
    #: states: 6.0 — a larger stop bonus makes "stop at the frameshift +
    #: restart" outscore the insert-state detour, truncating exactly the
    #: genes the error model exists to rescue.
    stop_codon_bonus: float | None = None
    min_gene_len: int = 90                # nt, reference default ORF floor
    whole_genes_only: bool = True         # -w 1 equivalent
    #: enable the sequencing-error states (FragGeneScan's short-read error
    #: model); typically paired with whole_genes_only=False for raw reads
    allow_indels: bool = False
    #: per-base insertion/deletion rate when allow_indels (FGS train files
    #: ship ~1e-2 for 454 reads, ~1e-4 for complete genomes)
    indel_rate: float = 1e-2

    @property
    def stop_bonus(self) -> float:
        """Mode-resolved stop bonus (None default -> 9.0 whole-genome,
        6.0 with the indel/read error model); resolved at use time because
        callers toggle allow_indels after construction."""
        if self.stop_codon_bonus is not None:
            return self.stop_codon_bonus
        return 6.0 if self.allow_indels else 9.0


@dataclasses.dataclass
class Gene:
    start: int      # 0-based, inclusive
    end: int        # exclusive
    strand: str     # '+' or '-'
    nt: str
    aa: str


def _precompute_scores(codes: jnp.ndarray, codon_lu, dicodon_lu,
                       start_codon_bonus, stop_codon_bonus,
                       nc_lm=None, ctx=None, ctx_aff=None,
                       ctx_weight=1.0, ctx_cap=18.0, ctx_neg_cap=6.0,
                       start_prior=None, rdicodon_lu=None):
    """codes [B, L] -> per-position emissions [B, L, NSTATE] and bonuses.

    Traceable: called under jit with the bonus strengths as traced scalars
    (parameter sweeps and trained models then share one compiled program).

    nc_lm [4, 4]: trained noncoding P(base | prev base) emissions (the
    original tool's tr_R_R role); None falls back to flat 1/4.
    ctx [4, 61, 64]: flanking-context log-odds (start, stop, rev-open,
    rev-close — the tr_S/tr_E/tr_E_1/tr_S_1 role).  When given, boundary
    positions whose codon matches score the +-30 nt window via ONE MXU
    conv over the one-hot trinucleotide stream instead of the fixed
    +-bonus; non-matching positions keep the fixed penalty."""
    b, l = codes.shape
    c = jnp.where(codes < 4, codes, 0).astype(jnp.int32)
    invalid = codes >= 4
    # codon ending at position i (needs i >= 2)
    c1 = jnp.roll(c, 2, axis=1)
    c2 = jnp.roll(c, 1, axis=1)
    codon = c1 * 16 + c2 * 4 + c  # [B, L]
    # jnp.roll wraps around: the first two positions have no complete codon
    # and the wrap would fabricate one from the sequence tail
    pos = jnp.arange(l)[None, :]
    codon_bad = (
        invalid | jnp.roll(invalid, 1, axis=1) | jnp.roll(invalid, 2, axis=1) | (pos < 2)
    )
    # reverse-strand codon ending at i (gene on minus strand read right-to-left):
    # minus-strand codon occupying (i-2, i-1, i) is revcomp(c[i-2..i])
    rc = 3 - c
    rcodon = rc * 16 + (3 - c2) * 4 + (3 - c1)

    usage = jnp.asarray(codon_lu)
    neg_big = jnp.float32(-1e9)

    # emissions: nc pays log(1/4) per base; coding pays the full codon
    # log-score at the third codon position (M1/M2 emit 0), so one codon of
    # coding ~ log P(codon) competes with 3*log(1/4) of noncoding.  With a
    # dicodon table the score is P(codon | previous codon) — FragGeneScan's
    # trained-emission family (base probabilities conditioned on the two
    # preceding bases across the dicodon cycle) at codon granularity.
    m3 = jnp.take(usage, codon)
    r3 = jnp.take(usage, rcodon)
    if dicodon_lu is not None:
        di = jnp.asarray(dicodon_lu)  # [64, 64]
        # forward: previous codon in reading order ends at i-3
        prev = jnp.roll(codon, 3, axis=1)
        prev_bad = jnp.roll(codon_bad, 3, axis=1) | (pos < 5)
        m3 = jnp.where(prev_bad, m3, di[prev.reshape(-1), codon.reshape(-1)]
                       .reshape(b, l))
        if rdicodon_lu is not None:
            # separately trained reverse table (e_M1): 6-periodic over
            # PLUS-strand positions, so its codon-granular form scores
            # plus-coordinate codon pairs exactly like the forward chain
            rdi = jnp.asarray(rdicodon_lu)
            r3 = jnp.where(prev_bad,
                           r3, rdi[prev.reshape(-1), codon.reshape(-1)]
                           .reshape(b, l))
        else:
            # reverse: minus-strand genes read right-to-left, so the codon
            # read before the one ending at i is the rcodon ending at i+3
            rprev = jnp.roll(rcodon, -3, axis=1)
            rprev_bad = jnp.roll(codon_bad, -3, axis=1) | (pos >= l - 3)
            r3 = jnp.where(rprev_bad, r3,
                           di[rprev.reshape(-1), rcodon.reshape(-1)]
                           .reshape(b, l))
    e = jnp.zeros((b, l, NSTATE), dtype=jnp.float32)
    log_quarter = jnp.where(invalid, neg_big, jnp.float32(np.log(0.25)))
    if nc_lm is not None:
        # trained noncoding first-order Markov emissions (tr_R_R role)
        prev_ok = ~jnp.roll(invalid, 1, axis=1) & (pos >= 1)
        nc_e = jnp.asarray(nc_lm)[jnp.roll(c, 1, axis=1), c]
        log_nc = jnp.where(invalid, neg_big,
                           jnp.where(prev_ok, nc_e, jnp.float32(np.log(0.25))))
    else:
        log_nc = log_quarter
    e = e.at[:, :, NC].set(log_nc)
    zero_or_inval = jnp.where(invalid, neg_big, jnp.float32(0.0))
    for st in (F1, F2, R1, R2):
        e = e.at[:, :, st].set(zero_or_inval)
    e = e.at[:, :, F3].set(jnp.where(codon_bad, neg_big, m3))
    e = e.at[:, :, R3].set(jnp.where(codon_bad, neg_big, r3))
    # insert states emit a flat base like noncoding; the error cost itself
    # is the log(indel_rate) transition into them
    for st in (FI1, FI2, RI1, RI2):
        e = e.at[:, :, st].set(log_quarter)

    start_ids = jnp.asarray([_codon_id(s) for s in _STARTS])
    stop_ids = jnp.asarray([_codon_id(s) for s in _STOPS])

    def bonus(is_hit, strength):
        strength = jnp.asarray(strength, jnp.float32)
        return jnp.where(is_hit, strength, -strength)

    # forward-looking windows: the last two positions have no complete
    # forward codon (roll wraps to the sequence head)
    fwd_bad = (
        invalid
        | jnp.roll(invalid, -1, axis=1)
        | jnp.roll(invalid, -2, axis=1)
        | (pos >= l - 2)
    )
    # + strand: gene opens at i with a start codon STARTING at i
    cod_start = c * 16 + jnp.roll(c, -1, axis=1) * 4 + jnp.roll(c, -2, axis=1)
    start_hit = (cod_start[..., None] == start_ids[None, None, :]).any(-1) & ~fwd_bad
    # + strand: gene closes entering NC at i; its stop codon ENDS at i-1
    is_stop_end = (codon[..., None] == stop_ids[None, None, :]).any(-1)
    stop_hit = jnp.roll(is_stop_end, 1, axis=1)
    # - strand: gene opens (leftmost + position i) with the minus-strand
    # STOP codon occupying (i, i+1, i+2): read 5'->3' on minus it is
    # revcomp(c[i+2], c[i+1], c[i])
    rcod_start = (
        (3 - jnp.roll(c, -2, axis=1)) * 16 + (3 - jnp.roll(c, -1, axis=1)) * 4 + (3 - c)
    )
    rev_begin_hit = (rcod_start[..., None] == stop_ids[None, None, :]).any(-1) & ~fwd_bad
    # - strand: gene closes entering NC at i; its minus START codon is the
    # rcodon ENDING at i-1
    ris_start_end = (rcodon[..., None] == start_ids[None, None, :]).any(-1)
    rev_end_hit = jnp.roll(ris_start_end, 1, axis=1)

    # start-codon identity prior at hit positions (fwd: start codon
    # starting at i; rev: minus start = rcodon ending at i-1)
    if start_prior is not None:
        pri = jnp.asarray(start_prior)
        pri_f = jnp.where(start_hit, pri[cod_start], 0.0)
        pri_r = jnp.where(rev_end_hit, jnp.roll(pri[rcodon], 1, axis=1), 0.0)
    else:
        pri_f = pri_r = jnp.float32(0.0)

    if ctx is None:
        start_bonus = bonus(start_hit, start_codon_bonus) + pri_f
        stop_bonus = bonus(stop_hit, stop_codon_bonus)
        rev_begin_bonus = bonus(rev_begin_hit, stop_codon_bonus)
        rev_end_bonus = bonus(rev_end_hit, start_codon_bonus) + pri_r
        return e, start_bonus, stop_bonus, rev_begin_bonus, rev_end_bonus

    # flanking-context scores for ALL positions and all four boundary
    # kinds in one conv: score[b, t, i] = sum_j ctx[t, j, tri[i-30+j]]
    # over valid trinucleotides — a 61-tap, 64-feature 1-D correlation of
    # the one-hot trinucleotide stream, which XLA lowers onto the matrix
    # units.  HIGHEST: a GPU would otherwise run it in TF32 (~3 digits),
    # while the scores are compared against CPU-computed f32 oracles
    oh = jax.nn.one_hot(cod_start, 64, dtype=jnp.float32)
    oh = oh * (~fwd_bad).astype(jnp.float32)[..., None]
    sc = jax.lax.conv_general_dilated(
        jnp.moveaxis(oh, 2, 1),                    # [B, 64, L]
        jnp.moveaxis(jnp.asarray(ctx), 2, 1),      # [4, 64, 61]
        (1,), [(30, 30)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST)      # [B, 4, L]
    if ctx_aff is not None:
        # per-table affine calibration of the window sum into bounded
        # log-posterior-odds (trained from true-vs-random score
        # distributions — the `pwm` dists role; see
        # train_tables_from_calls)
        aff = jnp.asarray(ctx_aff)                 # [4, 2]
        sc = sc * aff[None, :, 0, None] + aff[None, :, 1, None]
    sc = jnp.clip(jnp.float32(ctx_weight) * sc,
                  -jnp.float32(ctx_neg_cap), jnp.float32(ctx_cap))

    def ctx_bonus(is_hit, score, strength):
        # the context score MODIFIES the fixed boundary bonus rather than
        # replacing it: the fixed part keeps a true boundary with an
        # uninformative context strictly preferable to no boundary codon
        # at all (replacing it made Viterbi close genes early to dodge
        # the floored stop emission whenever the local context was weak)
        strength = jnp.asarray(strength, jnp.float32)
        return jnp.where(is_hit, strength + score, -strength)

    # stop/rev-close bonuses apply at the transition position i but their
    # boundary codon STARTS at i-3 — shift the centered scores forward
    start_bonus = ctx_bonus(start_hit, sc[:, 0], start_codon_bonus) + pri_f
    stop_bonus = ctx_bonus(stop_hit, jnp.roll(sc[:, 1], 3, axis=1),
                           stop_codon_bonus)
    rev_begin_bonus = ctx_bonus(rev_begin_hit, sc[:, 2], stop_codon_bonus)
    rev_end_bonus = ctx_bonus(rev_end_hit, jnp.roll(sc[:, 3], 3, axis=1),
                              start_codon_bonus) + pri_r
    return e, start_bonus, stop_bonus, rev_begin_bonus, rev_end_bonus


def _transition_table(log_stay, log_go, log_indel):
    """Static [from, to] log-transition matrix (position bonuses are the
    rank-1 terms added per step in _viterbi; see its docstring)."""
    neg_big = jnp.float32(-1e9)
    tb = jnp.full((NSTATE, NSTATE), neg_big)
    # noncoding: stay; forward/reverse genes close into NC (+stop bonuses)
    tb = tb.at[NC, NC].set(log_stay)
    tb = tb.at[F3, NC].set(0.0)
    tb = tb.at[R3, NC].set(0.0)
    # forward gene: open from NC (+start bonus), codon loop
    tb = tb.at[NC, F1].set(log_go)
    tb = tb.at[F3, F1].set(0.0)
    tb = tb.at[F1, F2].set(0.0)
    tb = tb.at[F2, F3].set(0.0)
    # reverse gene: opens with a (revcomp) stop, closes with a rev start
    tb = tb.at[NC, R1].set(log_go)
    tb = tb.at[R3, R1].set(0.0)
    tb = tb.at[R1, R2].set(0.0)
    tb = tb.at[R2, R3].set(0.0)
    # sequencing errors (log_indel = -1e9 prunes them):
    # insertions detour through FI/RI (self-loop for runs) ...
    tb = tb.at[F1, FI1].set(log_indel)
    tb = tb.at[FI1, FI1].set(log_indel)
    tb = tb.at[FI1, F2].set(0.0)
    tb = tb.at[F2, FI2].set(log_indel)
    tb = tb.at[FI2, FI2].set(log_indel)
    tb = tb.at[FI2, F3].set(0.0)
    tb = tb.at[R1, RI1].set(log_indel)
    tb = tb.at[RI1, RI1].set(log_indel)
    tb = tb.at[RI1, R2].set(0.0)
    tb = tb.at[R2, RI2].set(log_indel)
    tb = tb.at[RI2, RI2].set(log_indel)
    tb = tb.at[RI2, R3].set(0.0)
    # ... deletions skip one codon position
    tb = tb.at[F1, F3].set(log_indel)
    tb = tb.at[F2, F1].set(log_indel)
    tb = tb.at[F3, F2].set(log_indel)
    tb = tb.at[R1, R3].set(log_indel)
    tb = tb.at[R2, R1].set(log_indel)
    tb = tb.at[R3, R2].set(log_indel)
    return tb


def _viterbi(e, start_bonus, stop_bonus, rev_begin_bonus, rev_end_bonus,
             dp0, p_start, log_indel):
    """Viterbi decode, batched over rows of e [B, L, NSTATE].

    The scan step is three fused ops: the [B, from, to] candidate tensor is
    dp + a STATIC transition table + two rank-1 position-bonus terms (the
    four position-dependent edges all touch NC: gene opens NC->F1/R1 carry
    the start/rev-begin bonus on the `to` side, gene closes F3/R3->NC carry
    the stop/rev-end bonus on the `from` side).  The earlier formulation
    scatter-built the candidate tensor edge by edge (25 ops/position) and
    ran ~40x slower at whole-genome lengths."""
    b = e.shape[0]
    tb = _transition_table(jnp.log1p(-2.0 * p_start), jnp.log(p_start),
                           log_indel)
    onehot_nc = jnp.zeros(NSTATE, jnp.float32).at[NC].set(1.0)
    # from-side bonuses (edges *->NC): F3 carries the forward stop bonus,
    # R3 the reverse gene's closing (rev start) bonus
    zeros = jnp.zeros(e.shape[:2] + (NSTATE,), jnp.float32)
    from_bon = zeros.at[:, :, F3].set(stop_bonus).at[:, :, R3].set(
        rev_end_bonus)
    to_bon = zeros.at[:, :, F1].set(start_bonus).at[:, :, R1].set(
        rev_begin_bonus)
    nc_to = onehot_nc[None, None, :]
    nc_from = onehot_nc[None, :, None]

    def step(dp, xs):
        e_i, a_i, c_i = xs  # [B, NSTATE] each
        cand = (dp[:, :, None] + tb[None, :, :]
                + a_i[:, :, None] * nc_to + nc_from * c_i[:, None, :])
        best_from = jnp.argmax(cand, axis=1).astype(jnp.int8)
        dp_new = jnp.max(cand, axis=1) + e_i
        return dp_new, best_from

    xs = (jnp.moveaxis(e, 1, 0), jnp.moveaxis(from_bon, 1, 0),
          jnp.moveaxis(to_bon, 1, 0))
    dp_final, bps = jax.lax.scan(step, dp0, xs)  # bps [L, B, NSTATE]

    # backtrace
    last = jnp.argmax(dp_final, axis=1).astype(jnp.int8)  # [B]

    def back(st, bp_i):
        prev = jnp.take_along_axis(bp_i, st[:, None].astype(jnp.int32), axis=1)[:, 0]
        return prev, st

    _, path_rev = jax.lax.scan(back, last, bps, reverse=True)
    return path_rev  # [L, B] states


@functools.partial(jax.jit, static_argnames=("has_di", "has_nc", "has_ctx",
                                             "has_prior", "has_rdi"))
def _decode_windows(codes, codon_lu, dicodon_lu, start_b, stop_b, p_start,
                    log_indel, dp0, nc_lm, ctx, ctx_aff, ctx_w, ctx_cap,
                    ctx_neg_cap, sprior, rdicodon_lu, *, has_di: bool,
                    has_nc: bool, has_ctx: bool, has_prior: bool,
                    has_rdi: bool = False):
    """codes [B, W] -> decoded state paths [B, W] (one fused program:
    emission/bonus precompute + Viterbi scan + backtrace)."""
    e, sb, pb, rbb, reb = _precompute_scores(
        codes, codon_lu, dicodon_lu if has_di else None, start_b, stop_b,
        nc_lm=nc_lm if has_nc else None, ctx=ctx if has_ctx else None,
        ctx_aff=ctx_aff if has_ctx else None,
        ctx_weight=ctx_w, ctx_cap=ctx_cap, ctx_neg_cap=ctx_neg_cap,
        start_prior=sprior if has_prior else None,
        rdicodon_lu=rdicodon_lu if (has_di and has_rdi) else None)
    path = _viterbi(e, sb, pb, rbb, reb, dp0, p_start, log_indel)
    return jnp.moveaxis(path, 0, 1)  # [B, W]


def _translate(nt: str) -> str:
    aa = []
    for i in range(0, len(nt) - 2, 3):
        aa.append(_CODON_AA.get(nt[i : i + 3].upper(), "X"))
    s = "".join(aa)
    return s[:-1] if s.endswith("*") else s


_REVCOMP = bytes.maketrans(b"ACGT", b"TGCA")

_INS_STATES = frozenset((FI1, FI2, RI1, RI2))
#: (prev, cur) state pairs only reachable through a deletion transition
_DEL_PAIRS = frozenset(
    ((F1, F3), (F2, F1), (F3, F2), (R1, R3), (R2, R1), (R3, R2)))


def _correct_span(seq: bytes, path: np.ndarray, s0: int, e0: int) -> str:
    """Error-corrected CDS of a decoded gene span: insertion-state bases
    are dropped, deletion transitions put an N back in their place."""
    raw = seq[s0:e0].decode("ascii", "replace").upper()
    out = []
    for off, ch in enumerate(raw):
        j = s0 + off
        if off > 0 and (int(path[j - 1]), int(path[j])) in _DEL_PAIRS:
            out.append("N")
        if int(path[j]) in _INS_STATES:
            continue
        out.append(ch)
    return "".join(out)


#: 5'-trim scan range (nt) when whole_genes_only resolves the start codon
_START_SCAN_NT = 402


def _choose_start(cands, nt_cds: str, codon_lu, start_prior,
                  ref_off: int = 0, depth_penalty: float = 0.25) -> int:
    """Rank candidate 5' trims by total-model evidence: the prefix before
    each candidate re-scored as noncoding (coding-looking prefixes push
    the start earlier, intergenic-looking ones push it later), the
    start-codon identity prior, and a longest-ORF regularizer
    (depth_penalty nats per codon past ref_off, the decoded span opening
    — with weak codon bias the per-codon likelihood is noisy, and real
    annotations are strongly biased toward the longest open reading;
    upstream-extension candidates are exempt because there the prefix
    drift already points toward the latest noncoding-looking boundary).
    The flanking-context profile is deliberately NOT used here:
    it double-counts the prefix evidence and, trained on the previous
    round's imperfect starts, measurably degraded 5' accuracy."""
    if len(cands) == 1:
        return cands[0]
    log_nc3 = 3.0 * float(np.log(0.25))
    lu = np.asarray(codon_lu)
    pre, pref = 0.0, {}
    for i in range(0, cands[-1] + 1, 3):
        pref[i] = pre
        tri = nt_cds[i : i + 3]
        if len(tri) == 3 and all(ch in _CODE_BASE for ch in tri):
            pre += log_nc3 - float(lu[_codon_id(tri)])
    best, best_s = cands[0], -np.inf
    for off in cands:
        s = pref[off] - depth_penalty * max(0, off - ref_off) / 3.0
        if start_prior is not None:
            s += float(start_prior[_codon_id(nt_cds[off : off + 3])])
        if s > best_s:
            best, best_s = off, s
    return best


def _ctx_score_host(codes: np.ndarray, lo: np.ndarray, center: int,
                    w: int = 30) -> float:
    """Host-side flanking-context score: sum of lo[j, trinucleotide at
    center-w+j] over the valid window (the scorer predict_genes uses to
    rank candidate 5' trims; the in-Viterbi equivalent is the conv in
    _precompute_scores)."""
    l = len(codes)
    s = 0.0
    for j in range(2 * w + 1):
        p0 = center - w + j
        if 0 <= p0 <= l - 3:
            a, b, c = int(codes[p0]), int(codes[p0 + 1]), int(codes[p0 + 2])
            if a < 4 and b < 4 and c < 4:
                s += float(lo[j, a * 16 + b * 4 + c])
    return s


def train_tables_from_calls(codes: np.ndarray, genes: "List[Gene]",
                            ctx_clip: float = 4.0) -> dict:
    """Estimate every emission table from one genome plus its called
    genes — the estimation step of self-training (see
    self_trained_params).  Returns kwargs for dataclasses.replace on
    GenePredParams: codon_logusage, dicodon_logusage, noncoding_lm, ctx.

    The context tables are counted exactly as the original tool's
    training pipeline defines them: trinucleotide frequencies at each of
    the 61 offsets in a +-30 nt window around (fwd start, fwd stop, rev
    open = minus stop, rev close = minus start), converted to log-odds
    vs the uniform 1/64 background and clipped."""
    l = len(codes)
    gm = GeneModel.train_from_cds([g.nt for g in genes], nb_bins=1)

    # dicodon gate: conditioning on the previous codon only helps when
    # the genome actually has dicodon structure.  On usage-i.i.d. codons
    # the conditional table is pure estimation noise (~4096 cells from a
    # few thousand training codons) that costs ~0.2-0.4 nat/codon and
    # can flip the whole coding-vs-noncoding advantage negative.  Gate on
    # the Miller-Madow bias-corrected mutual information of the training
    # dicodon counts.
    dcnt = np.zeros((64, 64), np.float64)
    for g in genes:
        s = g.nt.upper()
        prev = None
        for i in range(0, len(s) - 2, 3):
            tri_s = s[i : i + 3]
            if any(ch not in _CODE_BASE for ch in tri_s):
                prev = None
                continue
            cid = _codon_id(tri_s)
            if prev is not None:
                dcnt[prev, cid] += 1
            prev = cid
    n_pairs = dcnt.sum()
    use_dicodon = False
    if n_pairs > 0:
        pj = dcnt / n_pairs
        pr = pj.sum(1, keepdims=True)
        pc = pj.sum(0, keepdims=True)
        nz = pj > 0
        mi = float((pj[nz] * np.log(pj[nz] / (pr @ pc)[nz])).sum())
        k1 = int((pr > 0).sum())
        k2 = int((pc > 0).sum())
        mi_corr = mi - (k1 - 1) * (k2 - 1) / (2.0 * n_pairs)
        use_dicodon = mi_corr > 0.05

    # noncoding first-order Markov over the intergenic complement
    coding = np.zeros(l, bool)
    for g in genes:
        coding[g.start : g.end] = True
    prev_c, cur_c = codes[:-1], codes[1:]
    ok = (~coding[:-1]) & (~coding[1:]) & (prev_c < 4) & (cur_c < 4)
    nc_cnt = np.ones((4, 4), np.float64)
    np.add.at(nc_cnt, (prev_c[ok], cur_c[ok]), 1)
    nc_lm = np.log(nc_cnt / nc_cnt.sum(axis=1, keepdims=True)
                   ).astype(np.float32)

    # flanking-context counts; table order matches GeneModel.ctx_for
    tri = (codes[: l - 2].astype(np.int32) * 16
           + codes[1 : l - 1].astype(np.int32) * 4
           + codes[2:].astype(np.int32))
    tri_ok = (codes[: l - 2] < 4) & (codes[1 : l - 1] < 4) & (codes[2:] < 4)
    centers = [[], [], [], []]
    for g in genes:
        if g.strand == "+":
            centers[0].append(g.start)
            centers[1].append(g.end - 3)
        else:
            centers[2].append(g.start)
            centers[3].append(g.end - 3)
    cnt = np.zeros((4, 61, 64), np.float64)
    for t, cs in enumerate(centers):
        if not cs:
            continue
        cs = np.asarray(cs, np.int64)
        for j in range(61):
            p0 = cs - 30 + j
            p0 = p0[(p0 >= 0) & (p0 <= l - 3)]
            p0 = p0[tri_ok[p0]]
            np.add.at(cnt[t, j], tri[p0], 1)
    # log-odds vs the GENOME trinucleotide background (not uniform —
    # composition bias would otherwise leak into every window), smoothed
    # by background-proportional pseudo-counts, and CENTERED per offset
    # so a background-distributed window scores exactly 0: without the
    # centering, sparse foreground counts (few training genes) make
    # unseen trinucleotides dominate and every 61-term window sum goes
    # deeply negative — gene opening then costs more at a true start
    # than the fixed miss penalty, collapsing sensitivity
    bg = np.bincount(tri[tri_ok], minlength=64).astype(np.float64) + 1.0
    bg /= bg.sum()
    n_row = cnt.sum(axis=2, keepdims=True)
    fg = (cnt + 4.0 * bg) / (n_row + 4.0)
    lo = np.log(fg / bg)
    lo -= (bg * lo).sum(axis=2, keepdims=True)
    ctx = np.clip(lo, -ctx_clip, 1.5 * ctx_clip).astype(np.float32)

    # calibrate the 61-term window SUM into a bounded log-posterior-odds
    # bonus — the original tool's `pwm` score-distribution role.  Raw
    # sums at true boundaries can reach ~100+ on strongly biased genomes
    # (half the window is coding, and coding-vs-background log-odds
    # dominate the boundary-specific signal), so uncalibrated sums
    # saturate any clip and rank false and true sites identically.  An
    # equal-variance two-class Gaussian (true centers vs random
    # positions) gives an AFFINE per-table map scale*sum + offset whose
    # output is ~+llr at true sites and ~-llr at background ones.
    def sums_at(t, cs):
        cs = np.asarray(cs, np.int64)
        s = np.zeros(len(cs))
        for j in range(61):
            p0 = cs - 30 + j
            sel = (p0 >= 0) & (p0 <= l - 3)
            idx = p0[sel]
            good = tri_ok[idx]
            # clamp BEFORE indexing: trinucleotides containing an invalid
            # code (N runs in real assemblies) encode past 63 and would
            # IndexError ctx even under the np.where mask
            tri_safe = np.where(good, tri[idx], 0)
            s[sel] += np.where(good, ctx[t, j, tri_safe], 0.0)
        return s

    rng = np.random.default_rng(0xC7B)
    rand_pos = rng.integers(31, max(l - 33, 62), 512)
    aff = np.zeros((4, 2), np.float32)
    fallback_bonus = (3.0, 6.0, 6.0, 3.0)  # start, stop, rev-open, rev-close
    for t in range(4):
        if len(centers[t]) < 5:
            aff[t] = (0.0, fallback_bonus[t])
            continue
        st = sums_at(t, centers[t])
        sf = sums_at(t, rand_pos)
        var = 0.5 * (st.var() + sf.var()) + 1e-6
        scale = (st.mean() - sf.mean()) / var
        if scale <= 0:
            aff[t] = (0.0, fallback_bonus[t])
            continue
        aff[t] = (scale, -scale * 0.5 * (st.mean() + sf.mean()))
    # start-codon identity prior (centered log-odds vs uniform over the
    # three start codons, clipped so a rare-but-real GTG/TTG start stays
    # reachable)
    spc = np.zeros(3)
    for g in genes:
        tri = g.nt[:3].upper()
        if tri in _STARTS:
            spc[_STARTS.index(tri)] += 1
    spr = (spc + 0.5) / (spc.sum() + 1.5)
    start_prior = np.zeros(64, np.float32)
    for k, s_codon in enumerate(_STARTS):
        start_prior[_codon_id(s_codon)] = np.log(spr[k] * 3.0)
    start_prior = np.clip(start_prior, -4.0, 4.0)

    return {"codon_logusage": gm.codon_logusage[0],
            "dicodon_logusage":
                gm.dicodon_logusage[0] if use_dicodon else None,
            "noncoding_lm": nc_lm, "ctx": ctx, "ctx_aff": aff,
            "start_prior": start_prior}


def self_trained_params(seq: bytes, base: "GenePredParams | None" = None,
                        rounds: int = 3, min_train_nt: int = 300,
                        min_calls: int = 8) -> "GenePredParams":
    """Organism-adaptive self-training: call genes with the current
    model, re-estimate every emission table from the calls, repeat.

    This replaces distribution-matched pre-trained tables the way
    Prodigal/GeneMark self-training does — the built-in prior only
    bootstraps the first pass (its synonymous-smoothed table keeps the
    stop/amino-acid signal organism-independent), after which the codon,
    dicodon, noncoding, and boundary-context tables all come from the
    input genome itself.  The reference tool instead ships fixed
    CG-binned tables (FragGeneScanRs.rs:116-119); those remain loadable
    via GeneModel.from_fgs_train_dir."""
    p = base or GenePredParams()
    from ..io.codec import encode_dna

    codes = encode_dna(seq)
    for r in range(rounds):
        genes = predict_genes(seq, p)
        usable = [g for g in genes if len(g.nt) >= min_train_nt]
        if len(usable) < min_calls:
            log.warning("self-train round %d: only %d usable calls "
                        "(< %d); keeping the current model",
                        r, len(usable), min_calls)
            return p
        t = train_tables_from_calls(codes, usable)
        p = dataclasses.replace(p, model=None, **t)
        log.info("self-train round %d: re-estimated tables from %d calls",
                 r, len(usable))
    return p


#: whole-genome decoding window: contigs longer than _WINDOW split into
#: batched overlapping windows (the device gets batch parallelism instead of one
#: multi-hundred-thousand-step serial scan; the reference tool gets its
#: parallelism the same way — across reads/records,
#: FragGeneScanRs.rs:225-243 chunked(100) rayon)
_WINDOW = 8192
#: per-side overlap: Viterbi forgets the window boundary well within this
#: (the correct frame beats wrong frames by ~1 nat/codon, so a few hundred
#: bases pin it); core labels are then boundary-insensitive and stitch
#: cleanly
_OVERLAP = 1024
#: max windows decoded per device dispatch
_MAX_BATCH = 64

_NEG_BIG = -1e9


def _decode_path(codes: np.ndarray, p: GenePredParams, codon_lu,
                 dicodon_lu, nc_lm=None, ctx=None, ctx_aff=None,
                 rdicodon_lu=None) -> np.ndarray:
    """Full-contig Viterbi state path [L] via batched overlapping windows."""
    l = len(codes)
    start_b = jnp.float32(p.start_codon_bonus)
    stop_b = jnp.float32(p.stop_bonus)
    p_start = jnp.float32(p.p_gene_start)
    log_indel = jnp.float32(np.log(p.indel_rate) if p.allow_indels else _NEG_BIG)
    clu = jnp.asarray(codon_lu)
    has_di = dicodon_lu is not None
    dlu = jnp.asarray(dicodon_lu) if has_di else jnp.zeros((64, 64), jnp.float32)
    has_rdi = has_di and rdicodon_lu is not None
    rdlu = (jnp.asarray(rdicodon_lu) if has_rdi
            else jnp.zeros((64, 64), jnp.float32))
    has_nc = nc_lm is not None
    nclm = jnp.asarray(nc_lm) if has_nc else jnp.zeros((4, 4), jnp.float32)
    has_ctx = ctx is not None
    ctxj = jnp.asarray(ctx) if has_ctx else jnp.zeros((4, 61, 64), jnp.float32)
    affj = (jnp.asarray(ctx_aff) if ctx_aff is not None
            else jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), (4, 1)))
    ctx_w = jnp.float32(p.ctx_weight)
    ctx_cap = jnp.float32(p.ctx_cap)
    ctx_neg = jnp.float32(p.ctx_neg_cap)
    has_prior = p.start_prior is not None
    spri = (jnp.asarray(p.start_prior) if has_prior
            else jnp.zeros(64, jnp.float32))

    def run(win_codes: np.ndarray, first_row0: bool) -> np.ndarray:
        nb, w = win_codes.shape
        dp0 = np.zeros((nb, NSTATE), np.float32)
        if first_row0:
            # true sequence start: begin in NC (interior windows may open
            # mid-gene, so they start unconstrained)
            dp0[0, :] = _NEG_BIG
            dp0[0, NC] = 0.0
        return np.asarray(_decode_windows(
            jnp.asarray(win_codes), clu, dlu, start_b, stop_b, p_start,
            log_indel, jnp.asarray(dp0), nclm, ctxj, affj, ctx_w, ctx_cap,
            ctx_neg, spri, rdlu, has_di=has_di, has_nc=has_nc,
            has_ctx=has_ctx, has_prior=has_prior, has_rdi=has_rdi))

    if l <= _WINDOW:
        # single window, padded to a power-of-two bucket for program reuse
        target = 1 << 12
        while target < l:
            target <<= 1
        win = np.pad(codes, (0, target - l), constant_values=255)[None, :]
        return run(win, True)[0, :l]

    core = _WINDOW - 2 * _OVERLAP
    n_win = -(-l // core)
    wins = np.full((n_win, _WINDOW), 255, np.uint8)
    spans = []  # (win_index, core offset within window, core start, core len)
    for i in range(n_win):
        c0 = i * core
        clen = min(core, l - c0)
        w0 = max(c0 - _OVERLAP, 0)
        take = min(_WINDOW, l - w0)
        wins[i, :take] = codes[w0 : w0 + take]
        spans.append((i, c0 - w0, c0, clen))

    path = np.empty(l, np.int8)
    for b0 in range(0, n_win, _MAX_BATCH):
        chunk = wins[b0 : b0 + _MAX_BATCH]
        nb = chunk.shape[0]
        bucket = 8
        while bucket < nb:
            bucket <<= 1
        bucket = min(bucket, _MAX_BATCH)
        if bucket > nb:
            chunk = np.concatenate(
                [chunk, np.full((bucket - nb, _WINDOW), 255, np.uint8)], 0)
        out = run(chunk, first_row0=b0 == 0)
        for i, off, c0, clen in spans[b0 : b0 + _MAX_BATCH]:
            path[c0 : c0 + clen] = out[i - b0, off : off + clen]
    return path


def predict_genes(seq: bytes, params: GenePredParams | None = None) -> List[Gene]:
    """Call genes on one contig. Returns Gene records with translations."""
    from ..io.codec import encode_dna

    p = params or GenePredParams()
    codes = encode_dna(seq)
    l = len(codes)
    if l < p.min_gene_len:
        return []
    codon_lu, dicodon_lu = p.codon_logusage, p.dicodon_logusage
    rdicodon_lu = p.rdicodon_logusage
    nc_lm, ctx, ctx_aff = p.noncoding_lm, p.ctx, p.ctx_aff
    if p.model is not None:
        # CG-content-binned table selection, as the reference tool does per
        # record (FragGeneScanRs.rs:225-243 count_cg_content -> locals[cg])
        valid = codes < 4
        nv = int(valid.sum())
        cg = 100.0 * float(((codes == 1) | (codes == 2)).sum()) / max(nv, 1)
        codon_lu, dicodon_lu, rdicodon_lu = p.model.tables_for(cg)
        nc_lm, ctx, ctx_aff = p.model.ctx_for(cg)
    path = _decode_path(codes, p, codon_lu, dicodon_lu, nc_lm, ctx, ctx_aff,
                        rdicodon_lu=rdicodon_lu)

    genes: List[Gene] = []
    coding_f = ((path >= F1) & (path <= F3)) | (path == FI1) | (path == FI2)
    coding_r = ((path >= R1) & (path <= R3)) | (path == RI1) | (path == RI2)
    for coding, strand in ((coding_f, "+"), (coding_r, "-")):
        edges = np.flatnonzero(np.diff(coding.astype(np.int8)))
        starts = edges[coding[edges + 1]] + 1 if len(edges) else np.array([], int)
        ends = edges[~coding[edges + 1]] + 1 if len(edges) else np.array([], int)
        if coding[0]:
            starts = np.concatenate([[0], starts])
        if coding[-1]:
            ends = np.concatenate([ends, [l]])
        for s0, e0 in zip(starts, ends):
            if p.allow_indels:
                # read correction, as the reference tool emits for error
                # reads: drop bases decoded as insertions, restore deleted
                # ones as N (-> X in the protein) so the frame holds
                nt = _correct_span(seq, path, int(s0), int(e0))
                if len(nt) < p.min_gene_len:
                    continue
            else:
                ln = e0 - s0
                ln -= ln % 3
                e0 = s0 + ln
                if ln < p.min_gene_len:
                    continue
                nt = seq[s0:e0].decode("ascii", "replace").upper()
            if strand == "-":
                nt_cds = nt.encode().translate(_REVCOMP)[::-1].decode()
            else:
                nt_cds = nt
            if p.allow_indels:
                nt_cds = nt_cds[: len(nt_cds) - len(nt_cds) % 3]
            if p.whole_genes_only:
                # -w 1: only complete genes. Trim the 5' end to an
                # in-frame start codon (the Viterbi opening can be a few
                # codons off); require a terminal stop.  Candidates with
                # an in-frame stop between them and the terminal stop
                # are disqualified (they cannot head this ORF), and the
                # survivor with the best combined evidence wins
                # (_choose_start).
                if nt_cds[-3:] not in _STOPS:
                    continue
                # the Viterbi opening can be LATE by whole codon runs
                # when the codon bias is weak (a coding stretch can look
                # noncoding by chance), so the candidate search extends
                # well upstream of the decoded span (in CDS orientation);
                # the last upstream IN-FRAME STOP fences the extension at
                # the ORF boundary, exactly as the classic ORF definition
                # does (uniform intergenic hits one every ~21 codons)
                ext = min(300, int(s0) if strand == "+" else l - int(e0))
                ext -= ext % 3
                if strand == "+":
                    lead = seq[int(s0) - ext : int(s0)]
                else:
                    lead = seq[int(e0) : int(e0) + ext]
                    lead = lead.translate(_REVCOMP)[::-1]
                work = lead.decode("ascii", "replace").upper() + nt_cds
                last_stop = -3
                for i in range(0, len(work) - 5, 3):
                    if work[i : i + 3] in _STOPS:
                        last_stop = i
                span = min(len(work) - 2, ext + _START_SCAN_NT)
                cands = [i for i in range(0, span, 3)
                         if work[i : i + 3] in _STARTS and i > last_stop]
                if not cands:
                    # no start near the decoded opening (weak-bias genome,
                    # late start): scan the REST of the ORF before giving
                    # up — dropping the gene here is a pure sensitivity
                    # loss vs the first-in-frame-start behavior
                    cands = [i for i in range(span - span % 3, len(work) - 2, 3)
                             if work[i : i + 3] in _STARTS and i > last_stop]
                if not cands:
                    continue
                # only candidates that leave a gene of legal length can
                # head this ORF; the best-evidence choice among them
                cands_ok = [i for i in cands
                            if len(work) - i >= p.min_gene_len]
                if not cands_ok:
                    continue
                chosen = _choose_start(cands_ok, work, codon_lu,
                                       p.start_prior, ref_off=ext)
                start_off = chosen - ext  # negative: upstream extension
                nt_cds = work[chosen:]
                if strand == "+":
                    s0 += start_off
                else:
                    e0 -= start_off
            aa = _translate(nt_cds)
            if "*" in aa:
                continue  # internal stop: reject
            genes.append(Gene(start=int(s0), end=int(e0), strand=strand, nt=nt_cds, aa=aa))
    genes.sort(key=lambda g: g.start)
    return genes
