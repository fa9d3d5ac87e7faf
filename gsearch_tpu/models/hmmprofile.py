"""Profile-HMM search over HMMER3 files — the `hmmsearch` engine.

Capability-equivalent of the reference's hmmsearch_rs companion tool
(reference: README.md:353-374 — "Search protein sequences against HMM
profiles", tabular output), which the universal-gene workflow uses to
extract the 120/122 GTDB marker genes (data/HMM_bacteria, data/HMM_archaea;
data/README.md:1) that `tohnsw --aa` then indexes (README.md:656-660).

Device formulation
---------------
Plan7 local Viterbi is a 2-D DP (sequence position x profile position).
The sequence axis is a `lax.scan`; everything inside one step is
vectorized over [batch, profile-position] on the VPU.  The only
within-step dependency is the delete chain D[j] = max(M[j-1]+tMD,
D[j-1]+tDD) — a max-plus prefix recurrence along j, computed as a
`cummax` after subtracting the cumulative tDD (log of the geometric
delete-run cost), so no inner loop survives.  Profiles of different
lengths pad to one [H, Lmax] block and vmap; sequences bucket by length.

Scoring model
-------------
HMMER3's default configuration exactly (multihit local Plan7 with the
length-dependent N/J/C loop model and null1 subtraction — p7_ProfileConfig
+ p7_ReconfigLength, Eddy 2011): entry t(B->Mk) = 2(L-k+1)/(L(L+1)), exit
t(Mk->E) = 1, insert log-odds 0, N/J/C self-loops log(L/(L+2)), moves
log(2/(L+2)), E->{J,C} log(1/2).  Both decoders are implemented: Viterbi
(optimal alignment — the fast-filter score) and Forward (summed
alignments — the score real hmmsearch reports and applies GA cutoffs to).
scripts/hmmsearch_fidelity.py verifies bit scores against an independent
float64 re-implementation on the real GTDB marker profiles (residual =
float32 rounding; this validates internal consistency and numerics, not
byte parity with HMMER itself, which is not in the image).  Documented
deviation from the full hmmsearch pipeline: no null2 biased-composition
correction.  E-values use the profile's calibrated `STATS LOCAL VITERBI`
(Gumbel) or `STATS LOCAL FORWARD` (exponential) right tail:
P = exp(-lambda (bits - tau)), E = P * n_targets.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

#: HMMER3 amino-acid column order
HMM_ALPHABET = "ACDEFGHIKLMNPQRSTVWY"
_AA_INDEX = {c: i for i, c in enumerate(HMM_ALPHABET)}

#: HMMER default background frequencies (p7_bg, Swiss-Prot derived)
BG_FREQ = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062,
    0.0695071, 0.0229198, 0.0590092, 0.0594422, 0.0963728,
    0.0237718, 0.0414386, 0.0482904, 0.0395639, 0.0540978,
    0.0683364, 0.0540687, 0.0673417, 0.0114135, 0.0304133,
], dtype=np.float64)


@dataclass
class ProfileHMM:
    """One parsed HMMER3/f profile (natural-log space, node 0 = begin)."""

    name: str
    acc: str
    length: int
    match_logodds: np.ndarray  # [L+1, 20] f32, row 0 = -inf
    # transitions FROM node k (ln p): mm mi md im ii dm dd
    trans: np.ndarray          # [L+1, 7] f32
    ga: float = math.nan       # GA gathering cutoff (bits), nan if absent
    stats_vit: tuple = ()      # (tau, lambda) from STATS LOCAL VITERBI
    stats_fwd: tuple = ()      # (tau, lambda) from STATS LOCAL FORWARD
    desc: str = ""


def parse_hmmer3(path: str) -> List[ProfileHMM]:
    """Parse an HMMER3/f text file (one or more profiles)."""
    out = []
    with open(path, "r", errors="replace") as f:
        lines = iter(f)
        while True:
            prof = _parse_one(lines)
            if prof is None:
                return out
            out.append(prof)


def _floats(tokens):
    return [math.inf if t == "*" else float(t) for t in tokens]


def _parse_one(lines):
    name = acc = desc = ""
    ga = math.nan
    stats_vit = ()
    stats_fwd = ()
    length = 0
    header_seen = False
    for ln in lines:
        t = ln.split()
        if not t:
            continue
        if t[0].startswith("HMMER3"):
            header_seen = True
        elif t[0] == "NAME":
            name = t[1]
        elif t[0] == "ACC":
            acc = t[1]
        elif t[0] == "DESC":
            desc = ln[5:].strip()
        elif t[0] == "LENG":
            length = int(t[1])
        elif t[0] == "GA":
            ga = float(t[1])
        elif t[0] == "STATS" and len(t) >= 5 and t[2] == "VITERBI":
            stats_vit = (float(t[3]), float(t[4]))
        elif t[0] == "STATS" and len(t) >= 5 and t[2] == "FORWARD":
            stats_fwd = (float(t[3]), float(t[4]))
        elif t[0] == "HMM":
            break
    else:
        return None
    if not header_seen or length == 0:
        return None
    next(lines)  # the m->m m->i ... transition header line

    L = length
    mat = np.full((L + 1, 20), np.inf, np.float64)  # -ln p
    trans = np.full((L + 1, 7), np.inf, np.float64)
    k = 0  # node about to be read (0 = begin)
    for ln in lines:
        t = ln.split()
        if not t:
            continue
        if t[0] == "//":
            break
        if t[0] == "COMPO":
            continue
        if k == 0:
            # node 0: insert-emission line (ignored: local config scores
            # inserts at 0) then its transition line
            if len(t) == 20:
                continue
            trans[0] = _floats(t[:7])
            k = 1
            continue
        # node k: match line (leads with the node number), insert line
        # (bare 20 floats), transition line (7 floats)
        if t[0] == str(k) and len(t) >= 21:
            mat[k] = _floats(t[1:21])
        elif len(t) == 20:
            continue
        elif len(t) == 7:
            trans[k] = _floats(t)
            k += 1
    # -ln p -> log-odds vs background
    lo = np.where(np.isfinite(mat), -mat - np.log(BG_FREQ)[None, :], -np.inf)
    lo[0] = -np.inf
    return ProfileHMM(
        name=name, acc=acc, length=L,
        match_logodds=lo.astype(np.float32),
        trans=(-trans).astype(np.float32),  # ln p (inf -> -inf)
        ga=ga, stats_vit=stats_vit, stats_fwd=stats_fwd, desc=desc,
    )


# ---------------------------------------------------------------------------
# batched Viterbi
# ---------------------------------------------------------------------------


def _pack_profiles(profiles: Sequence[ProfileHMM]):
    """Pad H profiles to one [H, Lmax+1, ...] block (masked past each L)."""
    lmax = max(p.length for p in profiles)
    H = len(profiles)
    msc = np.full((H, lmax + 1, 20), -np.inf, np.float32)
    tr = np.full((H, lmax + 1, 7), -np.inf, np.float32)
    tbm = np.full((H, lmax + 1), -np.inf, np.float32)
    for h, p in enumerate(profiles):
        L = p.length
        msc[h, : L + 1] = p.match_logodds
        tr[h, : L + 1] = p.trans
        k = np.arange(1, L + 1, dtype=np.float64)
        tbm[h, 1 : L + 1] = np.log(2.0 * (L - k + 1) / (L * (L + 1.0)))
    return jnp.asarray(msc), jnp.asarray(tr), jnp.asarray(tbm)


@functools.partial(jax.jit, static_argnames=("multihit",))
def _viterbi_block(msc, tr, tbm, seqs, lens, multihit=True):
    """Local Plan7 Viterbi with HMMER3's full length model.

    msc [H, L+1, 20], tr [H, L+1, 7], tbm [H, L+1], seqs [B, T] int32
    (aa index, any value for pads — masked by lens), lens [B].
    Returns bit-score numerator (nats) [H, B]: viterbi - null1.

    This is HMMER3's default scoring semantics exactly (p7_ProfileConfig
    multihit local + p7_ReconfigLength, Eddy 2011): the special states
    N/B/E/J/C ride along the residue scan as scalars per (profile, seq).
    N is deterministic (xN(i) = i*loop) so it travels as the position
    index; J and C are carried.  Per residue, N/J/C self-loops cost
    loop = log(L/(L+2)), every B entry pays move = log(2/(L+2)), E->J
    and E->C cost log(1/2) (multihit) or 0/-inf (unihit), the final C->T
    pays move once more, and null1 = L log(L/(L+1)) + log(1/(L+1)) is
    subtracted.  scripts/hmmsearch_fidelity.py verifies the result
    against an independent float64 oracle on the real GTDB marker
    profiles (residual = float32 rounding only)."""
    Hn, Lp1, _ = msc.shape
    tMM, tMI, tMD = tr[..., 0], tr[..., 1], tr[..., 2]
    tIM, tII = tr[..., 3], tr[..., 4]
    tDM, tDD = tr[..., 5], tr[..., 6]
    # cumulative delete-chain cost c[j] = sum_{l<=j} tDD[l]
    cdd = jnp.cumsum(jnp.where(jnp.isfinite(tDD), tDD, 0.0), axis=1)

    def shift1(a):  # a[..., j] -> a[..., j-1] with -inf at j=0
        return jnp.pad(a[..., :-1], [(0, 0)] * (a.ndim - 1) + [(1, 0)],
                       constant_values=-jnp.inf)

    tMMs, tIMs, tDMs = shift1(tMM), shift1(tIM), shift1(tDM)
    neg = jnp.float32(-1e30)
    B = seqs.shape[0]

    log_ej = jnp.float32(math.log(0.5)) if multihit else neg  # E->J
    log_ec = jnp.float32(math.log(0.5) if multihit else 0.0)  # E->C
    Lf = jnp.maximum(lens.astype(jnp.float32), 1.0)
    loop = jnp.log(Lf / (Lf + 2.0))                       # [B] N/J/C self
    move = jnp.log(2.0 / (Lf + 2.0))                      # [B] ->B / C->T
    null1 = Lf * jnp.log(Lf / (Lf + 1.0)) + jnp.log(1.0 / (Lf + 1.0))

    def step(carry, xi):
        M, I, D, J, C = carry      # [H, B, L+1] x3, [H, B] x2
        x, alive, t = xi           # [B] int32, [B] bool, scalar int32
        em = msc[:, :, :].transpose(0, 2, 1)  # [H, 20, L+1]
        em_x = em[:, x, :]                    # [H, B, L+1]
        xN_prev = t.astype(jnp.float32) * loop           # [B] N after t loops
        b_prev = move[None, :] + jnp.maximum(xN_prev[None, :], J)
        cand = jnp.maximum(
            jnp.maximum(shift1(M) + tMMs[:, None, :],
                        shift1(I) + tIMs[:, None, :]),
            jnp.maximum(shift1(D) + tDMs[:, None, :],
                        tbm[:, None, :] + b_prev[:, :, None]),
        )
        Mn = em_x + cand
        Mn = jnp.maximum(Mn, neg)  # keep -inf out of the cummax chain
        # delete chain: D[j] = max_{k<=j-1}(M[k] + tMD[k] - c[k]) + c[j-1]
        g = Mn + (tMD - cdd)[:, None, :]
        Dn = shift1(jax.lax.cummax(g, axis=2)) + shift1(cdd)[:, None, :]
        In = jnp.maximum(M + tMI[:, None, :], I + tII[:, None, :])
        e_i = jnp.max(Mn, axis=2)  # exit t(Mk->E) = 1 (local)
        Jn = jnp.where(alive[None, :],
                       jnp.maximum(J + loop[None, :], e_i + log_ej), J)
        Cn = jnp.where(alive[None, :],
                       jnp.maximum(C + loop[None, :], e_i + log_ec), C)
        keep = alive[None, :, None]
        return (jnp.where(keep, Mn, M), jnp.where(keep, In, I),
                jnp.where(keep, Dn, D), Jn, Cn), None

    M0 = jnp.full((Hn, B, Lp1), neg, jnp.float32)
    T = seqs.shape[1]
    alive = (jnp.arange(T)[None, :] < lens[:, None])
    (_, _, _, _, bestC), _ = jax.lax.scan(
        step, (M0, M0, M0, jnp.full((Hn, B), neg, jnp.float32),
               jnp.full((Hn, B), neg, jnp.float32)),
        (seqs.T, alive.T, jnp.arange(T, dtype=jnp.int32)))
    return bestC + move[None, :] - null1[None, :]


@functools.partial(jax.jit, static_argnames=("multihit",))
def _forward_block(msc, tr, tbm, seqs, lens, multihit=True):
    """Local Plan7 Forward — the logsumexp twin of _viterbi_block.

    Same length model, same [H, B] nats-numerator output; max -> logaddexp
    throughout.  Real `hmmsearch` reports Forward bit scores after its
    filter pipeline (p7_Pipeline, Eddy 2011), so GA-threshold decisions
    follow this score.  The within-row delete chain
    D[j] = logaddexp(M[j-1]+tMD[j-1], D[j-1]+tDD[j-1]) is a first-order
    log-linear recurrence along j, computed with an associative scan
    (combine: (a1,b1)*(a2,b2) = (a1+a2, logaddexp(b1+a2, b2))) — no inner
    loop, O(log L) depth like the Viterbi cummax."""
    Hn, Lp1, _ = msc.shape
    tMM, tMI, tMD = tr[..., 0], tr[..., 1], tr[..., 2]
    tIM, tII = tr[..., 3], tr[..., 4]
    tDM, tDD = tr[..., 5], tr[..., 6]

    def shift1(a):
        return jnp.pad(a[..., :-1], [(0, 0)] * (a.ndim - 1) + [(1, 0)],
                       constant_values=-jnp.inf)

    tMMs, tIMs, tDMs = shift1(tMM), shift1(tIM), shift1(tDM)
    tMDs, tDDs = shift1(tMD), shift1(tDD)
    neg = jnp.float32(-1e30)
    B = seqs.shape[0]

    log_ej = jnp.float32(math.log(0.5)) if multihit else neg  # E->J
    log_ec = jnp.float32(math.log(0.5) if multihit else 0.0)  # E->C
    Lf = jnp.maximum(lens.astype(jnp.float32), 1.0)
    loop = jnp.log(Lf / (Lf + 2.0))                       # [B] N/J/C self
    move = jnp.log(2.0 / (Lf + 2.0))                      # [B] ->B / C->T
    null1 = Lf * jnp.log(Lf / (Lf + 1.0)) + jnp.log(1.0 / (Lf + 1.0))

    def lse(a, b):
        return jnp.logaddexp(a, b)

    def dd_chain(Mn):
        # D[j] = logaddexp(b[j], a[j] + D[j-1]) with a[j] = tDD[j-1],
        # b[j] = M[j-1] + tMD[j-1]; solved by associative scan over j
        a = jnp.broadcast_to(tDDs[:, None, :], Mn.shape)
        bq = shift1(Mn + tMD[:, None, :])

        def comb(x, y):
            a1, b1 = x
            a2, b2 = y
            return a1 + a2, lse(b1 + a2, b2)

        _, D = jax.lax.associative_scan(comb, (a, bq), axis=2)
        return jnp.maximum(D, neg)

    def step(carry, xi):
        M, I, D, J, C = carry      # [H, B, L+1] x3, [H, B] x2
        x, alive, t = xi           # [B] int32, [B] bool, scalar int32
        em = msc.transpose(0, 2, 1)           # [H, 20, L+1]
        em_x = em[:, x, :]                    # [H, B, L+1]
        xN_prev = t.astype(jnp.float32) * loop           # [B]
        b_prev = move[None, :] + lse(xN_prev[None, :], J)
        cand = lse(
            lse(shift1(M) + tMMs[:, None, :], shift1(I) + tIMs[:, None, :]),
            lse(shift1(D) + tDMs[:, None, :],
                tbm[:, None, :] + b_prev[:, :, None]),
        )
        Mn = jnp.maximum(em_x + cand, neg)
        Dn = dd_chain(Mn)
        In = jnp.maximum(
            lse(M + tMI[:, None, :], I + tII[:, None, :]), neg)
        # exit t(Mk->E) = 1 (uniform local): E = logsumexp_k M[k]
        mmax = jnp.max(Mn, axis=2)
        e_i = mmax + jnp.log(jnp.sum(
            jnp.exp(Mn - mmax[:, :, None]), axis=2))
        Jn = jnp.where(alive[None, :], lse(J + loop[None, :], e_i + log_ej), J)
        Cn = jnp.where(alive[None, :], lse(C + loop[None, :], e_i + log_ec), C)
        keep = alive[None, :, None]
        return (jnp.where(keep, Mn, M), jnp.where(keep, In, I),
                jnp.where(keep, Dn, D), Jn, Cn), None

    M0 = jnp.full((Hn, B, Lp1), neg, jnp.float32)
    T = seqs.shape[1]
    alive = (jnp.arange(T)[None, :] < lens[:, None])
    (_, _, _, _, sumC), _ = jax.lax.scan(
        step, (M0, M0, M0, jnp.full((Hn, B), neg, jnp.float32),
               jnp.full((Hn, B), neg, jnp.float32)),
        (seqs.T, alive.T, jnp.arange(T, dtype=jnp.int32)))
    return sumC + move[None, :] - null1[None, :]


class HmmSearcher:
    """Batched search of protein sequences against a set of profiles."""

    def __init__(self, profiles: Sequence[ProfileHMM], multihit: bool = True):
        if not profiles:
            raise ValueError("no profiles given")
        self.profiles = list(profiles)
        self.multihit = multihit  # HMMER3 default config; False = uni-local
        self._msc, self._tr, self._tbm = _pack_profiles(self.profiles)

    @staticmethod
    def encode(seq: str) -> np.ndarray:
        """aa string -> int32 indices (unknown residues -> 0 scored as A;
        HMMER treats ambiguity codes by marginalization — a 1-residue
        approximation here)."""
        return np.array([_AA_INDEX.get(c, 0) for c in seq.upper()], np.int32)

    def score(self, seqs: Sequence[np.ndarray],
              algo: str = "viterbi") -> np.ndarray:
        """Returns bit scores [n_profiles, n_seqs].

        algo="viterbi": optimal-alignment scores (fast filter semantics).
        algo="forward": summed-alignment scores — what real hmmsearch
        reports and applies GA cutoffs to (p7_Pipeline)."""
        block_fn = {"viterbi": _viterbi_block,
                    "forward": _forward_block}[algo]
        B = len(seqs)
        lens = np.array([len(s) for s in seqs], np.int32)
        out = np.empty((len(self.profiles), B), np.float32)
        # bucket by length (power-of-two pads: few compiled shapes)
        order = np.argsort(lens, kind="stable")
        pos = 0
        while pos < B:
            t = max(int(lens[order[pos]]), 16)
            tpad = 1 << (t - 1).bit_length()
            take = [i for i in order[pos:] if lens[i] <= tpad][:64]
            pos += len(take)
            bb = len(take)
            bpad = 1 << max((bb - 1).bit_length(), 3)
            block = np.zeros((bpad, tpad), np.int32)
            for r, i in enumerate(take):
                block[r, : lens[i]] = seqs[i]
            ln = np.zeros(bpad, np.int32)
            ln[:bb] = lens[np.asarray(take)]
            nats = np.asarray(block_fn(
                self._msc, self._tr, self._tbm,
                jnp.asarray(block), jnp.asarray(ln), multihit=self.multihit))
            out[:, np.asarray(take)] = nats[:, :bb]
        return out / np.float32(math.log(2.0))  # nats -> bits

    def evalues(self, bits: np.ndarray, n_targets: int,
                algo: str = "viterbi") -> np.ndarray:
        """Tail E-values from each profile's calibration line: Gumbel for
        Viterbi (STATS LOCAL VITERBI), exponential for Forward (STATS
        LOCAL FORWARD) — both P = exp(-lambda (bits - tau)) in the tail."""
        ev = np.full_like(bits, np.nan, dtype=np.float64)
        for h, p in enumerate(self.profiles):
            stats = p.stats_fwd if algo == "forward" else p.stats_vit
            if stats:
                tau, lam = stats
                pv = np.exp(-lam * (bits[h].astype(np.float64) - tau))
                if algo == "forward":
                    pv = np.minimum(pv, 1.0)  # exponential survival caps at 1
                ev[h] = n_targets * pv
        return ev
