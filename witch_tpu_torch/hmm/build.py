"""Profile-HMM construction from a (sub)alignment — hmmbuild equivalent.

Replaces the reference's `hmmbuild --symfrac 0.0 --ere 0.59 --{dna,rna,amino}`
subprocess (witch_msa/gcmm/algorithm.py:461-470). With symfrac 0 every column
of the (all-gap-column-free) subalignment is a match state, so the profile
has exactly M = n_cols match nodes and inserts carry pure prior parameters.

Numerics follow HMMER 3.1b2 semantics (empirically calibrated; see
docs/CALIBRATION.md): Henikoff position-based weights, fragment marking,
entropy weighting to an adaptive target, mixture-Dirichlet emission priors,
single-Dirichlet transition priors.

Everything here is float64 numpy — this runs once per subset and its output
is quantized to the text-format precision that the downstream scoring
kernels consume, mirroring how HMMER tools re-read rounded model files.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.alphabet import Alphabet
from .priors import (MixtureDirichlet, TransitionPrior, get_background,
                     get_emission_prior, get_insert_emissions,
                     get_transition_prior, uniform_background)

# transition column order, matching the HMM text format row
TMM, TMI, TMD, TIM, TII, TDM, TDD = range(7)


@dataclasses.dataclass
class CoreHMM:
    """Core (non-configured) profile HMM probabilities.

    match_emissions:  [M+1, K]  (row 0 unused)
    insert_emissions: [M+1, K]  (row 0 = I0)
    trans:            [M+1, 7]  row k = transitions out of node k
                      (row 0: B->M1 / B->I0 / B->D1 in the MM/MI/MD slots)
    """
    match_emissions: np.ndarray
    insert_emissions: np.ndarray
    trans: np.ndarray
    nseq: int
    effn: float
    molecule: str
    name: str = ""
    map_to_columns: Optional[np.ndarray] = None  # retained-column map (MAP)
    consensus: Optional[str] = None

    @property
    def M(self) -> int:
        return self.match_emissions.shape[0] - 1

    @property
    def K(self) -> int:
        return self.match_emissions.shape[1]


def pb_weights_fast(codes: np.ndarray, K: int) -> np.ndarray:
    """Vectorized PB weights.

    Empirically calibrated against the bundled hmmbuild (3.1b2) default
    weighting: per-cell Henikoff contributions 1/(r * ct[x]) over canonical
    residues, each sequence's sum divided by its canonical-residue count,
    then normalized to sum to nseq.
    """
    n, L = codes.shape
    canon = np.where(codes < K, codes.astype(np.int64), -1)
    onehot = np.zeros((n, L, K), dtype=np.float64)
    idx = canon >= 0
    onehot[np.nonzero(idx)[0], np.nonzero(idx)[1], canon[idx]] = 1.0
    cnt = onehot.sum(axis=0)                    # [L, K]
    r = (cnt > 0).sum(axis=1)                   # [L]
    denom = cnt * r[:, None]
    inv = np.zeros_like(cnt)
    np.divide(1.0, denom, out=inv, where=denom > 0)
    w = np.einsum("nlk,lk->n", onehot, inv)
    nres = idx.sum(axis=1).astype(np.float64)
    w = np.divide(w, nres, out=np.ones(n), where=nres > 0)
    if w.sum() == 0:
        return np.ones(n)
    return w * (n / w.sum())


def collect_counts(codes: np.ndarray, alphabet: Alphabet,
                   weights: np.ndarray, fragthresh: float = 0.5):
    """Weighted emission/transition counts from an all-match alignment.

    codes: [n, M] (no all-gap columns). Returns (emission counts [M+1,K],
    transition counts [M+1,7]).

    Fragment rule (hmmbuild --fragthresh, calibrated vs 3.1b2): a row whose
    residue *span* (first..last residue) fraction of the alignment length is
    < fragthresh is a fragment; its leading/trailing gaps are outside the
    trace (no B->D1 chain / no D->E chain counted).
    """
    n, M = codes.shape
    K = alphabet.K
    expand = alphabet.expansion_matrix()        # [codes, K]
    res = codes != alphabet.gap_code            # [n, M] residue present

    ecounts = np.zeros((M + 1, K))
    frac = expand[codes]                        # [n, M, K]
    ecounts[1:] = np.einsum("n,nmk->mk", weights, frac)

    tcounts = np.zeros((M + 1, 7))

    # span per sequence
    first = np.argmax(res, axis=1)
    last = M - 1 - np.argmax(res[:, ::-1], axis=1)
    rlen = res.sum(axis=1)
    has_res = rlen > 0
    # HMMER 3.1 fragment rule: residue span fraction < fragthresh
    is_frag = ((last - first + 1) / M) < fragthresh

    for i in range(n):
        if not has_res[i]:
            continue
        w = weights[i]
        s, e = (first[i], last[i]) if is_frag[i] else (0, M - 1)
        states = res[i]  # True = M, False = D
        # B -> first state (node "0" row); fragments contribute no B-> count
        if not is_frag[i]:
            tcounts[0, TMM if states[s] else TMD] += w
        for k in range(s, e):
            a, b = states[k], states[k + 1]
            if a and b:
                tcounts[k + 1, TMM] += w
            elif a and not b:
                tcounts[k + 1, TMD] += w
            elif not a and b:
                tcounts[k + 1, TDM] += w
            else:
                tcounts[k + 1, TDD] += w
        # last state -> E: M->E counted as MM on the last node; D->E forced.
        # Fragments contribute no ->E count.
        if states[e] and not is_frag[i]:
            tcounts[e + 1, TMM] += w
    return ecounts, tcounts


def collect_counts_fast(codes: np.ndarray, alphabet: Alphabet,
                        weights: np.ndarray, fragthresh: float = 0.5):
    """Vectorized transition counting (same semantics as collect_counts)."""
    n, M = codes.shape
    K = alphabet.K
    expand = alphabet.expansion_matrix()
    res = codes != alphabet.gap_code

    ecounts = np.zeros((M + 1, K))
    frac = expand[codes]
    ecounts[1:] = np.einsum("n,nmk->mk", weights, frac)

    tcounts = np.zeros((M + 1, 7))
    first = np.argmax(res, axis=1)
    last = M - 1 - np.argmax(res[:, ::-1], axis=1)
    rlen = res.sum(axis=1)
    has_res = rlen > 0
    is_frag = ((last - first + 1) / M) < fragthresh
    s = np.where(is_frag, first, 0)
    e = np.where(is_frag, last, M - 1)

    w = weights * has_res
    # B -> first in-span state (fragments excluded: no B->/->E counts)
    wful = w * ~is_frag
    state_at_s = res[np.arange(n), s]
    np.add.at(tcounts, (0, TMM), (wful * state_at_s).sum())
    np.add.at(tcounts, (0, TMD), (wful * ~state_at_s).sum())
    # pairwise transitions between nodes k and k+1 for k in [s, e)
    pos = np.arange(M - 1)[None, :]                    # node k index (0-based)
    inspan = (pos >= s[:, None]) & (pos < e[:, None]) & has_res[:, None]
    a = res[:, :-1]
    b = res[:, 1:]
    wv = w[:, None] * inspan
    node = np.arange(1, M)
    tcounts[node, TMM] += (wv * (a & b)).sum(axis=0)
    tcounts[node, TMD] += (wv * (a & ~b)).sum(axis=0)
    tcounts[node, TDM] += (wv * (~a & b)).sum(axis=0)
    tcounts[node, TDD] += (wv * (~a & ~b)).sum(axis=0)
    # last state -> E (fragments excluded)
    state_at_e = res[np.arange(n), e]
    np.add.at(tcounts, (e + 1, TMM), wful * state_at_e)
    return ecounts, tcounts


def estimate_parameters(ecounts: np.ndarray, tcounts: np.ndarray,
                        eprior: MixtureDirichlet, tprior: TransitionPrior,
                        K: int, ins_em: np.ndarray = None) -> CoreHMM:
    """Posterior-mean parameter estimation from (possibly scaled) counts."""
    M = ecounts.shape[0] - 1
    mat = np.zeros((M + 1, K))
    mat[1:] = eprior.posterior_mean(ecounts[1:])
    if ins_em is None:
        ins_em = uniform_background(K)
    ins = np.tile(ins_em, (M + 1, 1))

    trans = np.zeros((M + 1, 7))
    # match transitions, nodes 0..M-1 (node M handled specially)
    tm = tcounts[:M, [TMM, TMI, TMD]] + tprior.tm
    trans[:M, [TMM, TMI, TMD]] = tm / tm.sum(axis=1, keepdims=True)
    # last node: no MD; renormalize over (MM, MI)
    tmL = tcounts[M, [TMM, TMI]] + tprior.tm[:2]
    trans[M, TMM], trans[M, TMI] = tmL / tmL.sum()
    trans[M, TMD] = 0.0
    # insert transitions: all nodes
    ti = tcounts[:, [TIM, TII]] + tprior.ti
    trans[:, [TIM, TII]] = ti / ti.sum(axis=1, keepdims=True)
    # delete transitions, nodes 1..M-1; node 0 and node M forced
    td = tcounts[1:M, [TDM, TDD]] + tprior.td
    trans[1:M, [TDM, TDD]] = td / td.sum(axis=1, keepdims=True)
    trans[0, TDM], trans[0, TDD] = 1.0, 0.0
    trans[M, TDM], trans[M, TDD] = 1.0, 0.0
    return mat, ins, trans


def mean_match_relative_entropy(mat: np.ndarray, bg: np.ndarray) -> float:
    """(1/M) sum_k sum_x p log2(p / f) over match states (rows 1..M)."""
    p = mat[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = p * (np.log2(p) - np.log2(bg[None, :]))
    return float(np.nan_to_num(terms).sum() / p.shape[0])


def entropy_target(M: int, ere: float, esigma: float = 45.0) -> float:
    """HMMER adaptive relative-entropy target (verified empirically)."""
    from_sigma = (esigma - np.log2(2.0 / (M * (M + 1)))) / M
    return max(ere, from_sigma)


def entropy_weight(ecounts: np.ndarray, tcounts: np.ndarray, nseq: int,
                   etarget: float, eprior: MixtureDirichlet, K: int,
                   tol: float = 1e-3, max_iter: int = 100,
                   bg: np.ndarray = None) -> float:
    """Find neff such that MRE(counts * neff/nseq) == etarget (bisection).

    Returns nseq when the target is already met at full counts.
    """
    if bg is None:
        bg = uniform_background(K)

    def mre_at(neff: float) -> float:
        scale = neff / nseq
        mat = eprior.posterior_mean(ecounts[1:] * scale)
        full = np.vstack([np.zeros((1, K)), mat])
        return mean_match_relative_entropy(full, bg)

    fb = mre_at(nseq) - etarget
    if fb <= 0:
        return float(nseq)
    # esl_root_Bisection semantics (calibrated against hmmbuild's printed
    # EFFN to 6 decimals): midpoint bisection on [0, nseq] with absolute
    # x-tolerance 0.01, convergence tested *before* the bracket update.
    lo, hi = 0.0, float(nseq)
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        f = mre_at(mid) - etarget
        if f == 0.0 or (hi - lo) < 0.01:
            return mid
        if f > 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


@dataclasses.dataclass
class Counts:
    """A model's build up to the entropy weighting (hmm_counts): its
    weighted counts, its sequence count and its relative-entropy target
    (None: no entropy weighting)."""
    ecounts: np.ndarray      # [M+1, K]
    tcounts: np.ndarray      # [M+1, 7]
    nseq: int
    etarget: Optional[float]


def hmm_counts(codes: np.ndarray, alphabet: Alphabet, ere: float = 0.59,
               esigma: float = 45.0, fragthresh: float = 0.5,
               use_eent: bool = True) -> Counts:
    """build_hmm's first half: PB weights, weighted counts, the entropy
    target."""
    n, M = codes.shape
    weights = pb_weights_fast(codes, alphabet.K)
    ecounts, tcounts = collect_counts_fast(codes, alphabet, weights,
                                           fragthresh)
    etarget = entropy_target(M, ere, esigma) if use_eent else None
    return Counts(ecounts, tcounts, n, etarget)


def hmm_effn(c: Counts, molecule: str) -> float:
    """The host's entropy weighting of c (entropy_weight); nseq without
    a target."""
    if c.etarget is None:
        return float(c.nseq)
    return entropy_weight(c.ecounts, c.tcounts, c.nseq, c.etarget,
                          get_emission_prior(molecule), c.ecounts.shape[1],
                          bg=get_background(molecule))


def hmm_from_counts(c: Counts, effn: float, alphabet: Alphabet,
                    molecule: str, name: str = "",
                    map_to_columns: Optional[np.ndarray] = None) -> CoreHMM:
    """build_hmm's second half: the counts scaled to effn, parameter
    estimation, the consensus."""
    K = alphabet.K
    ecounts, tcounts = c.ecounts, c.tcounts
    if c.etarget is not None:
        scale = effn / c.nseq
        ecounts = ecounts * scale
        tcounts = tcounts * scale
    eprior = get_emission_prior(molecule)
    tprior = get_transition_prior(molecule)
    mat, ins, trans = estimate_parameters(
        ecounts, tcounts, eprior, tprior, K,
        ins_em=get_insert_emissions(molecule))

    # consensus letters: strongest residue; uppercase if p > 0.5
    # (HMMER uses >= 0.5 for single-letter alphabets? calibrated in tests)
    letters = np.array(list(alphabet.canonical))
    best = mat[1:].argmax(axis=1)
    cons = "".join(
        letters[b].upper() if mat[k + 1, b] > 0.5 else letters[b].lower()
        for k, b in enumerate(best))

    return CoreHMM(match_emissions=mat, insert_emissions=ins, trans=trans,
                   nseq=c.nseq, effn=effn, molecule=molecule, name=name,
                   map_to_columns=map_to_columns, consensus=cons)


def build_hmm(codes: np.ndarray, alphabet: Alphabet, molecule: str,
              ere: float = 0.59, esigma: float = 45.0,
              fragthresh: float = 0.5, name: str = "",
              map_to_columns: Optional[np.ndarray] = None,
              use_eent: bool = True) -> CoreHMM:
    """Build a core profile HMM from an aligned code matrix [n, M]:
    hmm_counts, the host's entropy weighting, hmm_from_counts.

    The matrix must already be free of all-gap columns (the reference
    guarantees this via delete_all_gaps before hmmbuild).
    """
    c = hmm_counts(codes, alphabet, ere, esigma, fragthresh, use_eent)
    return hmm_from_counts(c, hmm_effn(c, molecule), alphabet, molecule,
                           name, map_to_columns)


def quantize_like_text(hmm: CoreHMM) -> CoreHMM:
    """Round all probabilities through the text representation (-ln p at 5
    decimals), mirroring the write-then-read path the reference takes
    through .hmm files. Downstream scoring uses these rounded values so
    bitscores agree with the binaries'."""
    def q(p):
        with np.errstate(divide="ignore"):
            lnp = -np.log(p)
        lnp = np.round(lnp, 5)
        out = np.exp(-lnp)
        return np.where(p == 0.0, 0.0, out)

    return dataclasses.replace(
        hmm,
        match_emissions=q(hmm.match_emissions),
        insert_emissions=q(hmm.insert_emissions),
        trans=q(hmm.trans),
    )
