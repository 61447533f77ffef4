"""Search-profile configuration: core HMM -> scoring parameters.

Implements the Plan7 implicit probabilistic model the reference exercises
through `hmmsearch --max` (multihit local) and `hmmalign`: occupancy-based
local entry, unit exits, N/C/J length model, log-odds emissions vs a uniform
background. Conventions calibrated against the bundled HMMER 3.1b2 binaries
(reported bit scores match to the printed 0.1-bit precision).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.alphabet import ALPHABETS
from .build import CoreHMM, TMM, TMI, TMD, TIM, TII, TDM, TDD


@dataclasses.dataclass
class Profile:
    """Log-space scoring profile (natural log).

    msc: [M+1, num_codes]  match emission log-odds (row 0 = -inf)
    isc: [M+1, num_codes]  insert emission log-odds (H3 hardwires to 0)
    tsc_*: [M+1] per-node transition log-probs out of node k
    bm:  [M+1]  B -> M_k entry log-probs (index 1..M)
    multihit: E->J allowed with p=0.5
    """
    msc: np.ndarray
    isc: np.ndarray
    t_mm: np.ndarray
    t_mi: np.ndarray
    t_md: np.ndarray
    t_im: np.ndarray
    t_ii: np.ndarray
    t_dm: np.ndarray
    t_dd: np.ndarray
    bm: np.ndarray
    multihit: bool
    M: int
    molecule: str

    def length_model(self, L: int):
        """(loop, move) log-probs of the N/C/J states for target length L."""
        nj = 1.0 if self.multihit else 0.0
        pmove = (2.0 + nj) / (L + 2.0 + nj)
        return np.log(1.0 - pmove), np.log(pmove)

    @property
    def xsc_e_loop(self):
        return np.log(0.5) if self.multihit else -np.inf

    @property
    def xsc_e_move(self):
        return np.log(0.5) if self.multihit else 0.0


def null1_score(L: int) -> float:
    """HMMER null1 (nats): L*log(p1) + log(1-p1), p1 = L/(L+1)."""
    p1 = L / (L + 1.0)
    return L * np.log(p1) + np.log(1.0 - p1)


def occupancy(core: CoreHMM) -> np.ndarray:
    """Match-state occupancy occ[1..M] (p7_hmm_CalculateOccupancy)."""
    M = core.M
    t = core.trans
    occ = np.zeros(M + 1)
    occ[1] = t[0, TMI] + t[0, TMM]
    for k in range(2, M + 1):
        occ[k] = (occ[k - 1] * (t[k - 1, TMM] + t[k - 1, TMI])
                  + (1.0 - occ[k - 1]) * t[k - 1, TDM])
    return occ


def configure(core: CoreHMM, multihit: bool = True) -> Profile:
    """Local-mode profile (hmmsearch default 'fs' = multihit local;
    unihit local 'sw' via multihit=False).

    Memoized per core object: the pipeline configures each ensemble
    model from three sites per run (bank build, gate prep, exact-f32
    overlay); the profile is immutable, so cache it on the core."""
    cache = getattr(core, "_prof_cache", None)
    if cache is not None and multihit in cache:
        return cache[multihit]
    M, K = core.M, core.K
    alphabet = ALPHABETS[core.molecule]
    from .priors import get_background
    bg = get_background(core.molecule)

    with np.errstate(divide="ignore"):
        # canonical log-odds emission scores
        lodds = np.log(core.match_emissions / bg[None, :])   # [M+1, K]
    lodds[0] = -np.inf
    # degenerate residue scores: expected score over members weighted by
    # background (esl_abc_FExpectScVec semantics — average of SCORES)
    expand = alphabet.expansion_matrix()              # [codes, K]
    num_codes = expand.shape[0]
    msc = np.full((M + 1, num_codes), -np.inf)
    msc[:, :K] = lodds
    gap = alphabet.gap_code
    for c in range(K + 1, num_codes):
        members = expand[c] > 0
        w = bg[members] / bg[members].sum()
        msc[1:, c] = lodds[1:, members] @ w

    isc = np.zeros((M + 1, num_codes))                # H3: insert scores = 0
    isc[:, gap] = -np.inf
    isc[0] = -np.inf
    isc[M] = -np.inf                                  # no I_M state

    t = core.trans
    with np.errstate(divide="ignore"):
        t_mm = np.log(t[:, TMM])
        t_mi = np.log(t[:, TMI])
        t_md = np.log(t[:, TMD])
        t_im = np.log(t[:, TIM])
        t_ii = np.log(t[:, TII])
        t_dm = np.log(t[:, TDM])
        t_dd = np.log(t[:, TDD])
        # entry distribution
        occ = occupancy(core)
        Z = (occ[1:] * (M - np.arange(1, M + 1) + 1)).sum()
        bm = np.full(M + 1, -np.inf)
        bm[1:] = np.log(occ[1:] / Z)
    # no transitions into/out of nonexistent I_M
    t_mi[M] = -np.inf
    t_im[M] = -np.inf
    t_ii[M] = -np.inf

    prof = Profile(msc=msc, isc=isc, t_mm=t_mm, t_mi=t_mi, t_md=t_md,
                   t_im=t_im, t_ii=t_ii, t_dm=t_dm, t_dd=t_dd, bm=bm,
                   multihit=multihit, M=M, molecule=core.molecule)
    if cache is None:
        try:
            core._prof_cache = cache = {}
        except AttributeError:       # frozen/slotted core
            cache = None
    if cache is not None:
        cache[multihit] = prof
    return prof
