"""Dirichlet priors for profile-HMM parameter estimation.

Constants were established empirically by probing the reference's bundled
HMMER 3.1b2 hmmbuild with controlled alignments (see docs/CALIBRATION.md);
estimation matches the binary's text output to < 5e-6 in ln-probability.
"""

from __future__ import annotations

import dataclasses
import numpy as np
from scipy.special import gammaln


@dataclasses.dataclass(frozen=True)
class MixtureDirichlet:
    q: np.ndarray       # [K] mixture coefficients
    alpha: np.ndarray   # [K, D] component pseudocounts

    def posterior_mean(self, counts: np.ndarray) -> np.ndarray:
        """Mixture posterior-predictive mean estimate.

        counts: [..., D] observed (weighted) counts.
        Returns [..., D] probability estimates.
        """
        c = np.asarray(counts, dtype=np.float64)
        a = self.alpha                               # [K, D]
        asum = a.sum(axis=1)                         # [K]
        n = c.sum(axis=-1)                           # [...]
        # log marginal likelihood of each component
        lw = (np.log(self.q)
              + gammaln(asum)
              - gammaln(n[..., None] + asum)
              + (gammaln(c[..., None, :] + a)
                 - gammaln(a)).sum(axis=-1))         # [..., K]
        lw = lw - lw.max(axis=-1, keepdims=True)
        w = np.exp(lw)
        w /= w.sum(axis=-1, keepdims=True)
        comp_mean = (c[..., None, :] + a) / (n[..., None, None] + asum[:, None])
        return (w[..., None] * comp_mean).sum(axis=-2)


@dataclasses.dataclass(frozen=True)
class TransitionPrior:
    tm: np.ndarray  # alphas for (MM, MI, MD)
    ti: np.ndarray  # alphas for (IM, II)
    td: np.ndarray  # alphas for (DM, DD)


# Nucleic (DNA/RNA) priors — HMMER 3.1b2 equivalents, empirically verified.
NUCLEIC_TRANSITION_PRIOR = TransitionPrior(
    tm=np.array([2.0, 0.1, 0.1]),
    ti=np.array([0.06, 0.2]),
    td=np.array([0.1, 0.2]),
)

NUCLEIC_EMISSION_PRIOR = MixtureDirichlet(
    q=np.array([0.24, 0.26, 0.08, 0.42]),
    alpha=np.array([
        [0.16, 0.45, 0.12, 0.39],
        [0.09, 0.03, 0.09, 0.04],
        [1.29, 0.40, 6.58, 0.51],
        [1.74, 1.49, 1.57, 1.95],
    ]),
)

# Amino acid transition prior — verified exactly against the bundled
# hmmbuild on probe alignments (max err < 4e-6, tests).
AMINO_TRANSITION_PRIOR = TransitionPrior(
    tm=np.array([0.7939, 0.0278, 0.0135]),
    ti=np.array([0.1551, 0.1331]),
    td=np.array([0.9002, 0.5630]),
)

# Amino acid match-emission prior: the 9-component Blocks9 mixture
# Dirichlet, EXACT f64 values read from the bundled hmmbuild binary's
# .rodata (round 5; previously an empirical fit accurate to ~5e-5 in
# emission probability, which left 185/9500 amino grid scores off by
# one 0.1-bit print rounding). Component order matches the binary's
# (esl_mixdchlet order), so posterior sums round identically.
AMINO_EMISSION_PRIOR = MixtureDirichlet(
    q=np.array([0.178091, 0.056591, 0.0960191,
                0.0781233, 0.0834977, 0.0904123,
                0.114468, 0.0682132, 0.234585]),
    alpha=np.array([
        [0.270671, 0.039848, 0.017576,
         0.016415, 0.014268, 0.131916,
         0.012391, 0.022599, 0.020358,
         0.030727, 0.015315, 0.048298,
         0.053803, 0.020662, 0.023612,
         0.216147, 0.147226, 0.065438,
         0.003758, 0.009621],
        [0.021465, 0.0103, 0.011741,
         0.010883, 0.385651, 0.016416,
         0.076196, 0.035329, 0.013921,
         0.093517, 0.022034, 0.028593,
         0.013086, 0.023011, 0.018866,
         0.029156, 0.018153, 0.0361,
         0.07177, 0.419641],
        [0.561459, 0.045448, 0.438366,
         0.764167, 0.087364, 0.259114,
         0.21494, 0.145928, 0.762204,
         0.24732, 0.118662, 0.441564,
         0.174822, 0.53084, 0.465529,
         0.583402, 0.445586, 0.22705,
         0.02951, 0.12109],
        [0.070143, 0.01114, 0.019479,
         0.094657, 0.013162, 0.048038,
         0.077, 0.032939, 0.576639,
         0.072293, 0.02824, 0.080372,
         0.037661, 0.185037, 0.506783,
         0.073732, 0.071587, 0.042532,
         0.011254, 0.028723],
        [0.041103, 0.014794, 0.00561,
         0.010216, 0.153602, 0.007797,
         0.007175, 0.299635, 0.010849,
         0.999446, 0.210189, 0.006127,
         0.013021, 0.019798, 0.014509,
         0.012049, 0.035799, 0.180085,
         0.012744, 0.026466],
        [0.115607, 0.037381, 0.012414,
         0.018179, 0.051778, 0.017255,
         0.004911, 0.796882, 0.017074,
         0.285858, 0.075811, 0.014548,
         0.015092, 0.011382, 0.012696,
         0.027535, 0.088333, 0.94434,
         0.004373, 0.016741],
        [0.093461, 0.004737, 0.387252,
         0.347841, 0.010822, 0.105877,
         0.049776, 0.014963, 0.094276,
         0.027761, 0.01004, 0.187869,
         0.050018, 0.110039, 0.038668,
         0.119471, 0.065802, 0.02543,
         0.003215, 0.018742],
        [0.452171, 0.114613, 0.06246,
         0.115702, 0.284246, 0.140204,
         0.100358, 0.55023, 0.143995,
         0.700649, 0.27658, 0.118569,
         0.09747, 0.126673, 0.143634,
         0.278983, 0.358482, 0.66175,
         0.061533, 0.199373],
        [0.005193, 0.004039, 0.006722,
         0.006121, 0.003468, 0.016931,
         0.003647, 0.002184, 0.005019,
         0.00599, 0.001473, 0.004158,
         0.009055, 0.00363, 0.006583,
         0.003172, 0.00369, 0.002967,
         0.002772, 0.002686],
    ]))

# Amino insert-emission distribution: EXACT per-residue values whose
# -log matches the bundled hmmbuild's printed insert rows verbatim
# (WITCH always builds with --symfrac 0.0 on gap-cleaned alignments,
# so insert states carry zero counts and every insert row is this
# constant prior-mean distribution; round 5, replaces an empirical
# extraction that flipped ~half the printed 5-decimal fields).
AMINO_INSERT_EMISSIONS = np.array([
    0.06814074046432166, 0.012007185700900223, 0.06233763141443918, 0.0651391192567462,
    0.03131869736125058, 0.09025376185806538, 0.02411454725624692, 0.03712220391932464,
    0.06874096288644911, 0.06764038926605698, 0.014308521644640306, 0.05483262036452619,
    0.06473909561985355, 0.04152498436512532, 0.055132825285351635, 0.09265521877410929,
    0.06233763141443918, 0.050530407257186674, 0.010206096920109882, 0.026916117721584094])

# Amino scoring/entropy background (p7_AminoFrequencies) — verified: the
# entropy-weighting bisection reproduces hmmbuild's printed EFFN exactly
# with this vector.
AMINO_BACKGROUND = np.array([
    0.0787945, 0.0151600, 0.0535222, 0.0668298, 0.0397062, 0.0695071,
    0.0229198, 0.0590092, 0.0594422, 0.0963728, 0.0237718, 0.0414386,
    0.0482904, 0.0395639, 0.0540978, 0.0683364, 0.0540687, 0.0673417,
    0.0114135, 0.0304133])



def uniform_background(K: int) -> np.ndarray:
    return np.full(K, 1.0 / K)


def get_background(molecule: str) -> np.ndarray:
    if molecule in ("dna", "rna"):
        return uniform_background(4)
    return AMINO_BACKGROUND / AMINO_BACKGROUND.sum()


def get_insert_emissions(molecule: str) -> np.ndarray:
    if molecule in ("dna", "rna"):
        return uniform_background(4)
    return AMINO_INSERT_EMISSIONS / AMINO_INSERT_EMISSIONS.sum()


def get_emission_prior(molecule: str) -> MixtureDirichlet:
    if molecule in ("dna", "rna"):
        return NUCLEIC_EMISSION_PRIOR
    return AMINO_EMISSION_PRIOR


def get_transition_prior(molecule: str) -> TransitionPrior:
    if molecule in ("dna", "rna"):
        return NUCLEIC_TRANSITION_PRIOR
    return AMINO_TRANSITION_PRIOR
