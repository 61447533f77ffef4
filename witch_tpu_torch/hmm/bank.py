"""Dense eHMM bank: the ensemble of profile HMMs as padded device arrays.

This is the TPU-native replacement for the reference's directory of .hmm
files (witch_msa/gcmm/algorithm.py decomposition outputs): all subset
profiles live in [H, M_max+1, ...] arrays, bucketed by state count so the
Forward/align kernels waste little padding compute.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .build import CoreHMM
from .profile import Profile, configure


@dataclasses.dataclass
class ProfileBank:
    """Padded, odds-domain profile parameters for a set of HMMs.

    All arrays are float32, natural-odds domain (probability ratios), laid
    out state-major for kernel consumption. Index 0 of the state axis is
    the virtual node 0; valid match states are 1..M_h.

    em_odds: [H, M_max+1, num_codes]  match emission odds e(k,x)/bg(x)
             (zero beyond M_h so padded states never gain mass)
    t_*:     [H, M_max+1]             transition probabilities
    bm:      [H, M_max+1]             entry probabilities B->M_k
    M:       [H]                      true state counts
    nseq:    [H]                      NSEQ per HMM (weighting sizes)
    """
    em_odds: np.ndarray
    t_mm: np.ndarray
    t_mi: np.ndarray
    t_md: np.ndarray
    t_im: np.ndarray
    t_ii: np.ndarray
    t_dm: np.ndarray
    t_dd: np.ndarray
    bm: np.ndarray
    M: np.ndarray
    nseq: np.ndarray
    hmm_indices: np.ndarray   # original ensemble indices of rows
    multihit: bool = True

    @property
    def H(self):
        return self.em_odds.shape[0]

    @property
    def M_max(self):
        return self.em_odds.shape[1] - 1


def _pad_pow2ish(m: int, minimum: int = 64) -> int:
    """Round up to the bucket boundary: power-of-two-ish sizes."""
    size = minimum
    while size < m:
        size *= 2
    return size


def bank_from_profiles(profiles: Sequence[Profile],
                       nseqs: Sequence[int],
                       indices: Sequence[int],
                       m_pad: int) -> ProfileBank:
    H = len(profiles)
    num_codes = profiles[0].msc.shape[1]
    em = np.zeros((H, m_pad + 1, num_codes), dtype=np.float32)
    t = {n: np.zeros((H, m_pad + 1), dtype=np.float32)
         for n in ("mm", "mi", "md", "im", "ii", "dm", "dd", "bm")}
    Ms = np.zeros(H, dtype=np.int32)
    for h, p in enumerate(profiles):
        M = p.M
        Ms[h] = M
        with np.errstate(over="ignore"):
            em[h, :M + 1] = np.exp(p.msc).astype(np.float32)
        em[h, 0] = 0.0
        for name, arr in (("mm", p.t_mm), ("mi", p.t_mi), ("md", p.t_md),
                          ("im", p.t_im), ("ii", p.t_ii), ("dm", p.t_dm),
                          ("dd", p.t_dd), ("bm", p.bm)):
            t[name][h, :M + 1] = np.exp(arr).astype(np.float32)
    return ProfileBank(
        em_odds=np.nan_to_num(em, posinf=0.0),
        t_mm=t["mm"], t_mi=t["mi"], t_md=t["md"], t_im=t["im"],
        t_ii=t["ii"], t_dm=t["dm"], t_dd=t["dd"], bm=t["bm"],
        M=Ms, nseq=np.asarray(nseqs, dtype=np.int32),
        hmm_indices=np.asarray(indices, dtype=np.int32),
        multihit=profiles[0].multihit if profiles else True)


def choose_bucket_edges(sizes, n_buckets: int = 2, align: int = 128):
    """Pick padded-size bucket boundaries minimizing total padded states."""
    import itertools
    sizes = sorted(sizes)
    cands = sorted({-(-m // align) * align for m in sizes})
    top = cands[-1]
    best = (None, float("inf"))
    for combo in itertools.combinations(cands[:-1], n_buckets - 1):
        edges = list(combo) + [top]
        tot = 0
        prev = 0
        for e in edges:
            n = sum(1 for m in sizes if prev < m <= e)
            tot += n * e
            prev = e
        if tot < best[1]:
            best = (edges, tot)
    return best[0] or [top]


def build_banks(cores: List[CoreHMM], indices: Sequence[int] = None,
                multihit: bool = True, min_bucket: int = 64,
                uniform: bool = False, n_buckets: int = 1
                ) -> List[ProfileBank]:
    """Configure profiles and group them into size buckets.

    Returns a list of ProfileBanks, one per M bucket, each padded to the
    bucket boundary. `indices` preserves ensemble numbering.

    uniform=True pads everything into ONE bank (a single kernel shape —
    preferred on TPU where compilation is far more expensive than the
    padding FLOPs it wastes).
    """
    if indices is None:
        indices = list(range(len(cores)))
    buckets = {}
    if uniform and cores:
        if n_buckets <= 1:
            mmax = max(core.M for core in cores)
            edges = [-(-mmax // 128) * 128]
        else:
            edges = choose_bucket_edges([c.M for c in cores], n_buckets)
        for idx, core in zip(indices, cores):
            for e in edges:
                if core.M <= e:
                    buckets.setdefault(e, []).append((idx, core))
                    break
    for idx, core in ([] if uniform else zip(indices, cores)):
        b = _pad_pow2ish(core.M, min_bucket)
        buckets.setdefault(b, []).append((idx, core))
    out = []
    for m_pad in sorted(buckets):
        group = buckets[m_pad]
        profiles = [configure(c, multihit=multihit) for _, c in group]
        nseqs = [c.nseq for _, c in group]
        idxs = [i for i, _ in group]
        out.append(bank_from_profiles(profiles, nseqs, idxs, m_pad))
    return out
