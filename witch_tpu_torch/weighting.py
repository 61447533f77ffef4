"""Adjusted-bitscore weighting — the WITCH core formula.

Re-implements calculateWeights (witch_msa/gcmm/weighting.py:58-74):
  w_i = 1 / sum_j 2^{(b_j - b_i) + log2(s_j / s_i)}
i.e. a base-2 softmax over adjusted bitscores b_i + log2(s_i). Keeps the
top min(k, n) weights sorted descending (stable ties by ranked order), plus
the adaptive inclusion prefix used by the aligner (aligner.py:52-63):
take weights until the cumulative sum reaches 0.999 (or k exhausted).

Also the weights.txt interop format (writeWeightsToLocal /
readWeightsFromLocal, weighting.py:174-194).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Tuple

import numpy as np

ADAPTIVE_TARGET = 0.999


def calculate_weights(indexes: Sequence[int], bitscores: Sequence[float],
                      sizes: Sequence[int], num_hmms: int
                      ) -> Tuple[Tuple[int, float], ...]:
    """Weights for one query, sorted descending, truncated to num_hmms.

    indexes/bitscores are in ranked (descending bitscore) order; ties keep
    that order (Python sorted is stable), matching the reference.
    """
    b = np.asarray(bitscores, dtype=np.float64)
    s = np.asarray(sizes, dtype=np.float64)
    if b.size == 0:
        return tuple()
    if b.size > 256:
        # O(n) softmax form for ensembles beyond oracle scale: the
        # reference's pairwise expression is O(n^2) per query (measured
        # 26 min for 10k queries x 2785 candidates); mathematically
        # w_i = 2^{a_i} / sum_j 2^{a_j} with a = b + log2(s), and at
        # this scale there is no printed-oracle bit-parity to preserve
        a = b + np.log2(s)
        a -= a.max()
        e = np.exp2(a)
        wv = e / e.sum()
        weights = {indexes[i]: wv[i] for i in range(len(b))}
        num_to_retain = min(num_hmms, len(weights))
        ranked = sorted(weights.items(), key=lambda x: x[1],
                        reverse=True)
        return tuple((int(i), float(w))
                     for i, w in ranked[:num_to_retain])
    # vectorized over i with the reference's exact per-i expression:
    # exponents[i, j] = (b[j] - b[i]) + log2(s[j] / s[i]); each row sums
    # in j order (n < 128 keeps numpy's sum sequential), so every float
    # op and its order match the scalar loop bit-for-bit
    exponents = (b[None, :] - b[:, None]) + np.log2(s[None, :]
                                                    / s[:, None])
    wv = 1.0 / np.power(2.0, exponents).sum(axis=1)
    weights = {indexes[i]: wv[i] for i in range(len(b))}
    num_to_retain = min(num_hmms, len(weights))
    ranked = sorted(weights.items(), key=lambda x: x[1], reverse=True)
    return tuple((int(i), float(w)) for i, w in ranked[:num_to_retain])


def adaptive_top_hmms(sorted_weights: Sequence[Tuple[int, float]],
                      use_weight: bool = True,
                      target: float = ADAPTIVE_TARGET
                      ) -> List[Tuple[int, float]]:
    """Adaptive prefix: include HMMs until cumulative weight >= target."""
    if not use_weight:
        return [(ind, 1) for ind, _ in sorted_weights]
    cur = 0.0
    idx = 0
    while idx < len(sorted_weights) and cur < target:
        cur += sorted_weights[idx][1]
        idx += 1
    return [(ind, float(w)) for ind, w in sorted_weights[:idx]]


def write_weights(taxon_to_weights: Dict[str, tuple], path: str):
    with open(path, "w") as f:
        for taxon, weights in taxon_to_weights.items():
            f.write("{}:{}\n".format(taxon, weights))


def read_weights(path: str) -> Dict[str, tuple]:
    out = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            taxon, raw = line.split(":", 1)
            out[taxon] = ast.literal_eval(raw.strip())
    return out
