"""UPGMA guide-tree merges for the scenario-A backbone aligner
(backbone_consistency.py), copied from witch_tpu/backbone_progressive.py;
the port does not run that module's progressive aligner.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def upgma_merges(D: np.ndarray) -> List[Tuple[int, int]]:
    """UPGMA join order for a condensed-free [n, n] distance matrix.

    Returns n-1 (node_a, node_b) pairs; leaves are 0..n-1, the i-th
    merge creates node n+i. Average-linkage update, deterministic
    first-minimum tie-breaking.
    """
    n = D.shape[0]
    if n == 1:
        return []
    W = D.astype(np.float64).copy()
    np.fill_diagonal(W, np.inf)
    ids = np.arange(n)
    sizes = np.ones(n)
    merges = []
    m = n
    nxt = n
    for _ in range(n - 1):
        k = int(np.argmin(W[:m, :m]))
        i, j = divmod(k, m)
        if i > j:
            i, j = j, i
        merges.append((int(ids[i]), int(ids[j])))
        si, sj = sizes[i], sizes[j]
        newrow = (si * W[i, :m] + sj * W[j, :m]) / (si + sj)
        W[i, :m] = newrow
        W[:m, i] = newrow
        W[i, i] = np.inf
        ids[i] = nxt
        sizes[i] = si + sj
        nxt += 1
        # swap the last active slot into j
        last = m - 1
        if j != last:
            W[j, :m] = W[last, :m]
            W[:m, j] = W[:m, last]
            W[j, j] = np.inf
            ids[j] = ids[last]
            sizes[j] = sizes[last]
        m -= 1
    return merges
