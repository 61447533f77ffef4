"""Backbone tree estimation (scenario C: backbone alignment given, tree
missing), counterpart of witch_tpu/tree_estimate.py.

The O(n^2 L) part, the identity counts over mutually ungapped canonical
positions, is two products of one-hot matrices on the device
(torch.matmul; the JAX package leaves the same product to XLA outside
any Pallas kernel, tree_estimate.py:39-45). The products run in float64,
so every count is an exact integer whatever the card's matmul precision
settings. The Jukes-Cantor correction then follows tree_estimate.py:49-56
exactly, on the counts as float32 (the JAX product's dtype), so the
distances equal the JAX package's bit for bit. Neighbour joining, the
Fitch NNI and the ML refinement are the JAX package's host code.

witch_tpu.tree_estimate.estimate_tree is not called: its distance step
tries JAX and quietly falls back to numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from witch_tpu.core.alignment import PackedAlignment
from witch_tpu.tree_estimate import ml_refine, neighbor_joining, nni_refine


def identity_counts(aln: PackedAlignment, device):
    """(matches [n, n], denom [n, n]) float64 host arrays: identical and
    mutually ungapped canonical positions per sequence pair, counted on
    `device`."""
    K = aln.alphabet.K
    codes = torch.as_tensor(aln.codes.astype(np.int64), device=device)
    canon = codes < K
    n, L = codes.shape
    onehot = torch.zeros((n, L, K), dtype=torch.float64, device=device)
    onehot.scatter_(2, codes.clamp(max=K - 1)[..., None],
                    canon[..., None].to(torch.float64))
    flat = onehot.reshape(n, L * K)
    maskf = canon.to(torch.float64)
    matches = torch.matmul(flat, flat.T)
    denom = torch.matmul(maskf, maskf.T)
    return matches.cpu().numpy(), denom.cpu().numpy()


def jc_distances(matches: np.ndarray, denom: np.ndarray, K: int
                 ) -> np.ndarray:
    """Jukes-Cantor distances from identity counts, the arithmetic of
    witch_tpu/tree_estimate.py:49-56 on float32 counts."""
    matches = matches.astype(np.float32)
    denom = denom.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = 1.0 - matches / np.maximum(denom, 1.0)
    p = np.clip(p, 0.0, 0.95 * (K - 1) / K)
    with np.errstate(divide="ignore"):
        d = -(K - 1) / K * np.log(1.0 - K / (K - 1) * p)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float64)


def pairwise_distances(aln: PackedAlignment, device) -> np.ndarray:
    """JC-corrected pairwise distances [n, n] (float64, host)."""
    matches, denom = identity_counts(aln, device)
    return jc_distances(matches, denom, aln.alphabet.K)


def estimate_tree(aln: PackedAlignment, out_path: Optional[str], device,
                  nni: bool = True, ml: bool = False, model: str = "hky",
                  log=None) -> str:
    """Newick of the backbone tree (witch_tpu/tree_estimate.py:867-894
    with the device distances); written to out_path when given."""
    nwk = neighbor_joining(pairwise_distances(aln, device), aln.names)
    if nni:
        try:
            nwk = nni_refine(nwk, aln, log=log)
        except Exception as e:   # noqa: BLE001 - the reference's contract
            if log:
                log("nni refinement skipped (%s)" % e)
    if ml:
        try:
            nwk = ml_refine(nwk, aln, max_sweeps=8, tune=False,
                            model=model, log=log)
        except Exception as e:   # noqa: BLE001 - the reference's contract
            if log:
                log("ml refinement skipped (%s)" % e)
    if out_path:
        with open(out_path, "w") as f:
            f.write(nwk + "\n")
    return nwk
