"""Full-grid reporting-gate prefilter on the GPU (--full-search-results).

Counterpart of witch_tpu/hmm/flank_device.py:prefilter_grid. The flank
posterior rows of every (query, model) pair come from the flank kernel
(ops/flank.py), one query chunk of bounded size at a time (the JAX
module scans fixed chunks of 128 queries), and stay on the device; the
vectorised short-circuit (no row with mocc >= RT1 means no region)
runs there too, so only the rows of pairs that may have a region are
copied to the host, where the
region scan classifies them three ways: -1 not reported, +1 reported
(a single-envelope region), 0 pending (the native trace ensemble
decides). The JAX module keeps the rows as a host [Q, H, Lmax + 1] x 3
array instead (~3.4 GB for a 1,000 x 285 grid).

RT1/RT2/RT3, find_regions_rows and gate_prefilter are copied from the
JAX module (flank_device.py:41-43, :268-337), which imports JAX at its
top.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.flank import flank_rows

RT1 = 0.25
RT2 = 0.10
RT3 = 0.20

CHUNK_BYTES = 1 << 30        # device bytes of one query chunk's rows
# per (query, model, row) cell: ppB ppE mocc (f32), the kernel's five
# stored Forward specials (f32), the mocc >= RT1 mask, the kept copy
BYTES_PER_CELL = 3 * 4 + 5 * 4 + 1 + 3 * 4


def find_regions_rows(mocc: np.ndarray, ppB: np.ndarray,
                      ppE: np.ndarray, L: int
                      ) -> List[Tuple[int, int]]:
    """p7_domaindef region scan on one pair's rows (host semantics
    identical to witch_tpu/hmm/domaindef.py:find_regions)."""
    dB = np.zeros(L + 1)
    dB[1:] = ppB[:L]
    dE = np.zeros(L + 1)
    dE[1:] = ppE[1:L + 1]
    regions = []
    i2 = -1
    triggered = False
    for i in range(1, L + 1):
        if not triggered:
            if mocc[i] - dB[i] < RT2:
                i2 = i
            elif i2 == -1:
                i2 = i
            if mocc[i] >= RT1:
                triggered = True
        else:
            if mocc[i] - dE[i] < RT2:
                regions.append((max(i2, 1), i))
                i2 = -1
                triggered = False
    if triggered:
        regions.append((max(i2, 1), L))
    return regions


def gate_prefilter(mocc: np.ndarray, ppB: np.ndarray, ppE: np.ndarray,
                   qlens: np.ndarray):
    """Three-way gate decision from batched rows [N, Lmax + 1], qlens
    [N]. Returns (decision [N] int8, pending regions per pair): -1 not
    reported (no region), +1 reported (some region is deterministically
    a single envelope), 0 pending (its multidomain regions are listed)."""
    N, Lp1 = mocc.shape
    decision = np.full(N, -1, np.int8)
    pending: List[List[Tuple[int, int]]] = [[] for _ in range(N)]
    may = np.flatnonzero((mocc >= RT1).any(axis=1))
    for k in may:
        L = int(qlens[k])
        regions = find_regions_rows(mocc[k], ppB[k], ppE[k], L)
        if not regions:
            continue
        btot = np.cumsum(np.concatenate([[0.0], ppB[k][:L]]))
        etot = np.cumsum(np.concatenate([[0.0], ppE[k][1:L + 1]]))
        multi = []
        for (i, j) in regions:
            ps = np.arange(i, j + 1)
            epre = (etot[ps] - etot[i - 1]).astype(np.float32)
            bpost = (btot[j] - btot[ps - 1]).astype(np.float32)
            if float(np.minimum(epre, bpost).max()) < RT3:
                decision[k] = 1
                multi = []
                break
            multi.append((i, j))
        if decision[k] != 1 and multi:
            decision[k] = 0
            pending[k] = multi
    return decision, pending


def prefilter_grid(banks_t, bank_cols: Sequence[Sequence[int]],
                   codes: np.ndarray, lens: np.ndarray, H: int):
    """Three-way gate decisions for the full [Q, H] grid.

    banks_t: BankTensors per bank; bank_cols[b][r]: the score column of
    bank b's row r. codes [Q, Lmax] int32 (padded), lens [Q]. The
    queries run in chunks whose device rows fit in CHUNK_BYTES, so
    device memory does not grow with Q.

    Returns (dec [Q, H] int8, rows): rows[j] = (queries, mocc, ppB, ppE)
    for the pairs of column j with dec >= 0, queries ascending, rows
    f32 [n, Lmax + 1] as native evaluate_targets_rows takes them."""
    Q, Lc = codes.shape
    dec = np.full((Q, H), -1, np.int8)
    parts: Dict[int, list] = {}
    lens = np.asarray(lens, np.int32)
    for bt, cols in zip(banks_t, bank_cols):
        c = torch.as_tensor(np.ascontiguousarray(codes, np.int32),
                            device=bt.device)
        ln = torch.as_tensor(lens, device=bt.device)
        qc = max(1, CHUNK_BYTES // (bt.H * (Lc + 1) * BYTES_PER_CELL))
        for q0 in range(0, Q, qc):
            q1 = min(Q, q0 + qc)
            _, ppB, ppE, mocc = flank_rows(bt, c[q0:q1], ln[q0:q1])
            qi, hi = torch.nonzero((mocc >= RT1).any(dim=-1),
                                   as_tuple=True)
            got = [x[qi, hi].cpu().numpy() for x in (mocc, ppB, ppE)]
            qi, hi = qi.cpu().numpy() + q0, hi.cpu().numpy()
            del ppB, ppE, mocc
            d, _ = gate_prefilter(got[0], got[1], got[2], lens[qi])
            for r, colj in enumerate(cols):
                sel = np.flatnonzero((hi == r) & (d >= 0))  # qi ascending
                dec[qi[sel], colj] = d[sel]
                if sel.size:
                    parts.setdefault(colj, []).append(
                        (qi[sel],) + tuple(g[sel] for g in got))
    rows = {j: tuple(np.concatenate(x) for x in zip(*p))
            for j, p in parts.items()}
    return dec, rows
