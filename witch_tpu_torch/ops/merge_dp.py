"""Weighted query-to-backbone merge DP — the witch-ng core.

Re-implements the semantics of the reference's alignSubQueriesNew
(witch_msa/gcmm/aligner.py:350-538): accumulate weighted edges
(query residue i, backbone column j) from the per-HMM alignments, then a
banded maximum-weight alignment DP with the reference's exact tie-breaking,
then backtrace to an upper/lower/'-' row and compress terminal insertions.

The row recurrence vectorizes: with
    d[j] = prev[j-1] + cw[i-1, j-1]      (diagonal + edge weight)
    c[j] = max(d[j], prev[j]) if cw > 0 else prev[j]
the reference's three-way max with left-moves equals a running maximum
row[j] = max(c[j], row[j-1]) — a cummax scan. The implementation below
runs this as vectorized numpy on host (np.maximum.accumulate per
residue row): the band is data-dependent and small (typically a few
hundred columns), so host cummax beats shipping the DP to the device;
the same reformulation maps directly to jax.lax.cummax + lax.scan if a
device path is ever needed for very long backbones.

Backtrace priorities (calibrated to the reference loop at
aligner.py:435-448): left wins only if strictly greater than both other
candidates; diagonal wins ties over up when its edge weight is positive;
otherwise up.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def accumulate_edges(n_res: int, backbone_length: int,
                     per_hmm: Sequence[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, float]]):
    """Build the combined weight matrix for one query.

    per_hmm: list of (aligned_columns [n_res], retained_columns [M_h],
    nongaps_per_column [M_h], weight). Returns (cw dense [n_res, band],
    min_col, max_col) or None if no edges.
    """
    min_col, max_col = backbone_length + 1, -1
    triples = []
    for ac, retained, nongaps, w in per_hmm:
        mask = ac >= 0
        if not mask.any():
            continue
        rows = np.flatnonzero(mask)
        cols = retained[ac[rows]]
        wts = nongaps[ac[rows]].astype(np.float64) * w
        triples.append((rows, cols, wts))
        min_col = min(min_col, int(cols.min()))
        max_col = max(max_col, int(cols.max()))
    if not triples:
        return None, 0, -1
    band = max_col - min_col + 1
    cw = np.zeros((n_res, band))
    for rows, cols, wts in triples:
        np.add.at(cw, (rows, cols - min_col), wts)
    return cw, min_col, max_col


def sparse_edges(per_hmm):
    """Concatenated (rows, global backbone cols, weights) triples for one
    query's accumulated edges (used to share MCL clustering across a
    batched old-witch GCM run)."""
    rr, cc, ww = [], [], []
    for ac, retained, nongaps, w in per_hmm:
        mask = ac >= 0
        if not mask.any():
            continue
        rows = np.flatnonzero(mask)
        rr.append(rows)
        cc.append(retained[ac[rows]])
        ww.append(nongaps[ac[rows]].astype(np.float64) * w)
    if not rr:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0))
    return np.concatenate(rr), np.concatenate(cc), np.concatenate(ww)


def banded_dp(cw: np.ndarray) -> np.ndarray:
    """Run the DP over [n_res+1, band+1]; returns backtrace codes int8
    (0=diag, 1=up, 2=left). Column 0 of the DP corresponds to j=min_col
    (boundary), DP column t>=1 matches backbone column min_col+t-1's edge
    cw[:, t-1]."""
    n, band = cw.shape
    bt = np.zeros((n + 1, band + 1), dtype=np.int8)
    prev = np.zeros(band + 1)
    for i in range(1, n + 1):
        w = cw[i - 1]                      # [band]
        d = prev[:-1] + w
        up = prev[1:]
        has = w > 0
        c = np.where(has, np.maximum(d, up), up)
        row = np.maximum.accumulate(np.concatenate(([0.0], c)))
        left = row[:-1]
        b = np.where(left > c, 2,
                     np.where(has & (d >= up), 0, 1)).astype(np.int8)
        bt[i, 1:] = b
        prev = row
    return bt


def traceback(seq: str, bt: np.ndarray, min_col: int, max_col: int,
              backbone_length: int) -> str:
    """Backtrace to the aligned query row (reference aligner.py:450-482)."""
    n = len(seq)
    out = []
    i, t = n, max_col + 1 - min_col  # t is DP column index
    while i > 0 and t > 0:
        b = bt[i, t]
        if b == 0:
            out.append(seq[i - 1])
            i -= 1
            t -= 1
        elif b == 1:
            out.append(seq[i - 1].lower())
            i -= 1
        else:
            out.append("-")
            t -= 1
    while i > 0:
        out.append(seq[i - 1].lower())
        i -= 1
    while t > 0:
        out.append("-")
        t -= 1
    mid = "".join(reversed(out))
    return "-" * min_col + mid + "-" * (backbone_length - max_col - 1)


def compress_insertions(seq: str) -> str:
    """Pack leading/trailing lowercase runs to the row ends
    (reference alignment_tools.py:1356-1384)."""
    import re
    p = re.compile(r"[A-Z]+")
    alns = [(m.start(), m.end()) for m in p.finditer(seq)]
    if not alns:
        return seq
    f_end = alns[0][0]
    b_start = alns[-1][1]
    f_ins = seq[:f_end].replace("-", "")
    f_str = f_ins + "-" * (f_end - len(f_ins))
    b_ins = seq[b_start:].replace("-", "")
    b_str = "-" * (len(seq) - b_start - len(b_ins)) + b_ins
    return f_str + seq[f_end:b_start] + b_str


def _row_from_ops(seq: str, ops: np.ndarray, min_col: int, max_col: int,
                  backbone_length: int) -> str:
    """Assemble the aligned row from forward-order path ops
    (0 diag -> upper, 1 up -> lower, 2 left -> '-')."""
    out = []
    i = 0
    for op in ops:
        if op == 0:
            out.append(seq[i])
            i += 1
        elif op == 1:
            out.append(seq[i].lower())
            i += 1
        else:
            out.append("-")
    mid = "".join(out)
    return "-" * min_col + mid + "-" * (backbone_length - max_col - 1)


def align_query_row(seq: str, backbone_length: int,
                    per_hmm: Sequence[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, float]]) -> str:
    """Full witch-ng merge for one query; returns the aligned row string
    (uppercase match, lowercase insertion, '-' deletion), or '' when the
    query has no edges (ignored in output)."""
    cw, min_col, max_col = accumulate_edges(len(seq), backbone_length,
                                            per_hmm)
    if cw is None:
        return ""
    from ..native import _oa
    ops = _oa.merge_dp_trace(np.ascontiguousarray(cw))
    row = _row_from_ops(seq, ops, min_col, max_col, backbone_length)
    return compress_insertions(row)
