"""Transitive merge of aligned query rows into the backbone alignment.

Equivalent to the reference's ExtendedAlignment.merge_in chain
(witch_msa/helpers/alignment_tools.py:1183-1316) + mergeAlignmentsCollapsed
(witch_msa/gcmm/merger.py:42-103), re-designed as a direct O(output)
construction: since every query row covers all backbone columns, the
sequential pairwise merge reduces to overlaying insertion runs at shared
boundaries (left-aligned), with the final insertion-region length at each
boundary being the maximum run length over queries. This is provably
equivalent to the reference's merge order-independently (content-wise),
and removes its quadratic re-splicing of bytearrays.

Row layout of a query: [leading insertions][per backbone column: residue
or '-' interleaved with internal insertion runs][trailing insertions]
(the output of witch_tpu.ops.merge_dp.align_query_row).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def parse_query_row(row: str, backbone_length: int):
    """Split an aligned query row into per-boundary insertion runs and the
    backbone-aligned characters.

    Returns (match_chars: list[str] of length backbone_length,
    runs: dict boundary->str) where boundary g means 'before backbone
    column g' (g in 0..backbone_length).
    """
    match_chars = []
    runs: Dict[int, List[str]] = {}
    col = 0
    for ch in row:
        if ch.islower():
            runs.setdefault(col, []).append(ch)
        else:
            match_chars.append(ch)
            col += 1
    if col != backbone_length:
        raise ValueError(
            "query row covers %d backbone columns, expected %d"
            % (col, backbone_length))
    return match_chars, {g: "".join(v) for g, v in runs.items()}


def _parse_row_vec(row: str, L: int):
    """Vectorized parse_query_row: returns (match_bytes [L] uint8,
    ins_positions, ins_boundary g per insertion char, ins_rank within
    its run, ins_bytes)."""
    a = np.frombuffer(row.encode("latin-1"), np.uint8)
    low = (a >= 97) & (a <= 122)
    up = ~low
    mc = a[up]
    if len(mc) != L:
        raise ValueError(
            "query row covers %d backbone columns, expected %d"
            % (len(mc), L))
    lows = np.flatnonzero(low)
    if len(lows) == 0:
        return mc, lows, lows, lows, a[lows]
    cum = np.cumsum(up)
    g = cum[lows]                      # boundary: #match chars before
    # insertions at one boundary are consecutive -> rank = index - run
    # start (runs delimited by changes in g)
    starts = np.r_[0, np.flatnonzero(np.diff(g)) + 1]
    counts = np.diff(np.r_[starts, len(g)])
    rank = np.arange(len(g)) - np.repeat(starts, counts)
    return mc, lows, g, rank, a[lows]


def merge_rows_bytes(backbone_names: Sequence[str],
                     backbone_mat: np.ndarray,
                     query_rows: Sequence[Tuple[str, str]],
                     collapse_singletons: bool = True):
    """Matrix-form merge: returns (names, out_mat [n, total] uint8,
    insertion_mask). The string-API merge_rows wraps this."""
    n_bb, L = backbone_mat.shape
    parsed = []
    run_len = np.zeros(L + 1, dtype=np.int64)
    qoff = []                      # per query: offset array aligned to g
    for name, row in query_rows:
        mc, lows, g, rank, ib = _parse_row_vec(row, L)
        parsed.append((name, mc, g, rank, ib))
        if len(g) == 0:
            qoff.append(np.zeros(0, np.int64))
            continue
        if collapse_singletons:
            counts = np.bincount(g, minlength=L + 1)
            np.maximum(run_len, counts, out=run_len)
            qoff.append(np.zeros(len(g), np.int64))
        else:
            off = run_len[g].copy()     # start before this query's runs
            qoff.append(off)
            np.add.at(run_len, g, 1)
    # output layout: [runs@0][col0][runs@1][col1]...[colL-1][runs@L]
    csum = np.cumsum(run_len)
    total = int(L + csum[-1])
    run_pos = np.r_[0, csum[:-1]] + np.arange(L + 1)   # start of runs@g
    col_pos = run_pos[:L] + run_len[:L]                # backbone col g
    ins_mask = np.ones(total, dtype=bool)
    ins_mask[col_pos] = False
    names = list(backbone_names)
    out = np.full((n_bb + len(parsed), total), ord("-"), np.uint8)
    out[:n_bb, col_pos] = backbone_mat
    for qi, ((name, mc, g, rank, ib), off) in enumerate(zip(parsed,
                                                            qoff)):
        r = n_bb + qi
        out[r, col_pos] = mc
        if len(g):
            if collapse_singletons:
                out[r, run_pos[g] + rank] = ib
            else:
                out[r, run_pos[g] + off + rank] = ib
        names.append(name)
    return names, out, ins_mask


def merge_rows(backbone_records: Sequence[Tuple[str, str]],
               query_rows: Sequence[Tuple[str, str]],
               collapse_singletons: bool = True):
    """Merge aligned query rows into the backbone.

    backbone_records: (name, aligned row) of the uppercased working
    backbone. query_rows: (name, witch-ng output row).
    Returns (records, insertion_mask) where records is the merged full
    alignment (backbone rows first, then queries in given order) and
    insertion_mask marks insertion columns (for the .masked output).

    collapse_singletons=False gives every query's insertion runs private
    output columns instead of sharing left-aligned columns at the same
    backbone boundary (the reference's dormant --collapse-singletons=0).
    """
    if not backbone_records:
        raise ValueError("empty backbone")
    bb_names = [n for n, _ in backbone_records]
    bb_mat = np.vstack([
        np.frombuffer(r.encode("latin-1"), np.uint8)
        for _, r in backbone_records])
    names, out, ins_mask = merge_rows_bytes(
        bb_names, bb_mat, query_rows,
        collapse_singletons=collapse_singletons)
    records = [(n, out[i].tobytes().decode("latin-1"))
               for i, n in enumerate(names)]
    return records, ins_mask


def remove_insertion_columns(records: Sequence[Tuple[str, str]],
                             ins_mask: np.ndarray):
    """Masked output: drop insertion columns (reference
    remove_insertion_columns, alignment_tools.py:1140-1156)."""
    keep = ~ins_mask
    out = []
    for name, row in records:
        arr = np.array(list(row), dtype="U1")
        out.append((name, "".join(arr[keep])))
    return out
