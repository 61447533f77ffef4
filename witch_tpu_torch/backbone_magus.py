"""MAGUS-lite divide-and-conquer backbone alignment.

The reference's scenario-A backbone comes from vendored MAGUS (cluster the
sequences, align each cluster, merge the cluster alignments through a
graph-clustering DP). A single-profile iterative aligner (backbone.py)
struggles on highly diverged inputs, so this module provides the same
divide-and-conquer shape with TPU-friendly parts:

  1. k-mer k-means clustering of the sequences (host, numpy);
  2. each cluster aligned by the iterative profile-HMM aligner
     (device posterior-OA under the hood);
  3. clusters merged progressively: profile-profile Needleman-Wunsch
     over match-state emission vectors (log shared-odds column scores),
     splicing non-match columns left-aligned, rebuilding the merged
     profile after every join.

Reference behavior being replaced: MAGUS invocation in
witch_msa/gcmm/backbone.py (external tool there, native here).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .core.alignment import PackedAlignment
from .core.alphabet import ALPHABETS, Alphabet
from .hmm.build import build_hmm


def kmer_kmeans(profiles: np.ndarray, n_clusters: int, seed: int = 0,
                n_iter: int = 12) -> List[np.ndarray]:
    """Seeded k-means over L2-normalized k-mer profiles.

    Farthest-point initialization; returns index arrays (non-empty)."""
    n = profiles.shape[0]
    n_clusters = min(n_clusters, n)
    rng = np.random.default_rng(seed)
    centers = [int(rng.integers(n))]
    d = 1.0 - profiles @ profiles[centers[0]]
    for _ in range(n_clusters - 1):
        centers.append(int(np.argmax(d)))
        d = np.minimum(d, 1.0 - profiles @ profiles[centers[-1]])
    C = profiles[centers].copy()
    for _ in range(n_iter):
        assign = np.argmax(profiles @ C.T, axis=1)
        for c in range(n_clusters):
            rows = profiles[assign == c]
            if len(rows):
                m = rows.mean(axis=0)
                nrm = np.linalg.norm(m)
                C[c] = m / nrm if nrm > 0 else C[c]
    assign = np.argmax(profiles @ C.T, axis=1)
    return [np.flatnonzero(assign == c) for c in range(n_clusters)
            if np.any(assign == c)]


def _match_profile(aln: PackedAlignment, molecule: str,
                   symfrac: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """(match column indices [M], emission probs [M, K]) for an alignment.

    The hmmbuild-parity HMM treats every column as a match state (the
    reference's hmmbuild usage does the same); for merging we only want
    well-occupied columns, so select by plain occupancy >= symfrac and
    take those columns' posterior emission means."""
    core = build_hmm(aln.codes, aln.alphabet, molecule)
    occ = aln.nongaps_per_column()
    keep = np.flatnonzero(occ >= max(1, symfrac * aln.n_seqs))
    if keep.size == 0:
        keep = np.array([int(np.argmax(occ))])
    em = core.match_emissions[1:][keep]
    return keep.astype(np.int64), em


def profile_profile_path(emA: np.ndarray, emB: np.ndarray,
                         bg: np.ndarray, gap: float = -1.5
                         ) -> List[Tuple[int, int]]:
    """Global NW over match columns; score = log sum_a pA pB / bg
    (log-odds that the two columns emit the same letter). Returns the
    aligned path as (i, j) with -1 for gaps, in order."""
    S = np.log(np.maximum((emA / bg[None, :]) @ emB.T, 1e-8))  # [MA, MB]
    from .native import _oa
    ops = _oa.pp_nw(np.ascontiguousarray(S, np.float64), float(gap))
    path = []
    i = j = 0
    for op in ops:
        if op == 0:
            path.append((i, j)); i += 1; j += 1
        elif op == 1:
            path.append((i, -1)); i += 1
        else:
            path.append((-1, j)); j += 1
    return path


def merge_alignments(A: PackedAlignment, colsA: np.ndarray, emA: np.ndarray,
                     B: PackedAlignment, colsB: np.ndarray, emB: np.ndarray,
                     bg: np.ndarray) -> PackedAlignment:
    """Splice two cluster alignments along the profile-profile path.

    Paired match columns share an output column; every other input column
    (insert columns, gap-matched columns) gets its own output column,
    emitted left-aligned before the next pairing — mirroring the
    transitive-merge overlay convention (merger.py)."""
    path = profile_profile_path(emA, emB, bg)
    gapA = A.alphabet.gap_code
    segs = []                    # (a_lo, a_hi, b_lo, b_hi, paired)
    ca = cb = 0
    for (i, j) in path:
        if i >= 0 and j >= 0:
            segs.append((ca, int(colsA[i]), cb, int(colsB[j]), True))
            ca, cb = int(colsA[i]) + 1, int(colsB[j]) + 1
        elif i >= 0:
            segs.append((ca, int(colsA[i]) + 1, cb, cb, False))
            ca = int(colsA[i]) + 1
        else:
            segs.append((ca, ca, cb, int(colsB[j]) + 1, False))
            cb = int(colsB[j]) + 1
    segs.append((ca, A.n_cols, cb, B.n_cols, False))

    total = 0
    for (al, ah, bl, bh, paired) in segs:
        if paired:
            total += (ah - al) + (bh - bl) + 1
        else:
            total += (ah - al) + (bh - bl)
    nA, nB = A.n_seqs, B.n_seqs
    out = np.full((nA + nB, total), gapA, np.uint8)
    pos = 0
    for (al, ah, bl, bh, paired) in segs:
        if paired:
            wa, wb = ah - al, bh - bl
            out[:nA, pos:pos + wa] = A.codes[:, al:ah]
            pos += wa
            out[nA:, pos:pos + wb] = B.codes[:, bl:bh]
            pos += wb
            out[:nA, pos] = A.codes[:, ah]
            out[nA:, pos] = B.codes[:, bh]
            pos += 1
        else:
            wa, wb = ah - al, bh - bl
            out[:nA, pos:pos + wa] = A.codes[:, al:ah]
            pos += wa
            out[nA:, pos:pos + wb] = B.codes[:, bl:bh]
            pos += wb
    merged = PackedAlignment(A.names + B.names, out, A.alphabet)
    merged2, _ = merged.delete_all_gap_columns()
    return merged2


def align_backbone_magus(names: List[str], seqs: List[str], molecule: str,
                         cluster_size: int = 40, use_device: bool = True,
                         log=None, seed: int = 0) -> PackedAlignment:
    """Divide-and-conquer backbone alignment (MAGUS-lite)."""
    from .backbone import _kmer_profiles, align_backbone
    alphabet = ALPHABETS[molecule]
    seqs = [s.upper() for s in seqs]
    n = len(seqs)
    if n <= cluster_size:
        return align_backbone(names, seqs, molecule,
                              use_device=use_device, log=log)
    codes = [alphabet.encode(s) for s in seqs]
    profiles = _kmer_profiles(codes, alphabet.K)
    n_clusters = max(2, -(-n // cluster_size))
    clusters = kmer_kmeans(profiles, n_clusters, seed=seed)
    if log:
        log("magus-lite: %d clusters (sizes %s)"
            % (len(clusters), sorted((len(c) for c in clusters),
                                     reverse=True)))
    pieces = []
    for ci, idx in enumerate(clusters):
        c_names = [names[t] for t in idx]
        c_seqs = [seqs[t] for t in idx]
        if len(idx) == 1:
            aln = PackedAlignment.from_records(
                [(c_names[0], c_seqs[0])], alphabet=alphabet)
        else:
            aln = align_backbone(c_names, c_seqs, molecule,
                                 use_device=use_device,
                                 seed_group=min(24, len(idx)))
        pieces.append(aln)
        if log:
            log("magus-lite: cluster %d aligned (%d seqs, %d cols)"
                % (ci, aln.n_seqs, aln.n_cols))
    # background for column odds = uniform (nucleic) / prior mean otherwise
    from .hmm.priors import get_background
    bg = get_background(molecule)
    # progressive merge, largest first
    pieces.sort(key=lambda a: -a.n_seqs)
    acc = pieces[0]
    cols_acc, em_acc = _match_profile(acc, molecule)
    for nxt in pieces[1:]:
        cols_n, em_n = _match_profile(nxt, molecule)
        acc = merge_alignments(acc, cols_acc, em_acc, nxt, cols_n, em_n, bg)
        cols_acc, em_acc = _match_profile(acc, molecule)
        if log:
            log("magus-lite: merged -> %d seqs, %d cols"
                % (acc.n_seqs, acc.n_cols))
    # Refinement pass: the progressive merge can accumulate private
    # insert columns on hard (highly diverged, indel-rich) data — width
    # grows with every join. Re-profile the merged alignment's
    # SUPPORTED columns and realign every sequence against it
    # (refine_from_seed): the overlay's width is bounded by
    # M + per-gap max insert runs, and the merge quality seeds the
    # profile far better than any single sequence could.
    from .backbone import refine_from_seed
    support = acc.nongaps_per_column()
    n_acc = acc.n_seqs
    med_len = float(np.median([len(s) for s in seqs]))
    thresh = max(2, int(round(0.15 * n_acc)))
    keep = np.flatnonzero(support >= thresh)
    if keep.size < med_len:
        keep = np.sort(np.argsort(-support)[:int(med_len)])
    m_cap = int(np.ceil(2.0 * med_len))
    if keep.size > m_cap:
        keep = np.sort(np.argsort(-support)[:m_cap])
    seed = PackedAlignment(acc.names, acc.codes[:, keep], alphabet)
    if log:
        log("magus-lite: merge width %d -> seed profile %d cols; "
            "refining" % (acc.n_cols, seed.n_cols))
    refined = refine_from_seed(seed, acc.names, [
        seqs[names.index(nm)] for nm in acc.names], molecule,
        use_device=use_device, log=log)
    # restore input order
    order = {nm: t for t, nm in enumerate(refined.names)}
    rows = [order[nm] for nm in names]
    return PackedAlignment(names, refined.codes[rows], alphabet)
