"""The least time the card could take for the all-vs-all Forward scoring of
a set of fragments against an ensemble, from the inputs' real lengths.

Work: every (fragment, model) pair is a full DP grid of fragment
residues x model match states, at the fragment's own length and the
model's own M (not the bank's padded Mp): cells = sum(L) x sum(M).

Operations: the f32 operations of the Forward recurrence alone, 16 a
cell, in probability space: a match state's four sources (M, I, D at
k-1 and the local entry from B) are four products and three sums (7),
times the emission odds (1); the insert state two products and a sum
(3); the delete chain two products and a sum (3); the free exit adds the
match and the delete state to E (2). The kernel's own work beyond the
recurrence (the row maximum and the rescaling that keep it in range) is
not counted, as the pair-HMM's 17 leaves out its scan.

Bytes: each input read once and each output written once: per model
the emission odds of the 4 canonical residues and 8 transition scores a
state (f32), the fragments' residue codes (int32) once, and one f32
score per pair.
"""

from __future__ import annotations

import json
import os

F32_OPS_PER_CELL = 16
EMISSIONS_PER_STATE = 4
TRANSITIONS_PER_STATE = 8


def peaks():
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "peaks.json")) as f:
        return json.load(f)


def forward_work(frag_lengths, model_lengths):
    """(cells, f32 operations, bytes) of scoring every fragment against
    every model."""
    sum_l = float(sum(frag_lengths))
    sum_m = float(sum(model_lengths))
    cells = sum_l * sum_m
    nbytes = (4.0 * (EMISSIONS_PER_STATE + TRANSITIONS_PER_STATE) * sum_m
              + 4.0 * sum_l + 4.0 * len(frag_lengths) * len(model_lengths))
    return cells, F32_OPS_PER_CELL * cells, nbytes


def bound_seconds(ops, nbytes, pk=None):
    """(least seconds, "operations" or "bytes")."""
    pk = pk or peaks()
    t_ops = ops / pk["f32_flop_per_s"]
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
