"""Holds what the timed path produced for the sampled fragments against the
plain reference (reference/), and decides `correct`.

Numbers compared, each with its limit (LIMITS; PERF.md gives the
readings each was set from):
  missing         fragments of the window's jobs in neither the output
                  nor ignored_queries.fasta, or of a job that raised
                  (exact: 0)
  subset_mismatch ensemble members whose subset of backbone rows differs
                  from the reference decomposition's (exact: 0)
  hmm_gap         the widest gap, over every parameter of every model of
                  the job's ensemble, between the program's model file
                  and the reference build, in -ln p at the text format's
                  5 decimals (exact: 0)
  score_gap       cells that persist search results: the widest gap, over
                  each sampled fragment's selected models, between the
                  program's reported score (printed to 0.1 bit) and the
                  reference's, in bits
  weight_gap      the widest gap between a sampled fragment's weight for
                  a model in the program's weights.txt and in the
                  reference's (a model absent on one side weighs 0)
  row_mismatch    sampled fragments whose masked row differs from the
                  reference's row for the program's own selection of
                  models and weights, or that the program ignored where
                  the reference reports a model (exact: 0)
  decided_short   how many fewer sampled fragments with weights decided
                  by the reference than the cell's check_decided
                  (exact: 0)
A candidate region that holds more than one domain is resolved by HMMER's
stochastic trace ensemble, which the reference does not reproduce: the
reference leaves such a fragment's weights undecided, and that pair out
of score_gap. So the fragments are taken in the seeded order of the
harness's candidates (check.py) until check_decided of them have decided
weights; the undecided ones taken on the way are still held to the other
numbers. A run whose candidates run out first is not correct, so that no
run passes with its weights unchecked.
"""

from __future__ import annotations

import os
import re
import sys
import time

import numpy as np

LIMITS = {
    "missing": 0,
    "subset_mismatch": 0,
    "hmm_gap": 0.0,
    "score_gap": 0.1,
    "weight_gap": 0.05,
    "row_mismatch": 0,
    "decided_short": 0,
}


def passes(checks):
    """`correct`: every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def read_models(ens_dir):
    """{index: (subset names, {"mat", "ins", "trans": -ln p arrays with
    inf for '*'})} of a decomposition directory's model files."""
    out = {}
    for d in os.listdir(ens_dir):
        m = re.match(r"A_0_(\d+)$", d)
        if not m:
            continue
        i = int(m.group(1))
        sub = os.path.join(ens_dir, d)
        model = inp = None
        for fn in os.listdir(sub):
            if fn.startswith("hmmbuild.model."):
                model = os.path.join(sub, fn)
            elif fn.startswith("hmmbuild.input."):
                inp = os.path.join(sub, fn)
        if model is None or inp is None:
            continue
        with open(inp) as f:
            names = [l[1:].split()[0] for l in f if l.startswith(">")]
        out[i] = (names, parse_hmm_text(model))
    return out


def _nats(tok):
    return np.inf if tok == "*" else float(tok)


def parse_hmm_text(path):
    with open(path) as f:
        lines = f.read().splitlines()
    k = next(n for n, l in enumerate(lines) if l.strip().startswith("COMPO"))
    mat, ins, trans = [[np.inf] * 4], [], []
    ins.append([_nats(t) for t in lines[k + 1].split()])
    trans.append([_nats(t) for t in lines[k + 2].split()])
    n = k + 3
    while not lines[n].startswith("//"):
        mat.append([_nats(t) for t in lines[n].split()[1:5]])
        ins.append([_nats(t) for t in lines[n + 1].split()])
        trans.append([_nats(t) for t in lines[n + 2].split()])
        n += 3
    return {"mat": np.array(mat), "ins": np.array(ins),
            "trans": np.array(trans)}


def _nats_of(p):
    with np.errstate(divide="ignore"):
        return np.round(-np.log(p), 5)


def ensemble_numbers(models, names, prog):
    """(subset_mismatch, hmm_gap) of the program's models against the
    reference's."""
    mism, gap = 0, 0.0
    for i in sorted(set(models) | set(prog)):
        if i not in models or i not in prog:
            mism += 1
            continue
        ref = models[i]
        pnames, pm = prog[i]
        if sorted(pnames) != sorted(names[r] for r in ref.rows):
            mism += 1
            continue
        for key, arr in (("mat", ref.mat), ("ins", ref.ins),
                         ("trans", ref.trans)):
            a, b = _nats_of(arr), pm[key]
            if a.shape != b.shape:
                gap = np.inf
                continue
            both_inf = np.isinf(a) & np.isinf(b)
            with np.errstate(invalid="ignore"):
                d = np.where(both_inf, 0.0, np.abs(a - b))
            gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max()))
    return mism, gap


def verify(cell, ens_dir, samples, missing):
    """(correct, {number: {"value", "limit"}}) of a run's outputs."""
    import torch

    from .reference import hmmbuild
    from .reference.witch import Reference
    t0 = time.time()
    with open(cell.tree) as f:
        tree_text = f.read()
    w = cell.config["witch"]
    models = hmmbuild.ensemble(cell.bb_names, cell.bb_codes, tree_text,
                               w["alignment_size"])
    t_build = time.time() - t0
    nums = {"missing": missing}
    if ens_dir is not None and os.path.isdir(ens_dir):
        mism, gap = ensemble_numbers(models, cell.bb_names,
                                     read_models(ens_dir))
    else:
        mism, gap = len(models), np.inf
    nums["subset_mismatch"] = mism
    nums["hmm_gap"] = gap

    device = "cuda" if torch.cuda.is_available() and \
        str(cell.device or "cuda").startswith("cuda") else "cpu"
    ref = Reference(models, device)
    nums.update(sample_numbers(ref, samples, w["num_hmms"],
                               cell.bb_codes.shape[1],
                               scores_persisted=cell.hmmdir is None,
                               decided=cell.traffic["check_decided"]))
    taken = nums.pop("taken")
    say("reference: ensemble of %d models built in %.1f s; %d of %d "
        "candidate fragments compared in %.1f s, %d of them with weights "
        "decided" % (len(models), t_build, taken, len(samples),
                     time.time() - t0 - t_build,
                     cell.traffic["check_decided"] - nums["decided_short"]))
    checks = {k: {"value": float(v), "limit": LIMITS[k]}
              for k, v in nums.items()}
    return passes(checks), checks


def sample_numbers(ref, candidates, num_hmms, backbone_length,
                   scores_persisted, decided):
    """score_gap, weight_gap, row_mismatch and decided_short of the
    candidates taken in order until `decided` of them have weights that
    the reference decides, and how many were taken: candidates are (job,
    name, fragment, program's masked row or None, program's weights or
    None, program's scores {model: bits})."""
    from .reference.witch import adaptive_top, encode
    codes = [encode(s[2]) for s in candidates]
    rw, reported, valid = [], [], []
    while len(rw) < len(candidates):
        short = decided - sum(w is not None for w in rw)
        if short <= 0:
            break
        batch = codes[len(rw):len(rw) + short]
        w, _, rep, val = ref.weights(batch, num_hmms)
        rw += w
        reported.append(rep)
        valid.append(val)
    samples, codes = candidates[:len(rw)], codes[:len(rw)]
    n_decided = sum(w is not None for w in rw)
    out = {"decided_short": max(decided - n_decided, 0), "taken": len(rw)}
    if not samples:
        out.update(weight_gap=np.inf, row_mismatch=np.inf)
        if scores_persisted:
            out["score_gap"] = np.inf
        return out
    reported, valid = np.concatenate(reported), np.concatenate(valid)
    col = {h: j for j, h in enumerate(ref.idx)}
    wgap, sgap = 0.0, 0.0
    for q, s in enumerate(samples):
        pw = dict(s[4] or ())
        if rw[q] is not None:
            r = dict(rw[q])
            for h in set(pw) | set(r):
                wgap = max(wgap, abs(pw.get(h, 0.0) - r.get(h, 0.0)))
        if not scores_persisted:
            continue
        # the selected models' scores
        for h in pw:
            if h not in col:
                sgap = np.inf
                continue
            bits = reported[q, col[h]]
            if np.isnan(bits):                   # undecided pair
                continue
            if h not in s[5]:
                sgap = np.inf
                continue
            sgap = max(sgap, abs(s[5][h] - bits))
    out["weight_gap"] = wgap
    if scores_persisted:
        out["score_gap"] = sgap
    # rows from the program's own selection and weights
    pairs, keys = [], []
    for q, s in enumerate(samples):
        for h, _ in adaptive_top(list(s[4] or ())):
            pairs.append((h, codes[q]))
            keys.append((q, h))
    cols = ref.columns(pairs) if pairs else []
    cols_of = {}
    for (q, h), c in zip(keys, cols):
        cols_of.setdefault(q, {})[h] = c
    bad = 0
    for q, s in enumerate(samples):
        sel = adaptive_top(list(s[4] or ()))
        row = ref.row(s[2], backbone_length, sel, cols_of.get(q, {})) \
            if sel else ""
        if (row or None) != s[3]:
            bad += 1
        elif not sel and valid[q].any():
            # no weights and no row, where the reference has a model the
            # fragment is reported against: ignored wrongly
            bad += 1
    out["row_mismatch"] = bad
    return out
