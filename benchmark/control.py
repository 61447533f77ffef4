"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed in bfloat16, the
precision below the float32 that the configurations state for scores.
It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the fragments a run of the cell would make, draws
the candidates a run would draw from its first jobs (as many as hold
twice the cell's check_decided, and at least two), works out their
weights, scores and rows with the reference in bfloat16 (the control's
answers) and holds them against the reference in float64 by the same
numbers as a run (compare.py), printing each number beside its limit,
one JSON line a seed. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_jobs(traffic):
    """The jobs whose candidates the control draws."""
    per, want = traffic["check_candidates_per_job"], traffic["check_decided"]
    return max(2, -(-2 * want // per))


def control_numbers(cell, seed, models, device, dtype):
    """The compared numbers of `dtype`'s reference in the program's place
    on one seed's candidates."""
    import numpy as np

    from benchmark.check import Checker, interleave
    from benchmark.compare import LIMITS, sample_numbers
    from benchmark.reference.witch import Reference, adaptive_top, encode
    checker = Checker(cell, seed)
    frags = []
    for k in range(control_jobs(cell.traffic)):
        job = cell.window_frags[k]
        frags.append([(k, "J%03dQ%05d" % (k, i), job[i])
                      for i in checker.pick(k, len(job))])
    frags = interleave(frags)
    codes = [encode(f) for _, _, f in frags]
    w = cell.config["witch"]
    ctl = Reference(models, device, dtype)
    weights, _, reported, _ = ctl.weights(codes, w["num_hmms"])
    L = cell.bb_codes.shape[1]
    col = {h: j for j, h in enumerate(ctl.idx)}
    samples = []
    for q, (k, name, frag) in enumerate(frags):
        sel = adaptive_top(list(weights[q] or ()))
        pairs = [(h, codes[q]) for h, _ in sel]
        cols = dict(zip([h for h, _ in sel], ctl.columns(pairs))) \
            if pairs else {}
        row = ctl.row(frag, L, sel, cols) if sel else ""
        scores = {h: float(np.round(reported[q, col[h]], 1))
                  for h, _ in (weights[q] or ())}
        samples.append((k, name, frag, row or None, weights[q], scores))
    nums = sample_numbers(Reference(models, device), samples, w["num_hmms"],
                          L, scores_persisted=not cell.traffic[
                              "reuse_decomposition"],
                          decided=cell.traffic["check_decided"])
    nums.pop("taken")
    return {k: {"value": float(v), "limit": LIMITS[k]}
            for k, v in nums.items()}


def main(argv=None):
    import argparse

    import torch

    from benchmark.compare import passes
    from benchmark.reference import hmmbuild
    from benchmark.run import Cell, cell_of, load_spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    spec = load_spec(ROOT)
    workload, cfg = cell_of(spec, args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    models = None
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as tmp:
            cell = Cell(ROOT, workload, cfg, seed, device, tmp)
            if models is None:
                with open(cell.tree) as f:
                    models = hmmbuild.ensemble(
                        cell.bb_names, cell.bb_codes, f.read(),
                        cell.config["witch"]["alignment_size"])
            checks = control_numbers(cell, seed, models, device,
                                     torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": passes(checks), "checks": checks}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
