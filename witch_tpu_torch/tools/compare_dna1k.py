"""Run the seeded dna1k scenario D through the witch_tpu_torch CLI of two
checkouts of the repository on one CUDA card, and compare their outputs
byte for byte.

    python3 witch_tpu_torch/tools/compare_dna1k.py --tree A --tree B [--out DIR]

The data is scripts/make_scale_dataset.py --n 1000 --queries 1000 --seed
20260820 (1,000 backbone sequences and tree, 1,000 query fragments).
The trees run in turns A B B A, each in its own process, so the timings
come from one call on one card. Per run it prints one JSON line: the
tree, the wall time, and the runtime_breakdown.txt lines of the device
Forward scoring, the device gate, the alignment (device posterior+OA,
with the OA kernel's ms and launches) and the total; then one JSON line
comparing every run's aligned.fasta and aligned.masked.fasta with the
first run's, naming any row that differs.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def read_rows(path):
    rows, name = {}, None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                name = line[1:]
                rows[name] = []
            else:
                rows[name].append(line)
    return {k: "".join(v) for k, v in rows.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "compare_dna1k"))
    a = ap.parse_args()
    a.out = os.path.abspath(a.out)       # the runs' working directories differ
    trees = [os.path.abspath(t) for t in a.tree]
    turns = trees if len(trees) == 1 else \
        [trees[0], trees[1], trees[1], trees[0]]
    data = os.path.join(a.out, "data")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_scale_dataset.py"),
                    "--n", "1000", "--queries", "1000", "--seed", "20260820",
                    "--out", data], check=True, capture_output=True,
                   timeout=600)
    card = smi()
    outs = []
    for i, t in enumerate(turns):
        outdir = os.path.join(a.out, "run%d" % i)
        env = dict(os.environ, PYTHONPATH=t)
        t0 = time.time()
        r = subprocess.run(
            [sys.executable, "-m", "witch_tpu_torch",
             "-b", os.path.join(data, "backbone.aln.fasta.gz"),
             "-e", os.path.join(data, "backbone.tre"),
             "-q", os.path.join(data, "queries.fasta"),
             "-d", outdir, "-o", "aligned.fasta"],
            cwd=t, env=env, capture_output=True, text=True, timeout=1800)
        wall = time.time() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
            return r.returncode
        lines = [ln.split("\t", 1)[-1].strip() for ln in open(
            os.path.join(outdir, "runtime_breakdown.txt"))
            if "device Forward" in ln or "Total runtime" in ln
            or "all-vs-all Forward" in ln or "device gate" in ln
            or "posterior+OA" in ln]
        print(json.dumps(dict(tree=t, run=i, wall_s=wall, lines=lines,
                              card=card)), flush=True)
        outs.append(outdir)
    cmp = {}
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        ref = open(os.path.join(outs[0], f), "rb").read()
        same = [open(os.path.join(o, f), "rb").read() == ref for o in outs]
        diff = []
        if not all(same):
            r0 = read_rows(os.path.join(outs[0], f))
            for o in outs[1:]:
                ro = read_rows(os.path.join(o, f))
                diff += sorted(n for n in set(r0) | set(ro)
                               if r0.get(n) != ro.get(n))
        cmp[f] = dict(identical=all(same), rows_differ=sorted(set(diff)))
    print(json.dumps(dict(compare=cmp, runs=len(outs), card=card)))
    return 0 if all(v["identical"] for v in cmp.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
