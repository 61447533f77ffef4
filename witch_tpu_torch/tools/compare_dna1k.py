"""Run the seeded dna1k scenario D through the witch_tpu_torch CLI of two
(or more) checkouts of the repository on one host, and compare their
outputs byte for byte.

    python3 witch_tpu_torch/tools/compare_dna1k.py --tree A --tree B [--out DIR]
        [--full-search N] [--env I:KEY=VALUE ...] [--queries Q]
        [--serve]

The data is scripts/make_scale_dataset.py --n 1000 --queries 1000 --seed
20260820 (1,000 backbone sequences and tree, 1,000 query fragments);
--queries Q makes Q fragments instead (more alignment pairs per model).
With --full-search N the runs take its first N queries with
--full-search-results 1 (the device flank prefilter, then native domain
definition of the pairs it keeps). --env I:KEY=VALUE sets KEY in the
environment of the I-th --tree's runs (from 0): `--tree . --tree . --env
1:WITCH_TPU_SPEC_OA=0` compares one checkout with the speculative OA
start on and off; on a host of four cards `--tree . --tree . --tree .
--env 0:WITCH_TPU_NO_MESH=1 --env 1:CUDA_VISIBLE_DEVICES=0,1` scores on
1, 2 and 4 cards (the data mesh, parallel/mesh.py). With --serve each
run is one job through serve's job path (server._run_job, no card
index: on a host of several cards one query-shard rank a card) with
--save-weight 1, and weights.txt, ignored_queries.fasta and the
decomposition are compared too: on four cards `--serve --tree . --tree
. --env 0:WITCH_TPU_NO_MESH=1` holds four ranks against one card. The
trees run in
turns A B B A (A B C C B A for three), each in its own process, so the
timings come from one call. Per
run it prints one JSON line: the tree, the wall time, and the
runtime_breakdown.txt lines of the device Forward scoring, the device
gate (or prefilter, with the flank kernel's ms and launches), the native
domain definition, the exact-f32 overlay, the alignment (device
posterior+OA or its speculative join, with the OA kernel's ms and
launches), the per-query alignment stage and the total; then one JSON line comparing
every run's aligned.fasta, aligned.masked.fasta and persisted
hmmsearch.results.* files with the first run's, naming any row or file
that differs (with --serve, also weights.txt, ignored_queries.fasta and
the decomposition's model and input files). In the full-search mode each run records, through the
pipeline's own prefilter, the three-way decision of every pair and
whether its rows sit within 1e-3 of RT1, RT2 or RT3 (NEAR), and every
result entry that differs between runs is listed with its pair's
decision and nearness in each run.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# One CLI run in this process of a tree (argv: tree, output .npz, the CLI
# arguments), recording for --full-search-results the prefilter's
# decisions, whether each kept pair's rows sit within 1e-3 of RT1 (mocc),
# RT2 (mocc less the B or E posterior of the region's edge) or RT3 (a
# region's split mass), and the model index of each score column.
RUN = r"""
import sys
import numpy as np
tree, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path.insert(0, tree)
import witch_tpu_torch.hmm.flank_device as fd
import witch_tpu_torch.pipeline as pl
from witch_tpu_torch import witch_runner
seen = {}
orig_gate, orig_grid = pl._full_search_gate, fd.prefilter_grid


def near(mo, pb, pe, L, tol=1e-3):
    i = np.arange(1, L + 1)
    dB, dE = pb[i - 1], pe[i]
    if (np.abs(mo[i] - fd.RT1) < tol).any() or (np.abs(
            mo[i] - dB - fd.RT2) < tol).any() or (np.abs(
            mo[i] - dE - fd.RT2) < tol).any():
        return True
    bt = np.cumsum(np.concatenate([[0.0], pb[:L]]))
    et = np.cumsum(np.concatenate([[0.0], pe[1:L + 1]]))
    for a, b in fd.find_regions_rows(mo, pb, pe, L):
        ps = np.arange(a, b + 1)
        m = float(np.minimum(et[ps] - et[a - 1], bt[b] - bt[ps - 1]).max())
        if abs(m - fd.RT3) < tol:
            return True
    return False


def gate(ens, indices, *a, **kw):
    seen["indices"] = np.asarray(indices)
    return orig_gate(ens, indices, *a, **kw)


def grid(banks_t, bank_cols, codes, lens, H, **kw):
    dec, rows = orig_grid(banks_t, bank_cols, codes, lens, H, **kw)
    nr = np.zeros(dec.shape, bool)
    for j, (qs, mo, pb, pe) in rows.items():
        for t, q in enumerate(qs):
            nr[q, j] = near(mo[t], pb[t], pe[t], int(lens[q]))
    seen["dec"], seen["near"] = dec, nr
    return dec, rows


pl._full_search_gate, fd.prefilter_grid = gate, grid
witch_runner(argv)
np.savez(out, **seen)
"""
# One job of a tree through serve's job path (argv: tree, the CLI
# arguments).
SERVE = r"""
import sys
sys.path.insert(0, sys.argv[1])
from witch_tpu_torch import server
server._run_job(sys.argv[2:], None)
"""


def differing_entries(outs, names, diff_files):
    """Each result entry of diff_files that differs from the first run's,
    with its pair's decision and nearness in every run."""
    import ast
    import numpy as np
    rec = [np.load(os.path.join(o, "prefilter.npz")) for o in outs]
    q_of = {n: q for q, n in enumerate(names)}
    col = {int(idx): j for j, idx in enumerate(rec[0]["indices"])}
    found = []
    for f in diff_files:
        idx = int(f.rsplit("A_0_", 1)[1].split(".")[0])
        res = [ast.literal_eval(open(os.path.join(o, f)).read())
               for o in outs]
        for taxon in sorted(set().union(*res)):
            vals = [r.get(taxon) for r in res]
            if all(v == vals[0] for v in vals):
                continue
            q, j = q_of[taxon], col[idx]
            found.append(dict(
                model=idx, query=taxon, results=vals,
                decision=[int(r["dec"][q, j]) for r in rec],
                near=[bool(r["near"][q, j]) for r in rec]))
    return found


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
    ap.add_argument("--full-search", type=int, default=0)
    ap.add_argument("--env", action="append", default=[])
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--serve", action="store_true")
    a = ap.parse_args()
    a.out = os.path.abspath(a.out)       # the runs' working directories differ
    trees = [os.path.abspath(t) for t in a.tree]
    envs = [{} for _ in trees]
    for e in a.env:
        i, kv = e.split(":", 1)
        k, v = kv.split("=", 1)
        envs[int(i)][k] = v
    turns = list(range(len(trees)))
    if len(trees) > 1:
        turns += turns[::-1]
    data = os.path.join(a.out, "data")
    subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                 "make_scale_dataset.py"),
                    "--n", "1000", "--queries", str(a.queries),
                    "--seed", "20260820",
                    "--out", data], check=True, capture_output=True,
                   timeout=600)
    queries, extra = os.path.join(data, "queries.fasta"), []
    if a.full_search:
        rows = open(queries).read().split(">")[1:a.full_search + 1]
        queries = os.path.join(data, "queries_%d.fasta" % a.full_search)
        with open(queries, "w") as f:
            f.write("".join(">" + r for r in rows))
        extra = ["--full-search-results", "1"]
    if a.serve:
        extra.append("--save-weight")
        extra.append("1")
    card = smi()
    outs = []
    for i, ti in enumerate(turns):
        t = trees[ti]
        outdir = os.path.join(a.out, "run%d" % i)
        env = dict(os.environ, PYTHONPATH=t, **envs[ti])
        t0 = time.time()
        cli = ["-b", os.path.join(data, "backbone.aln.fasta.gz"),
               "-e", os.path.join(data, "backbone.tre"),
               "-q", queries, "-d", outdir, "-o", "aligned.fasta"] + extra
        run = ["-c", RUN, t, os.path.join(outdir, "prefilter.npz")] \
            if a.full_search else ["-m", "witch_tpu_torch"]
        if a.serve:
            run = ["-c", SERVE, t]
        r = subprocess.run([sys.executable] + run + cli, cwd=t, env=env,
                           capture_output=True, text=True, timeout=1800)
        wall = time.time() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
            return r.returncode
        lines = [ln.split("\t", 1)[-1].strip() for ln in open(
            os.path.join(outdir, "runtime_breakdown.txt"))
            if "device Forward" in ln or "Total runtime" in ln
            or "all-vs-all Forward" in ln or "device gate" in ln
            or "native domaindef" in ln or "posterior+OA" in ln
            or "overlay" in ln or "per-query alignment" in ln
            or "shard" in ln]
        print(json.dumps(dict(tree=t, env=envs[ti], run=i, wall_s=wall,
                              lines=lines, card=card)), flush=True)
        outs.append(outdir)
    cmp = {}
    files = ["aligned.fasta", "aligned.masked.fasta"]
    if a.serve:
        files += ["weights.txt", "ignored_queries.fasta"] + sorted(
            os.path.relpath(p, outs[0]) for p in glob.glob(os.path.join(
                outs[0], "tree_decomp", "root", "*", "hmmbuild.*")))

    def read(path):
        return open(path, "rb").read() if os.path.exists(path) else None

    for f in files:
        ref = read(os.path.join(outs[0], f))
        same = [read(os.path.join(o, f)) == ref for o in outs]
        diff = []
        if not all(same) and f.endswith(".fasta") and ref is not None:
            r0 = read_rows(os.path.join(outs[0], f))
            for o in outs[1:]:
                ro = read_rows(os.path.join(o, f))
                diff += sorted(n for n in set(r0) | set(ro)
                               if r0.get(n) != ro.get(n))
        cmp[f] = dict(identical=all(same), rows_differ=sorted(set(diff)))
    found = [{os.path.relpath(p, o): open(p, "rb").read() for p in glob.glob(
        os.path.join(o, "**", "hmmsearch.results.*"), recursive=True)}
        for o in outs]
    differ = sorted({n for x in found[1:] for n in set(x) | set(found[0])
                     if x.get(n) != found[0].get(n)})
    cmp["hmmsearch.results"] = dict(
        files=len(found[0]), identical=not differ, files_differ=differ)
    if a.full_search and differ:
        names = [ln[1:].strip() for ln in open(queries) if ln[0] == ">"]
        cmp["hmmsearch.results"]["entries_differ"] = differing_entries(
            outs, names, differ)
    print(json.dumps(dict(compare=cmp, runs=len(outs), card=card)))
    return 0 if all(v["identical"] for v in cmp.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
