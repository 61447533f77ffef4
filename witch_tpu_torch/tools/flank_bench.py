"""Time the port's flank kernel alone on the grids it runs on, for one or
two checkouts of the repository, on one CUDA card.

    python3 witch_tpu_torch/tools/flank_bench.py [--tree DIR ...] [--reps N]
        [--plain] [--first] [--sets bench,amino500,dna1k,dnawide]
        [--cache DIR] [--layouts]

The sets:
  bench     bench_assets.npz: 141 models in two banks (Mp 1,312 and
            2,720) x 500 queries, chip_smoke.py phase 2d's grid
  amino500  the --full-search-results grid of tests/golden/ref_amino500
            (500 queries x 19 models, Mp 416)
  dna1k     the --full-search-results grid of the first 60 queries of
            scripts/make_scale_dataset.py --n 1000 --queries 1000 --seed
            20260820 (scenario D; Mp 1,440 and 1,568)
  dnawide   the --full-search-results grid of the first 10 queries of
            make_scale_dataset.py --n 200 --queries 100 --cols 8000
            --seed 20261017 (7,110 columns, Mp 7,072 and 7,200: the
            cluster instance), chip_smoke.py phase 4wc's grid (not in the
            default sets)
The full-search grids are what the prefilter hands to
ops/flank.py:flank_rows, recorded once through this checkout's CLI and
cached as .npz files under --cache (default build/flank_bench).
Each tree runs in its own process (the trees' packages share a name), in
turns A B B A for two trees. Per tree, turn and set it prints one JSON
line: the CUDA-event ms of the set's flank_rows calls (mean of --reps
after a warm-up) and of their kernel launches alone (kernel_ms, events
around each launch), the launches, the pairs and DP cells (query length x
the model's own M), the layout of each width, and two bounds: the
operations (40 f32 operations per cell at 67 TFLOP/s) and the bytes the
kernel must move, rows_bytes_ms (per pair the outputs, 3 x 4 B x
(Lc + 1), and the stored Forward specials, 20 B a row written and read
back, at 3.35 TB/s); with --plain, on each set's 16 longest queries and
16 more at random against all its models, the largest |dfwd| and |drows|
against the plain version and its ms (one call); with --first, the first
version (first_version=True) on the same calls, once: its kernel ms and
launches; and the card's name and power limit. First, one JSON line of
the cluster barrier probe of the first tree that has one
(null2_bench.py:probe).

--layouts (this tree only) times the warp-per-pair kernel under other
(G warps, npl states per lane) register layouts than
ops/flank.py:flank_layout picks, on each width of the sets.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)
import null2_bench  # noqa: E402

DNA_FULL = 60                # dna1k queries of the full search
DNAWIDE_FULL = 10            # dnawide queries of the full search

RECORD = r"""
import os, sys
import numpy as np
root, which, data, out = sys.argv[1:5]
sys.path.insert(0, root)
sys.modules["jax"] = None
import witch_tpu_torch.hmm.flank_device as fd
from witch_tpu_torch import witch_runner
from witch_tpu_torch.io.fasta import read_fasta, write_fasta
calls = []
orig = fd.flank_rows
def rec(bt, codes, qlens):
    calls.append((bt, codes.cpu().numpy(), qlens.cpu().numpy()))
    return orig(bt, codes, qlens)
fd.flank_rows = rec
gold = os.path.join(root, "tests", "golden")
if which == "amino500":
    argv = ["-b", os.path.join(gold, "ref_amino500.backbone.fasta"),
            "-e", os.path.join(gold, "ref_amino500.backbone.tre"),
            "-q", os.path.join(gold, "ref_amino500.queries.fasta"),
            "--molecule", "amino"]
else:
    q = os.path.join(data, "queries_full.fasta")
    write_fasta(list(read_fasta(os.path.join(data, "queries.fasta")))
                [:int(sys.argv[5])], q)
    argv = ["-b", os.path.join(data, "backbone.aln.fasta.gz"),
            "-e", os.path.join(data, "backbone.tre"), "-q", q]
argv += ["-d", os.path.join(data, "out_full_" + which), "-o",
         "aligned.fasta", "--full-search-results", "1"]
witch_runner(argv)
arrs = {}
for c, (bt, codes, lens) in enumerate(calls):
    arrs["em%d" % c] = bt.em.cpu().numpy()
    arrs["trans%d" % c] = bt.trans.cpu().numpy()
    arrs["M%d" % c] = np.asarray(bt.M, np.int32)
    arrs["pad%d" % c] = np.int32(bt.pad_code)
    arrs["codes%d" % c] = codes
    arrs["lens%d" % c] = lens
arrs["n_calls"] = np.int32(len(calls))
np.savez_compressed(out, **arrs)
print("recorded %d calls, %d pairs" % (
    len(calls), sum(len(l) * bt.H for bt, _, l in calls)))
"""

CHILD = r"""
import json, os, sys, types
import numpy as np
import torch
tree, reps, plain, layouts, first = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3] == "1", sys.argv[4] == "1", sys.argv[5] == "1"
names = sys.argv[6].split(",")
paths = sys.argv[7:]
sys.path.insert(0, tree)
sys.modules["jax"] = None
from witch_tpu_torch import _build
from witch_tpu_torch.device import BankTensors, bank_to_torch
import witch_tpu_torch.ops.flank as FL
dev = torch.device("cuda")
F32_OPS, HBM = 67e12, 3.35e12


# The kernel library with a CUDA-event pair around each flank launch, so
# that kernel_ms leaves out the wrapper's host work between them.
class Timed:

    def __init__(self, so):
        self.so, self.events = so, []

    def __getattr__(self, name):
        fn = getattr(self.so, name)
        if not name.startswith("witch_flank"):
            return fn

        def launch(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            rc = fn(*a)
            ev[1].record()
            self.events.append(ev)
            return rc
        return launch

    def take_ms(self):
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events = []
        return ms


LIB = Timed(_build.lib())
_build._lib = LIB


def load(path):
    z = np.load(path)
    calls = []
    for c in range(int(z["n_calls"])):
        bt = BankTensors(em=torch.from_numpy(z["em%d" % c]).to(dev),
                         trans=torch.from_numpy(z["trans%d" % c]).to(dev),
                         M=z["M%d" % c], pad_code=int(z["pad%d" % c]))
        calls.append((bt, torch.from_numpy(z["codes%d" % c]).to(dev),
                      torch.from_numpy(z["lens%d" % c]).to(dev)))
    return calls


def bench_set():
    z = np.load(os.path.join(tree, "bench_assets.npz"))
    fields = ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm",
              "t_dd", "bm", "M")
    c = torch.from_numpy(z["codes"]).to(dev)
    ln = torch.from_numpy(z["lens"]).to(dev)
    return [(bank_to_torch(types.SimpleNamespace(
        **{f: z["bank%d_%s" % (i, f)] for f in fields}), dev), c, ln)
        for i in range(int(z["n_banks"]))]


def run(calls):
    for bt, c, ln in calls:
        FL.flank_rows(bt, c, ln)
    torch.cuda.synchronize()
    LIB.take_ms()
    _build.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        for bt, c, ln in calls:
            FL.flank_rows(bt, c, ln)
    ev[1].record()
    torch.cuda.synchronize()
    return (ev[0].elapsed_time(ev[1]) / reps, LIB.take_ms() / reps,
            _build.LAUNCHES["flank"] // reps)


def run_first(calls):
    # the first version on the same calls, once
    LIB.take_ms()
    _build.reset_launches()
    for bt, c, ln in calls:
        FL.flank_rows(bt, c, ln, first_version=True)
    return dict(ms_first_version=LIB.take_ms(),
                launches_first_version=_build.LAUNCHES["flank"])


def layout_of(Mp):
    lay = getattr(FL, "flank_layout", None)
    return list(lay(Mp)) if lay else "first version"


def stats(calls):
    cells = float(sum(float(np.asarray(bt.M, np.float64).sum())
                      * float(ln.sum()) for bt, _, ln in calls))
    pairs = sum(bt.H * len(ln) for bt, _, ln in calls)
    nbytes = float(sum(bt.H * (12 * len(ln) * (c.shape[1] + 1)
                               + 40 * float((ln + 1).sum()))
                       for bt, c, ln in calls))
    return dict(pairs=pairs, cells=cells,
                bound_ops_ms=40 * cells / F32_OPS * 1e3,
                rows_bytes_ms=nbytes / HBM * 1e3,
                layouts={str(bt.Mp): layout_of(bt.Mp) for bt, _, _ in calls})


def against_plain(calls):
    # each set's 16 longest queries and 16 more at random, all models
    ef = er = ms = 0.0
    for bt, c, ln in calls:
        order = torch.argsort(ln, descending=True, stable=True).cpu().numpy()
        rng = np.random.default_rng(1009)
        pick = list(order[:16]) + list(rng.choice(
            order[16:], min(16, max(0, len(order) - 16)), replace=False))
        s = torch.as_tensor(sorted(pick), device=dev)
        cs, ls = c[s], ln[s]
        k = FL.flank_rows(bt, cs, ls)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        p = FL.flank_rows_ref(bt, cs, ls, elems=1 << 26)
        ev[1].record()
        torch.cuda.synchronize()
        ms += ev[0].elapsed_time(ev[1])
        ef = max(ef, float((k[0] - p[0]).abs().max()))
        er = max(er, max(float((a - b).abs().max())
                         for a, b in zip(k[1:], p[1:])))
    return dict(plain_queries=32, max_dfwd=ef, max_drows=er, plain_ms=ms)


sets = [(n, bench_set() if n == "bench" else load(p))
        for n, p in zip(names, paths)]
if not layouts:
    for name, calls in sets:
        ms, kernel_ms, launches = run(calls)
        res = dict(tree=tree, set=name, ms=ms, kernel_ms=kernel_ms,
                   launches=launches, **stats(calls))
        if plain:
            res.update(against_plain(calls))
        if first:
            res.update(run_first(calls))
        print(json.dumps(res), flush=True)
    sys.exit(0)
from witch_tpu_torch.ops.forward import FWD_NPL
chosen = FL.flank_layout
for name, calls in sets:
    for Mp in sorted({bt.Mp for bt, _, _ in calls}):
        part = [x for x in calls if x[0].Mp == Mp]
        ref = [FL.flank_rows(*x) for x in part]
        for G in range(1, FL.FLANK_WARPS + 1):
            for npl in FWD_NPL:
                Mpad = 32 * G * npl
                if Mpad < Mp or Mpad - Mp >= 32 * G * 8 or \
                        32 * (G - 1) * npl >= Mp or \
                        FL.smem_bytes(G, Mpad) > _build.SMEM_ROWS_MAX:
                    continue      # too narrow, a step of padding, a warp idle
                FL.flank_layout = lambda m, G=G, npl=npl, Mpad=Mpad: (
                    0, G, npl, Mpad)
                try:
                    err = 0.0
                    for x, r in zip(part, ref):
                        got = FL.flank_rows(*x)
                        err = max(err, max(float((a - b).abs().max())
                                           for a, b in zip(got, r)))
                    ms, kernel_ms, launches = run(part)
                    print(json.dumps(dict(
                        set=name, Mp=Mp, G=G, npl=npl,
                        chosen=chosen(Mp)[1:3] == (G, npl), ms=ms,
                        kernel_ms=kernel_ms, max_abs_vs_chosen=err)),
                        flush=True)
                finally:
                    FL.flank_layout = chosen
"""


def record(which, cache):
    """The set's flank_rows calls through this checkout's CLI, cached."""
    out = os.path.join(cache, which + ".npz")
    if os.path.exists(out):
        return out
    data = null2_bench.make_data(which, cache)
    r = subprocess.run([sys.executable, "-c", RECORD, ROOT, which, data,
                        out, str(DNAWIDE_FULL if which == "dnawide"
                                 else DNA_FULL)],
                       capture_output=True, text=True, timeout=1800)
    if r.returncode != 0:
        raise RuntimeError("recording %s failed:\n%s" % (
            which, r.stdout[-3000:] + r.stderr[-3000:]))
    print(json.dumps(dict(recorded=which, note=r.stdout.strip()[-200:])),
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--layouts", action="store_true")
    ap.add_argument("--first", action="store_true")
    ap.add_argument("--sets", default="bench,amino500,dna1k")
    ap.add_argument("--cache", default=os.path.join(ROOT, "build",
                                                    "flank_bench"))
    a = ap.parse_args()
    os.makedirs(a.cache, exist_ok=True)
    names = [s for s in a.sets.split(",") if s]
    paths = [("-" if s == "bench" else record(s, a.cache)) for s in names]
    trees = [os.path.abspath(t) for t in (a.tree or [ROOT])]
    if a.layouts:
        trees = trees[:1]
    turns = trees if len(trees) == 1 else \
        [trees[0], trees[1], trees[1], trees[0]]
    card = null2_bench.smi()
    null2_bench.probe(trees[0], card)
    for t in turns:
        r = subprocess.run([sys.executable, "-c", CHILD, t, str(a.reps),
                            "1" if a.plain else "0",
                            "1" if a.layouts else "0",
                            "1" if a.first else "0", ",".join(names)]
                           + paths, capture_output=True, text=True,
                           timeout=3000)
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                res = json.loads(line)
                res["card"] = card
                print(json.dumps(res), flush=True)
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
