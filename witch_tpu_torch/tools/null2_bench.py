"""Time the port's null2 kernel alone on recorded gate envelopes, for one
or two checkouts of the repository, on one CUDA card.

    python3 witch_tpu_torch/tools/null2_bench.py [--tree DIR ...] [--reps N]
        [--plain] [--sets amino500,dna1k,scenA] [--cache DIR] [--layouts]

The envelope sets are what the port's gate hands to
ops/null2.py:null2_envelopes, recorded once through this checkout's CLI
and cached as .npz files under --cache (default build/null2_bench):
  amino500  tests/golden/ref_amino500 (19 models, Mp 416)
  dna1k     scripts/make_scale_dataset.py --n 1000 --queries 1000 --seed
            20260820, scenario D (Mp 1,440 and 1,568)
  scenA     make_scale_dataset.py --n 300 --queries 100 --seed 20261016
            as one -i input with --backbone-size 100 (long envelopes)
Each tree runs in its own process (the trees' packages share a name), in
turns A B B A for two trees. Per tree, turn and set it prints one JSON
line: the kernel's CUDA-event ms over the set's calls (mean of --reps
after a warm-up), its launches, the host-clock seconds of the gate's
entry (null2_envelopes: pack, upload, kernel, copy back) on its first
call in the process and again, the envelopes and DP cells, the
operations bound (45 f32 operations per cell at 67 TFLOP/s) and the
stored rows' bytes (16 B per state-row) at 3.35 TB/s, with --plain the
plain version's ms (one call) and the largest relative error
|k - p| / max(|p|, floor) (floor 1 nat for envsc, 1e-2 for the usage
terms, as chip_smoke.py holds them), and the card's name and power
limit.

--layouts (this tree only) times other (G warps, npl states per lane)
register layouts than ops/null2.py:n2_layout picks, on each set and on
envelopes cut from bench_assets.npz's Mp 2,720 bank.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The CLI arguments of a set (amino500, dna1k or scenA) on its data
# directory; a recorder script defines root, which and data first.
SET_ARGV = r"""
gold = os.path.join(root, "tests", "golden")
if which == "amino500":
    argv = ["-b", os.path.join(gold, "ref_amino500.backbone.fasta"),
            "-e", os.path.join(gold, "ref_amino500.backbone.tre"),
            "-q", os.path.join(gold, "ref_amino500.queries.fasta"),
            "--molecule", "amino"]
elif which in ("dna1k", "dnawide"):
    argv = ["-b", os.path.join(data, "backbone.aln.fasta.gz"),
            "-e", os.path.join(data, "backbone.tre"),
            "-q", os.path.join(data, "queries.fasta")]
else:
    argv = ["-i", os.path.join(data, "input.fasta"), "--backbone-size", "100"]
argv += ["-d", os.path.join(data, "out_" + which), "-o", "aligned.fasta"]
"""

RECORD = r"""
import os, sys
import numpy as np
root, which, data, out = sys.argv[1:5]
sys.path.insert(0, root)
sys.modules["jax"] = None
import witch_tpu_torch.hmm.gate_device as gd
from witch_tpu_torch import witch_runner
calls = []
orig = gd.null2_envelopes
def rec(bt, entries):
    calls.append((bt, list(entries)))
    return orig(bt, entries)
gd.null2_envelopes = rec
""" + SET_ARGV + r"""
witch_runner(argv)
arrs = {}
for c, (bt, entries) in enumerate(calls):
    arrs["em%d" % c] = bt.em.cpu().numpy()
    arrs["trans%d" % c] = bt.trans.cpu().numpy()
    arrs["M%d" % c] = np.asarray(bt.M, np.int32)
    arrs["pad%d" % c] = np.int32(bt.pad_code)
    arrs["row%d" % c] = np.array([r for r, _, _ in entries], np.int32)
    arrs["lfull%d" % c] = np.array([lf for _, _, lf in entries], np.int32)
    arrs["ld%d" % c] = np.array([len(s) for _, s, _ in entries], np.int32)
    arrs["codes%d" % c] = (np.concatenate([s for _, s, _ in entries])
                           .astype(np.uint8) if entries
                           else np.zeros(0, np.uint8))
arrs["n_calls"] = np.int32(len(calls))
np.savez_compressed(out, **arrs)
print("recorded %d calls, %d envelopes" % (
    len(calls), sum(len(e) for _, e in calls)))
"""

CHILD = r"""
import json, sys, time
import numpy as np
import torch
tree, reps, plain, layouts = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3] == "1", sys.argv[4] == "1"
paths = sys.argv[5:]
sys.path.insert(0, tree)
sys.modules["jax"] = None
from witch_tpu_torch import _build
from witch_tpu_torch.device import BankTensors
import witch_tpu_torch.ops.null2 as N2
dev = torch.device("cuda")
F32_OPS, HBM = 67e12, 3.35e12


def load(path):
    z = np.load(path)
    calls = []
    for c in range(int(z["n_calls"])):
        bt = BankTensors(em=torch.from_numpy(z["em%d" % c]).to(dev),
                         trans=torch.from_numpy(z["trans%d" % c]).to(dev),
                         M=z["M%d" % c], pad_code=int(z["pad%d" % c]))
        ld = z["ld%d" % c]
        flat = z["codes%d" % c].astype(np.int32)
        cut = np.concatenate([[0], np.cumsum(ld)])
        entries = [(int(r), flat[cut[t]:cut[t + 1]], int(lf)) for t, (r, lf)
                   in enumerate(zip(z["row%d" % c], z["lfull%d" % c]))]
        calls.append((bt, entries))
    return calls


def bench_assets_set():
    # envelopes cut from bench_assets.npz's Mp 2,720 bank: 600 seeded
    # windows of its queries (lengths 20 to the query's)
    import os
    from witch_tpu_torch.device import bank_to_torch
    import types
    z = np.load(os.path.join(tree, "bench_assets.npz"))
    fields = ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm",
              "t_dd", "bm", "M")
    b = types.SimpleNamespace(**{f: z["bank1_%s" % f] for f in fields})
    bt = bank_to_torch(b, dev)
    rng = np.random.default_rng(2720)
    entries = []
    for _ in range(600):
        q = int(rng.integers(0, len(z["lens"])))
        L = int(z["lens"][q])
        n = int(rng.integers(min(20, L), L + 1))
        a = int(rng.integers(0, L - n + 1))
        entries.append((int(rng.integers(0, bt.H)),
                        np.ascontiguousarray(z["codes"][q, a:a + n]), L))
    return [(bt, entries)]


def run(calls):
    packs = [(bt, N2._pack(e, dev)) for bt, e in calls if e]
    for bt, pk in packs:
        N2.null2_nats(bt, *pk)
    torch.cuda.synchronize()
    _build.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        for bt, pk in packs:
            N2.null2_nats(bt, *pk)
    ev[1].record()
    torch.cuda.synchronize()
    return packs, ev[0].elapsed_time(ev[1]) / reps, \
        _build.LAUNCHES["null2"] // reps


def stats(calls):
    cells = float(sum(len(s) * int(bt.M[r]) for bt, e in calls
                      for r, s, _ in e))
    return dict(envelopes=sum(len(e) for _, e in calls), cells=cells,
                bound_ops_ms=45 * cells / F32_OPS * 1e3,
                rows_bytes_ms=16 * cells / HBM * 1e3,
                widths=sorted({bt.Mp for bt, e in calls if e}))


def errors(packs):
    worst, t = 0.0, 0.0
    for bt, pk in packs:
        sk, dk = N2.null2_nats(bt, *pk)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        sp, dp = N2.null2_nats_ref(bt, *pk, chunk=256)
        ev[1].record()
        torch.cuda.synchronize()
        t += ev[0].elapsed_time(ev[1])
        for a, b, floor in ((sk[:, :1], sp[:, :1], 1.0),
                            (sk[:, 1:], sp[:, 1:], 1e-2), (dk, dp, 1e-2)):
            worst = max(worst, float(((a - b).abs()
                                      / b.abs().clamp(min=floor)).max()))
    return worst, t


def gate_call(calls):
    # the gate's own entry, host clock: pack, upload, kernel, copy back
    t = time.time()
    for bt, e in calls:
        N2.null2_envelopes(bt, e)
    return time.time() - t


sets = [(p.rsplit("/", 1)[-1][:-4], load(p)) for p in paths]
if not layouts:
    for name, calls in sets:
        first = gate_call(calls)
        again = gate_call(calls)
        packs, ms, launches = run(calls)
        res = dict(tree=tree, set=name, ms=ms, launches=launches,
                   envelopes_call_s=again, first_envelopes_call_s=first,
                   **stats(calls))
        if plain:
            res["max_rel_err"], res["plain_ms"] = errors(packs)
        print(json.dumps(res), flush=True)
    sys.exit(0)
sets.append(("bench2720", bench_assets_set()))
chosen = N2.n2_layout
CANDIDATES = [(G, npl) for npl in N2.N2_NPL
              for G in range(1, N2.N2_WARPS + 1)]
for name, calls in sets:
    for Mp in sorted({bt.Mp for bt, e in calls if e}):
        part = [(bt, e) for bt, e in calls if e and bt.Mp == Mp]
        ref = [N2.null2_nats(bt, *N2._pack(e, dev)) for bt, e in part]
        for G, npl in CANDIDATES:
            Mpad = 32 * G * npl
            if Mpad < Mp or Mpad - Mp >= 32 * G * 8 or \
                    32 * (G - 1) * npl >= Mp:
                continue          # too narrow, a step of padding, a warp idle
            if N2._smem_bytes(True, G, Mpad) > _build.SMEM_ROWS_MAX:
                continue
            N2.n2_layout = lambda m, G=G, npl=npl, Mpad=Mpad: (0, G, npl,
                                                               Mpad)
            try:
                got = [N2.null2_nats(bt, *N2._pack(e, dev)) for bt, e in part]
                err = 0.0
                for (a, b), (c, d) in zip(got, ref):
                    for x, y in ((a, c), (b, d)):
                        err = max(err, float(((x - y).abs() / y.abs().clamp(
                            min=1e-2)).max()))
                _, ms, launches = run(part)
                print(json.dumps(dict(set=name, Mp=Mp, G=G, npl=npl,
                                      chosen=chosen(Mp)[1:3] == (G, npl),
                                      ms=ms, max_rel_vs_chosen=err,
                                      **stats(part))), flush=True)
            finally:
                N2.n2_layout = chosen
"""


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


# The thread-block cluster meeting of a tree's ops/cluster.py (the OA and
# flank kernels' cluster instances cross it once to three times a DP row)
PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.modules["jax"] = None
from witch_tpu_torch.ops.cluster import barrier_probe
print(json.dumps(dict(cluster_probe=barrier_probe((2, 4, 8)))))
"""


def probe(tree, card):
    """Print one JSON line of the tree's cluster barrier probe
    (ops/cluster.py:barrier_probe: ns a meeting, the barrier alone and
    with a DSMEM exchange of one record, C = 2, 4 and 8, one cluster and
    every co-resident one), if the tree has it."""
    if not os.path.exists(os.path.join(tree, "witch_tpu_torch", "ops",
                                       "cluster.py")):
        return
    r = subprocess.run([sys.executable, "-c", PROBE, tree],
                       capture_output=True, text=True, timeout=600)
    for line in r.stdout.splitlines():
        if line.startswith("{"):
            res = json.loads(line)
            res.update(tree=tree, card=card)
            print(json.dumps(res), flush=True)
    if r.returncode != 0:
        raise RuntimeError("cluster probe failed:\n" + r.stderr[-3000:])


def make_data(which, cache):
    """The data directory of a set (amino500 reads tests/golden)."""
    data = os.path.join(cache, "data_" + which)
    os.makedirs(data, exist_ok=True)
    gen = [sys.executable, os.path.join(ROOT, "scripts",
                                        "make_scale_dataset.py")]
    if which == "dna1k":
        subprocess.run(gen + ["--n", "1000", "--queries", "1000", "--seed",
                              "20260820", "--out", data], check=True,
                       capture_output=True, timeout=600)
    elif which == "dnawide":
        subprocess.run(gen + ["--n", "200", "--queries", "100", "--cols",
                              "8000", "--seed", "20261017", "--out", data],
                       check=True, capture_output=True, timeout=600)
    elif which == "scenA":
        subprocess.run(gen + ["--n", "300", "--queries", "100", "--seed",
                              "20261016", "--out", data], check=True,
                       capture_output=True, timeout=600)
        sys.path.insert(0, ROOT)
        from witch_tpu_torch.io.fasta import read_fasta, write_fasta
        recs = [(n, s.replace("-", "").upper()) for n, s in read_fasta(
            os.path.join(data, "backbone.aln.fasta.gz"))]
        recs += [(n, s.upper()) for n, s in read_fasta(
            os.path.join(data, "queries.fasta"))]
        write_fasta(recs, os.path.join(data, "input.fasta"))
    return data


def record(which, cache, script=RECORD):
    """The set's inputs through this checkout's CLI, recorded by `script`
    (argv: root, set, data directory, output .npz), cached."""
    out = os.path.join(cache, which + ".npz")
    if os.path.exists(out):
        return out
    data = make_data(which, cache)
    r = subprocess.run([sys.executable, "-c", script, ROOT, which, data,
                        out], capture_output=True, text=True, timeout=1800)
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
    ap.add_argument("--sets", default="amino500,dna1k,scenA")
    ap.add_argument("--cache", default=os.path.join(ROOT, "build",
                                                    "null2_bench"))
    a = ap.parse_args()
    os.makedirs(a.cache, exist_ok=True)
    paths = [record(s, a.cache) for s in a.sets.split(",") if s]
    trees = [os.path.abspath(t) for t in (a.tree or [ROOT])]
    if a.layouts:
        trees = trees[:1]
    turns = trees if len(trees) == 1 else \
        [trees[0], trees[1], trees[1], trees[0]]
    card = smi()
    for t in turns:
        r = subprocess.run([sys.executable, "-c", CHILD, t, str(a.reps),
                            "1" if a.plain else "0",
                            "1" if a.layouts else "0"] + paths,
                           capture_output=True, text=True, timeout=3000)
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
