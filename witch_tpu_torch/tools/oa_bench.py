"""Time the port's posterior+OA kernel alone on recorded alignment pairs,
for one or two checkouts of the repository, on one CUDA card.

    python3 witch_tpu_torch/tools/oa_bench.py [--tree DIR ...] [--reps N]
        [--plain] [--first] [--sets amino500,dna1k,bench,dnawide]
        [--cache DIR]

The pair sets are what the port's aligner hands to ops/oa.py:oa_columns,
recorded once through this checkout's CLI (null2_bench.py's data and
recorder) and cached as .npz files under --cache (default
build/oa_bench):
  amino500  tests/golden/ref_amino500 (19 models, Mp 416)
  dna1k     scripts/make_scale_dataset.py --n 1000 --queries 1000 --seed
            20260820, scenario D (Mp 1,440 and 1,568)
  bench     256 seeded pairs of bench_assets.npz, 128 on each bank (Mp
            1,312 and 2,720), the pairs chip_smoke.py's phase 2c takes
  dnawide   make_scale_dataset.py --n 200 --queries 100 --cols 8000
            --seed 20261017, scenario D (7,110 columns; Mp 7,072 and
            7,200: the cluster instance), chip_smoke.py phase 4w's pairs
            (not in the default sets: its recording takes a few minutes)
Each tree runs in its own process (the trees' packages share a name), in
turns A B B A for two trees. Per tree, turn and set it prints one JSON
line: the CUDA-event ms of the set's oa_nats calls (mean of --reps after
a warm-up; with the wrapper's host work between launches) and of their
kernel launches alone (kernel_ms, events around each launch), the
launches, the pairs and DP cells (query
length x the model's own M), the widths, and two bounds: the
operations (the OA DP's 14 per cell at the card's f64 rate, 34 TFLOP/s,
the other 44 at the f32 rate, 67 TFLOP/s) and the stored rows (17 B per
state-row at the tree's padded width: Backward M and I written and read
back, the pointer byte written) at 3.35 TB/s; with --plain, on a seeded
sample of the set (its 64 longest pairs and 64 more at random), the
above-guard column mismatches against the plain version and the largest
margin difference; with --first, the first version
(first_version=True) on the same calls, one call a group: its kernel
ms and launches; and the card's name and power limit. First, one JSON
line of the cluster barrier probe of the first tree that has one
(null2_bench.py:probe).
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

RECORD = r"""
import os, sys
import numpy as np
root, which, data, out = sys.argv[1:5]
sys.path.insert(0, root)
sys.modules["jax"] = None
import witch_tpu_torch.aligner as al
from witch_tpu_torch import witch_runner
calls = []
orig = al.oa_columns
def rec(banks_t, bank_row, pairs, Ldmax=0):
    calls.append((banks_t, dict(bank_row), list(pairs), Ldmax))
    return orig(banks_t, bank_row, pairs, Ldmax=Ldmax)
al.oa_columns = rec
""" + null2_bench.SET_ARGV + r"""
witch_runner(argv)
arrs = {}
g = 0
for banks_t, bank_row, pairs, Ldmax in calls:
    by_bank = {}
    for idx, c in pairs:
        bi, row = bank_row[int(idx)]
        by_bank.setdefault(bi, []).append((row, c))
    for bi, lst in sorted(by_bank.items()):
        bt = banks_t[bi]
        arrs["em%d" % g] = bt.em.cpu().numpy()
        arrs["trans%d" % g] = bt.trans.cpu().numpy()
        arrs["M%d" % g] = np.asarray(bt.M, np.int32)
        arrs["pad%d" % g] = np.int32(bt.pad_code)
        arrs["row%d" % g] = np.array([r for r, _ in lst], np.int32)
        arrs["len%d" % g] = np.array([len(c) for _, c in lst], np.int32)
        arrs["codes%d" % g] = np.concatenate([c for _, c in lst]).astype(
            np.uint8)
        arrs["ldmax%d" % g] = np.int32(Ldmax)
        g += 1
arrs["n_groups"] = np.int32(g)
np.savez_compressed(out, **arrs)
print("recorded %d calls, %d groups, %d pairs" % (
    len(calls), g, sum(len(p) for _, _, p, _ in calls)))
"""

CHILD = r"""
import json, sys
import numpy as np
import torch
tree, reps, plain, first = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3] == "1", sys.argv[4] == "1"
names = sys.argv[5].split(",")
paths = sys.argv[6:]
sys.path.insert(0, tree)
sys.modules["jax"] = None
from witch_tpu_torch import _build
from witch_tpu_torch.device import BankTensors
import witch_tpu_torch.ops.oa as OA
dev = torch.device("cuda")
F64_OPS, F32_OPS, HBM, GUARD = 34e12, 67e12, 3.35e12, 2e-3


# The kernel library with a CUDA-event pair around each OA launch, so
# that kernel_ms leaves out the wrapper's host work between them.
class Timed:

    def __init__(self, so):
        self.so, self.events = so, []

    def __getattr__(self, name):
        fn = getattr(self.so, name)
        if not name.startswith("witch_oa"):
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
    groups = []
    for g in range(int(z["n_groups"])):
        bt = BankTensors(em=torch.from_numpy(z["em%d" % g]).to(dev),
                         trans=torch.from_numpy(z["trans%d" % g]).to(dev),
                         M=z["M%d" % g], pad_code=int(z["pad%d" % g]))
        ln = z["len%d" % g]
        flat = z["codes%d" % g].astype(np.int32)
        cut = np.concatenate([[0], np.cumsum(ln)])
        pairs = [(int(r), flat[cut[t]:cut[t + 1]])
                 for t, r in enumerate(z["row%d" % g])]
        groups.append((bt, pairs, int(z["ldmax%d" % g])))
    return groups


def bench_set():
    # chip_smoke.py phase 2c's pairs: 128 seeded (model, query) pairs on
    # each bench_assets bank
    import os
    import types
    from witch_tpu_torch.device import bank_to_torch
    z = np.load(os.path.join(tree, "bench_assets.npz"))
    fields = ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm",
              "t_dd", "bm", "M")
    codes, lens = z["codes"], z["lens"]
    rng = np.random.default_rng(7)
    groups = []
    for bi in range(int(z["n_banks"])):
        b = types.SimpleNamespace(**{f: z["bank%d_%s" % (bi, f)]
                                     for f in fields})
        bt = bank_to_torch(b, dev)
        hs = rng.integers(0, bt.H, 128)
        qs = rng.integers(0, len(lens), 128)
        groups.append((bt, [(int(h), np.ascontiguousarray(codes[q, :lens[q]]))
                            for h, q in zip(hs, qs)], int(lens.max())))
    return groups


def padded(Mp):
    lay = getattr(OA, "oa_layout", None)
    return lay(Mp)[3] if lay else Mp


def run(groups):
    packs = [(bt, OA.pack_pairs(bt, pr), ld) for bt, pr, ld in groups]
    for bt, pk, ld in packs:
        OA.oa_nats(bt, *pk, Ldmax=ld)
    torch.cuda.synchronize()
    LIB.take_ms()
    _build.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        for bt, pk, ld in packs:
            OA.oa_nats(bt, *pk, Ldmax=ld)
    ev[1].record()
    torch.cuda.synchronize()
    return (ev[0].elapsed_time(ev[1]) / reps, LIB.take_ms() / reps,
            _build.LAUNCHES["oa"] // reps)


def run_first(groups):
    # the first version on the same calls, one call a group
    LIB.take_ms()
    _build.reset_launches()
    for bt, pr, ld in groups:
        OA.oa_nats(bt, *OA.pack_pairs(bt, pr), Ldmax=ld, first_version=True)
    return dict(ms_first_version=LIB.take_ms(),
                launches_first_version=_build.LAUNCHES["oa"])


def stats(groups):
    cells = float(sum(len(c) * int(bt.M[r]) for bt, pr, _ in groups
                      for r, c in pr))
    padc = float(sum(len(c) * padded(bt.Mp) for bt, pr, _ in groups
                     for _, c in pr))
    return dict(pairs=sum(len(pr) for _, pr, _ in groups), cells=cells,
                bound_ops_ms=cells * (14 / F64_OPS + 44 / F32_OPS) * 1e3,
                rows_bytes_ms=17 * padc / HBM * 1e3,
                widths=sorted({bt.Mp for bt, pr, _ in groups if pr}),
                padded=sorted({padded(bt.Mp) for bt, pr, _ in groups if pr}))


def against_plain(groups):
    # the 64 longest pairs of the set and 64 more at random
    flat = [(g, t, len(c)) for g, (_, pr, _) in enumerate(groups)
            for t, (_, c) in enumerate(pr)]
    order = sorted(range(len(flat)), key=lambda u: -flat[u][2])
    pick = set(order[:64])
    rest = order[64:]
    rng = np.random.default_rng(1017)
    if rest:
        pick |= {rest[u] for u in rng.choice(len(rest), min(64, len(rest)),
                                             replace=False)}
    bad = n = 0
    dm = 0.0
    for g, (bt, pr, ld) in enumerate(groups):
        sub = [pr[t] for gg, t, _ in (flat[u] for u in sorted(pick))
               if gg == g]
        if not sub:
            continue
        pk = OA.pack_pairs(bt, sub)
        ck, sk = OA.oa_nats(bt, *pk, Ldmax=ld)
        cp, sp = OA.oa_ref(bt, *pk)
        ck, sk, cp, sp = (x.cpu().numpy() for x in (ck, sk, cp, sp))
        off = pk[3].cpu().numpy()
        for t, (_, c) in enumerate(sub):
            a, b = off[t], off[t] + len(c)
            if sk[t, 0] >= GUARD and sk[t, 1] > 0.5 \
                    and not np.array_equal(ck[a:b], cp[a:b]):
                bad += 1
        fin = np.isfinite(sk[:, 0]) & np.isfinite(sp[:, 0])
        if fin.any():
            dm = max(dm, float(np.abs(sk[fin, 0] - sp[fin, 0]).max()))
        n += len(sub)
    return dict(plain_pairs=n, above_guard_mismatches=bad,
                max_margin_diff=dm)


for name, path in zip(names, paths):
    groups = bench_set() if name == "bench" else load(path)
    ms, kernel_ms, launches = run(groups)
    res = dict(tree=tree, set=name, ms=ms, kernel_ms=kernel_ms,
               launches=launches, **stats(groups))
    if plain:
        res.update(against_plain(groups))
    if first:
        res.update(run_first(groups))
    print(json.dumps(res), flush=True)
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--first", action="store_true")
    ap.add_argument("--sets", default="amino500,dna1k,bench")
    ap.add_argument("--cache", default=os.path.join(ROOT, "build",
                                                    "oa_bench"))
    a = ap.parse_args()
    os.makedirs(a.cache, exist_ok=True)
    names = [s for s in a.sets.split(",") if s]
    paths = [("-" if s == "bench" else
              null2_bench.record(s, a.cache, RECORD)) for s in names]
    trees = [os.path.abspath(t) for t in (a.tree or [ROOT])]
    turns = trees if len(trees) == 1 else \
        [trees[0], trees[1], trees[1], trees[0]]
    card = null2_bench.smi()
    null2_bench.probe(trees[0], card)
    for t in turns:
        r = subprocess.run([sys.executable, "-c", CHILD, t, str(a.reps),
                            "1" if a.plain else "0",
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
