"""Time the port's Forward scoring kernel on the bench grid, for one or
more checkouts of the repository, on one CUDA card.

    python3 witch_tpu_torch/tools/forward_bench.py [--tree DIR ...] [--reps N]

bench_assets.npz holds 141 models in two banks (Mp 1,312 and 2,720) and
500 queries, read by witch_tpu_torch/benchlib.py:load_bench_assets of
each tree (so a tree from before that module cannot be measured). Each
tree runs in its own process (the trees' packages share a name), in
turns A B B A for two trees, so both are measured in one call on one
card. Per tree and turn it prints one JSON line: CUDA
event ms per bank (mean of --reps launches after a warm-up), the plain
version's ms (one call) when --plain is given, the largest |dbits|
between kernel and plain, and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CHILD = r"""
import json, sys
import numpy as np
import torch
tree, reps, plain = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
sys.path.insert(0, tree)
from witch_tpu_torch.benchlib import load_bench_assets
from witch_tpu_torch.device import bank_to_torch
from witch_tpu_torch.ops.forward import LN2, forward_nats, forward_nats_ref
banks, z = load_bench_assets(sys.argv[4])
dev = torch.device("cuda")
c = torch.from_numpy(z["codes"]).to(dev)
ln = torch.from_numpy(z["lens"]).to(dev)
res = dict(tree=tree, banks=[])
for b in banks:
    bt = bank_to_torch(b, dev)
    k = forward_nats(bt, c, ln)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        forward_nats(bt, c, ln)
    ev[1].record()
    torch.cuda.synchronize()
    row = dict(H=bt.H, Mp=bt.Mp, ms=ev[0].elapsed_time(ev[1]) / reps)
    if plain:
        ev[0].record()
        p = forward_nats_ref(bt, c, ln, elems=1 << 26)
        ev[1].record()
        torch.cuda.synchronize()
        row["plain_ms"] = ev[0].elapsed_time(ev[1])
        row["max_dbits"] = float(((k - p).abs() / LN2).max())
    res["banks"].append(row)
res["ms"] = sum(r["ms"] for r in res["banks"])
print(json.dumps(res))
"""


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--plain", action="store_true")
    a = ap.parse_args()
    trees = [os.path.abspath(t) for t in (a.tree or [ROOT])]
    turns = trees if len(trees) == 1 else \
        [trees[0], trees[1], trees[1], trees[0]]
    card = smi()
    for t in turns:
        r = subprocess.run([sys.executable, "-c", CHILD, t, str(a.reps),
                            "1" if a.plain else "0",
                            os.path.join(ROOT, "bench_assets.npz")],
                           capture_output=True, text=True, timeout=1800)
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-3000:] + r.stderr[-3000:])
            return r.returncode
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["card"] = card
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
