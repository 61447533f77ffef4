"""The bench tier of the port on one CUDA card: the full bench grid of
bench_assets.npz (141 models x 500 queries) through the Forward scoring
kernel, and the JSON line of the repository's bench.py.

    python3 witch_tpu_torch/tools/bench.py [--reps N] [--assets PATH]

Prints the card's name and power limit (nvidia-smi) on one line, then
one JSON line with bench.py's keys: forward_scoring_pairs_per_s (value),
vs_baseline (against the reference WITCH's 4-core CPU hmmsearch),
gcups_true, gcups_padded, seconds_per_full_grid (one warm call, then the
mean of --reps synchronised calls), backend, and
domaindef_pairs_per_s_4t (the port's native engine). Raises without a
card: there is no CPU tier.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--assets", default=os.path.join(ROOT,
                                                     "bench_assets.npz"))
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("tools/bench.py needs a CUDA card "
                           "(torch.cuda.is_available() is False)")
    from witch_tpu_torch.benchlib import (bench_line, bench_tier,
                                          domaindef_pairs_per_s)
    print(smi(), flush=True)
    line = bench_line(bench_tier(a.assets, reps=a.reps),
                      domaindef_pairs_per_s(a.assets))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
