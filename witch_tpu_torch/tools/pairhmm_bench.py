"""Time the pair-HMM forward kernel on the anchor embedding of scenario
A's backbone, on one CUDA card.

    python3 witch_tpu_torch/tools/pairhmm_bench.py [--reps N] [--plain]
        [--backbone N]

The input is chip_smoke.py's scenario A: scripts/make_scale_dataset.py
--n 300 --queries 100 --seed 20261016, its backbone rows ungapped and its
fragments, from which backbone.py:select_backbone picks --backbone
sequences (100) as the backbone job does. anchor_embedding(use_device=
True) of those sequences (24 farthest-point anchors, every sequence-
anchor pair) runs through the kernel once to record its calls
(record_calls); each call is then timed with CUDA events (time_calls:
mean of --reps after a warm-up) and, with --plain, through the plain
version once after a warm-up. Prints one JSON line: launches, pairs,
cells, bytes, kernel ms, plain ms, the bound (17 f32 operations a cell
at 67 TFLOP/s, or the inputs read once at 3.35 TB/s, whichever is
longer), the largest |d log-odds| between kernel and plain and max |dE|
of the two embeddings, and the card's name and power limit. chip_smoke.py
phase 5c measures with record_calls and time_calls.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OPS_PER_CELL = 17           # the recurrence's f32 operations a cell
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def backbone_codes(n_backbone):
    """The encoded backbone sequences of scenario A's backbone job."""
    from witch_tpu_torch.backbone import select_backbone
    from witch_tpu_torch.core.alphabet import ALPHABETS
    from witch_tpu_torch.io.fasta import read_fasta
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([sys.executable, os.path.join(
            ROOT, "scripts", "make_scale_dataset.py"), "--n", "300",
            "--queries", "100", "--seed", "20261016", "--out", d],
            check=True, capture_output=True, timeout=300)
        recs = [(n, s.replace("-", "").upper()) for n, s in read_fasta(
            os.path.join(d, "backbone.aln.fasta.gz"))]
        recs += [(n, s.upper()) for n, s in read_fasta(
            os.path.join(d, "queries.fasta"))]
    backbone, _ = select_backbone(recs, n_backbone, seed=0)
    al = ALPHABETS["dna"]
    return [al.encode(s) for _, s in backbone], al


def record_calls(codes, al, device, kernel=True):
    """(E, calls): anchor_embedding(use_device=True) of `codes`, through
    the kernel (or, kernel=False, the plain version), and the argument
    tuples of its pairhmm_forward_logodds calls."""
    import witch_tpu_torch.ops.pairhmm as ph
    from witch_tpu_torch.backbone_consistency import anchor_embedding
    kern = ph.pairhmm_forward_logodds
    fn = kern if kernel else ph.pairhmm_forward_logodds_plain
    calls = []

    def recorded(*args):
        calls.append(args)
        return fn(*args)

    ph.pairhmm_forward_logodds = recorded
    try:
        E = anchor_embedding(codes, al, use_device=True, device=device)
    finally:
        ph.pairhmm_forward_logodds = kern
    return E, calls


def _cuda_ms(fn, args, reps):
    """(the output of a warm-up call, CUDA-event ms of one call, mean of
    reps)."""
    import torch
    out = fn(*args)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn(*args)
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1]) / reps


def time_calls(calls, reps=3, plain=True):
    """Summed over the recorded calls: the kernel's ms (mean of reps), the
    DP cells (len A x (len B + 1)), the bytes of the inputs read once and
    the output written once, and the bound; with plain, the plain version's ms (one call) and the
    largest |d log-odds| between the two."""
    import witch_tpu_torch.ops.pairhmm as ph
    res = dict(launches=len(calls), ms=0.0, cells=0.0, bytes=0.0)
    if plain:
        res.update(plain_ms=0.0, max_abs_err_logodds=0.0)
    for args in calls:
        lA, lB = args[1], args[3]
        res["cells"] += float((lA.double() * (lB.double() + 1)).sum())
        res["bytes"] += float(sum(t.numel() * t.element_size()
                                  for t in args[:5]) + 4 * len(lA))
        k, t = _cuda_ms(ph.pairhmm_forward_logodds, args, reps)
        res["ms"] += t
        if plain:
            p, t = _cuda_ms(ph.pairhmm_forward_logodds_plain, args, 1)
            res["plain_ms"] += t
            res["max_abs_err_logodds"] = max(res["max_abs_err_logodds"],
                                             float((k - p).abs().max()))
    t_ops = OPS_PER_CELL * res["cells"] / F32_OPS_PER_S * 1e3
    t_bytes = res["bytes"] / HBM_BYTES_PER_S * 1e3
    res.update(bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--backbone", type=int, default=100)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    codes, al = backbone_codes(a.backbone)
    E_k, calls = record_calls(codes, al, "cuda")
    res = dict(pairs=int(E_k.size), card=smi())
    res.update(time_calls(calls, a.reps, a.plain))
    if a.plain:
        E_p, _ = record_calls(codes, al, "cuda", kernel=False)
        res["max_abs_dE"] = float(np.abs(E_k - E_p).max())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
