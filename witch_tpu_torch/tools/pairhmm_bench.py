"""Time the pair-HMM forward kernels on an anchor embedding, for one or
more checkouts of the repository, on one CUDA card.

    python3 witch_tpu_torch/tools/pairhmm_bench.py [--tree DIR ...]
        [--reps N] [--plain] [--first] [--ptxas] [--layouts]
        [--n 300 --queries 100 --seed 20261016 [--cols C] | --data DIR]
        [--backbone 100]
    python3 witch_tpu_torch/tools/pairhmm_bench.py --layouts
        --widths 1536:8192:256 [--pairs 2400 --rows 256] [--reps N]

The input is scripts/make_scale_dataset.py --n N --queries Q --seed S
[--cols C] (or the directory --data DIR that it wrote), its backbone rows
ungapped and its fragments, from which backbone.py:select_backbone picks
--backbone sequences as the backbone job does. The defaults are
chip_smoke.py's scenario A (100 sequences, 2,400 sequence-anchor pairs,
the register kernel); --n 1000 --queries 1000 --seed 20260820 --backbone
1000 is dna1k's data at the default 1,000-sequence backbone (24,000
pairs); --n 120 --queries 30 --cols 1920 --seed 20261018 --backbone 70
is scenario A's long input (chip_smoke.py 5e: 1,680 pairs of ~1,670
residues) and --n 200 --queries 100 --cols 8000 --seed 20261017
--backbone 100 dnawide's backbone embedding (5w: 2,400 pairs of ~7,000
residues), both on the wide layout.

Each tree runs in its own process (the trees' packages share a name), in
turns A B B A for two trees, so parent and change are measured in one
call on one card. In each, anchor_embedding(use_device=True) of those
sequences (24 farthest-point anchors, every sequence-anchor pair) runs
through the tree's kernel once to record its calls (record_calls); each
call is then timed with CUDA events (time_calls: mean of --reps after a
warm-up); with --first also through the first version
(first_version=True, where the tree's wrapper has it) and with --plain through the plain version
(one call, no warm-up). Per tree and turn it prints one JSON line:
launches, pairs, cells, bytes, kernel ms, the layout at each width, the
first version's and plain's ms and their largest |d log-odds| from the
kernel, the bound (17 f32 operations a cell at 67 TFLOP/s, or the inputs
read once at 3.35 TB/s, whichever is longer), max |dE| against the first
tree's embedding, and the card's name and power limit. --ptxas first
prints each kernel instance's registers and spills from nvcc -Xptxas -v
on each tree's csrc/pairhmm.cu (ptxas), and the warps a SM they allow.
--layouts (the first tree only) times instead every candidate (CH, G) of
the wide layout (ops/pairhmm.py:wide_candidates) on the recorded calls
whose B is wider than the register kernel's (time_layouts), one JSON
line each: its ms, whether the layout picks it, and its largest |d
log-odds| from the pick, and the CTAs a SM holds. With --widths
A:B:S it times them instead on seeded synthetic batches (sweep_layouts:
--pairs pairs of --rows DNA residues against Bs of 80% identity, 32
residues apart at most, the widest LB) at LB = A, A + S, ... below B:
the measurement ops/pairhmm.py:PHW_PICK_CH is read from. chip_smoke.py
phases 5c and 5w measure with record_calls, time_calls, subsample and
ptxas.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OPS_PER_CELL = 17           # the recurrence's f32 operations a cell
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
SCEN_A = dict(n=300, queries=100, seed=20261016, backbone=100)


def smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else "?"


def backbone_codes(n_backbone, n=300, queries=100, seed=20261016,
                   data=None, cols=None):
    """The encoded backbone sequences the backbone job picks from
    make_scale_dataset.py's rows (ungapped) and fragments, and the DNA
    alphabet. `data`: a directory the script already wrote with these
    arguments (else it runs into a temporary one)."""
    from witch_tpu_torch.backbone import select_backbone
    from witch_tpu_torch.core.alphabet import ALPHABETS
    from witch_tpu_torch.io.fasta import read_fasta

    def read(d):
        recs = [(nm, s.replace("-", "").upper()) for nm, s in read_fasta(
            os.path.join(d, "backbone.aln.fasta.gz"))]
        return recs + [(nm, s.upper()) for nm, s in read_fasta(
            os.path.join(d, "queries.fasta"))]

    if data is None:
        with tempfile.TemporaryDirectory() as d:
            subprocess.run([sys.executable, os.path.join(
                ROOT, "scripts", "make_scale_dataset.py"), "--n", str(n),
                "--queries", str(queries), "--seed", str(seed), "--out", d]
                + (["--cols", str(cols)] if cols else []),
                check=True, capture_output=True, timeout=300)
            recs = read(d)
    else:
        recs = read(data)
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


def _cuda_ms(fn, args, reps, warm=True, **kw):
    """(the output of the first call, CUDA-event ms of one call: the mean
    of reps after a warm-up call, or with warm=False the first call
    alone)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if warm:
        out = fn(*args, **kw)
        torch.cuda.synchronize()
    ev[0].record()
    for r in range(reps):
        o = fn(*args, **kw)
        if r == 0 and not warm:
            out = o
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1]) / reps


def time_calls(calls, reps=3, plain=True, first=False, plain_warm=True,
               first_warm=True):
    """Summed over the recorded calls: the kernel's ms (mean of reps), the
    DP cells (len A x (len B + 1)), the bytes of the inputs read once and
    the output written once, the bound, and the layout at each width
    (ops/pairhmm.py:pairhmm_layout, where the tree has it); with plain,
    the plain version's ms (one call, after a warm-up call unless
    plain_warm is False) and the largest |d log-odds| between the two,
    also divided by min(len A, len B) as the embedding divides it;
    with first, the same for the first version (first_version=True, where
    the tree's wrapper has it; with first_warm False one call, no
    warm-up)."""
    import inspect

    import torch

    import witch_tpu_torch.ops.pairhmm as ph
    kern = ph.pairhmm_forward_logodds
    has_first = "first_version" in inspect.signature(kern).parameters
    res = dict(launches=len(calls), ms=0.0, cells=0.0, bytes=0.0,
               layouts={})
    if plain:
        res.update(plain_ms=0.0, max_abs_err_logodds=0.0,
                   max_abs_err_per_residue=0.0)
    if first and has_first:
        res.update(ms_first_version=0.0, max_abs_diff_first_version=0.0)
    for args in calls:
        lA, lB, em = args[1], args[3], args[4]
        res["cells"] += float((lA.double() * (lB.double() + 1)).sum())
        res["bytes"] += float(sum(t.numel() * t.element_size()
                                  for t in args[:5]) + 4 * len(lA))
        if hasattr(ph, "pairhmm_layout"):
            res["layouts"][str(args[2].shape[1])] = list(ph.pairhmm_layout(
                em.shape[0], args[2].shape[1]))
        k, t = _cuda_ms(kern, args, reps)
        res["ms"] += t
        if first and has_first:
            f, t = _cuda_ms(kern, args, reps if first_warm else 1,
                            warm=first_warm, first_version=True)
            res["ms_first_version"] += t
            res["max_abs_diff_first_version"] = max(
                res["max_abs_diff_first_version"],
                float((k - f).abs().max()))
        if plain:
            p, t = _cuda_ms(ph.pairhmm_forward_logodds_plain, args, 1,
                            warm=plain_warm)
            res["plain_ms"] += t
            d = (k - p).abs().double()
            res["max_abs_err_logodds"] = max(res["max_abs_err_logodds"],
                                             float(d.max()))
            res["max_abs_err_per_residue"] = max(
                res["max_abs_err_per_residue"], float(
                    (d / torch.minimum(lA, lB).clamp(min=1)).max()))
    t_ops = OPS_PER_CELL * res["cells"] / F32_OPS_PER_S * 1e3
    t_bytes = res["bytes"] / HBM_BYTES_PER_S * 1e3
    res.update(bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    return res


def subsample(calls, n, seed=0):
    """The recorded calls cut to n pairs in all, drawn at random (seeded)
    in proportion to each call's pairs; each call keeps its B width (so
    the same layout runs) and its A width cut to its pairs' longest."""
    import numpy as np
    import torch
    total = sum(len(c[1]) for c in calls)
    rng = np.random.default_rng(seed)
    out = []
    for args in calls:
        P = len(args[1])
        k = max(1, round(n * P / total))
        idx = torch.from_numpy(np.sort(rng.choice(P, min(k, P),
                                                  replace=False)))
        idx = idx.to(args[0].device)
        cA, lA, cB, lB = (t[idx] for t in args[:4])
        cA = cA[:, :max(1, int(lA.max()))].contiguous()
        out.append((cA, lA, cB, lB) + tuple(args[4:]))
    return out


def time_layouts(calls, reps=3):
    """[{LB, CH, G, chosen, ms, max_abs_vs_chosen}]: each recorded call
    whose B is wider than the register kernel's through every candidate
    (CH, G) of the wide layout (ops/pairhmm.py:wide_candidates), its
    CUDA-event ms (mean of reps after a warm-up) and its largest |d
    log-odds| from the layout's own pick."""
    import witch_tpu_torch.ops.pairhmm as ph
    pick = ph.pairhmm_layout
    kern = ph.pairhmm_forward_logodds
    out = []
    for args in calls:
        LB, C = args[2].shape[1], args[4].shape[0]
        chosen = pick(C, LB)
        if chosen[0] != 2:
            continue
        ref = kern(*args)
        for ch, g in ph.wide_candidates(LB):
            ph.pairhmm_layout = lambda C, L, ch=ch, g=g: (2, ch, g)
            try:
                k, t = _cuda_ms(kern, args, reps)
            finally:
                ph.pairhmm_layout = pick
            out.append(dict(LB=LB, pairs=len(args[1]), CH=ch, G=g,
                            ctas_per_sm=ph.wide_ctas_per_sm(ch, g, C),
                            chosen=chosen[1:] == (ch, g), ms=t,
                            max_abs_vs_chosen=float((k - ref).abs().max())))
    return out


def synthetic_call(LB, pairs, rows, seed=0):
    """The argument tuple of one pairhmm_forward_logodds call on the card:
    `pairs` DNA sequences of `rows` residues against Bs of LB - 31..LB
    residues, 80% identical to them over their common length (seeded),
    at the anchor embedding's em, delta and eps."""
    import numpy as np
    import torch
    from witch_tpu_torch.backbone_consistency import _emission_odds
    from witch_tpu_torch.core.alphabet import ALPHABETS
    rng = np.random.default_rng(seed + LB)
    cA = rng.integers(0, 4, (pairs, rows))
    cB = rng.integers(0, 4, (pairs, LB))
    m = min(rows, LB)
    cB[:, :m] = np.where(rng.random((pairs, m)) < 0.8, cA[:, :m], cB[:, :m])
    lA = np.full(pairs, rows)
    lB = rng.integers(max(1, LB - 31), LB + 1, pairs)
    em = _emission_odds(ALPHABETS["dna"], 0.3).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32)).cuda()
                 for x in (cA, lA, cB, lB)) + (
        torch.from_numpy(em).cuda(), 0.02, 0.75)


def sweep_layouts(widths, pairs=2400, rows=256, reps=3):
    """time_layouts over synthetic_call at each width, with each line's
    Gcells a second (len A x (len B + 1) cells over its ms)."""
    out = []
    for LB in widths:
        args = synthetic_call(LB, pairs, rows)
        cells = float((args[1].double() * (args[3].double() + 1)).sum())
        for r in time_layouts([args], reps):
            r["gcells_per_s"] = cells / r["ms"] / 1e6
            out.append(r)
    return out


def warps_per_sm(regs, warps_per_cta=1):
    """Resident warps a SM at `regs` registers a thread on sm_90: each of
    the SM's 4 schedulers holds its warps' registers in its own 16,384,
    allocated per warp in units of 256; at most 64 warps and 32 CTAs a
    SM. (This model gave the card's
    cudaOccupancyMaxActiveBlocksPerMultiprocessor for all 93 (CH, G)
    shapes of the wide layout's sweep; one pool of 65,536 missed 11.)"""
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(64, 4 * (16384 // per_warp))
    return min(32, warps // warps_per_cta) * warps_per_cta


def ptxas(tree=ROOT):
    """[{kernel, registers, spill_stores, spill_loads, stack, warps_per_sm}]
    of each kernel in the tree's csrc/pairhmm.cu, from nvcc -Xptxas -v
    (its build flags, sm_90a). Raises with nvcc's output if it fails."""
    sys.path.insert(0, tree)
    try:
        from witch_tpu_torch import _build
        nvcc, flags = _build._nvcc(), list(_build.NVCC_FLAGS)
    finally:
        sys.path.remove(tree)
    src = os.path.join(tree, "witch_tpu_torch", "csrc", "pairhmm.cu")
    with tempfile.TemporaryDirectory() as d:
        r = subprocess.run([nvcc] + flags + ["-Xptxas", "-v", "-c", "-o",
                                             os.path.join(d, "p.o"), src],
                           capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError("nvcc -Xptxas -v failed:\n" + r.stderr[-4000:])
    return parse_ptxas(r.stdout + r.stderr)


def parse_ptxas(text):
    """The per-kernel records of ptxas() from nvcc -Xptxas -v's output:
    the register kernel's instances as pairhmm_reg_kernel<CH> (one warp
    a CTA), the wide layout's as pairhmm_wide_kernel<CH> (warps a SM
    counted one at a time: the CTAs of G warps fit that many over G),
    the first version as pairhmm_kernel (4 warps a CTA)."""
    out, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"ILi(\d+)EE", name)
            base = re.search(r"\d+(pairhmm\w*?kernel)", name)
            cur = dict(kernel=(base.group(1) if base else name)
                       + ("<%s>" % t.group(1) if t else ""))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            first = cur["kernel"] == "pairhmm_kernel"
            cur["warps_per_sm"] = warps_per_sm(
                cur["registers"], warps_per_cta=4 if first else 1)
    return out


CHILD = r"""
import importlib.util, json, sys
import numpy as np
tree, tool, npz, reps, plain, first, layouts, out = sys.argv[1:9]
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("witch_pairhmm_bench", tool)
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
from witch_tpu_torch.core.alphabet import ALPHABETS
z = np.load(npz)
off = z["off"]
codes = [np.ascontiguousarray(z["flat"][off[i]:off[i + 1]], np.int32)
         for i in range(len(off) - 1)]
E, calls = bench.record_calls(codes, ALPHABETS["dna"], "cuda")
np.save(out, E)
if layouts == "1":
    for r in bench.time_layouts(calls, int(reps)):
        print(json.dumps(dict(tree=tree, **r)), flush=True)
    sys.exit(0)
res = dict(tree=tree, pairs=int(E.size))
res.update(bench.time_calls(calls, int(reps), plain == "1", first == "1",
                            plain_warm=False))
print(json.dumps(res))
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--first", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--layouts", action="store_true")
    for k, v in SCEN_A.items():
        ap.add_argument("--" + k, type=int, default=v)
    ap.add_argument("--cols", type=int, default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--widths", default=None,
                    help="A:B:S, with --layouts: synthetic batches at LB "
                    "= A, A + S, ... below B")
    ap.add_argument("--pairs", type=int, default=2400)
    ap.add_argument("--rows", type=int, default=256)
    a = ap.parse_args(argv)
    if a.widths and not a.layouts:
        ap.error("--widths needs --layouts")
    return a


def main(argv=None):
    a = parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np

    trees = [os.path.abspath(t) for t in (a.tree or [ROOT])]
    card = smi()
    if a.ptxas:
        for t in trees:
            print(json.dumps(dict(tree=t, ptxas=ptxas(t), card=card)),
                  flush=True)
    if a.widths:
        lo, hi, step = (int(x) for x in a.widths.split(":"))
        for r in sweep_layouts(range(lo, hi, step), a.pairs, a.rows,
                               a.reps):
            print(json.dumps(dict(r, card=card)), flush=True)
        return 0
    codes, _ = backbone_codes(a.backbone, a.n, a.queries, a.seed,
                              data=a.data, cols=a.cols)
    turns = trees[:1] if a.layouts or len(trees) == 1 else \
        [trees[0], trees[1], trees[1], trees[0]]
    E0 = None
    with tempfile.TemporaryDirectory() as d:
        npz = os.path.join(d, "codes.npz")
        np.savez(npz, flat=np.concatenate(codes),
                 off=np.cumsum([0] + [len(c) for c in codes]))
        for i, t in enumerate(turns):
            out = os.path.join(d, "E%d.npy" % i)
            r = subprocess.run(
                [sys.executable, "-c", CHILD, t, os.path.abspath(__file__),
                 npz, str(a.reps), str(int(a.plain)), str(int(a.first)),
                 str(int(a.layouts)), out], capture_output=True, text=True,
                timeout=3000)
            if r.returncode != 0:
                sys.stderr.write(r.stderr[-4000:])
                return r.returncode
            if a.layouts:
                for ln in r.stdout.strip().splitlines():
                    print(json.dumps(dict(json.loads(ln), card=card)),
                          flush=True)
                continue
            res = json.loads(r.stdout.strip().splitlines()[-1])
            E = np.load(out)
            E0 = E if E0 is None else E0
            res.update(max_abs_dE_vs_first_tree=float(np.abs(E - E0).max()),
                       card=card)
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
