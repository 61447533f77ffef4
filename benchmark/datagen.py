"""The benchmark's data: a configuration's backbone alignment and tree, and
a run's fragments.

The backbone and tree are made exactly as scripts/make_scale_dataset.py
makes them (its random_tree, newick and evolve, copied here so that the
yardstick cannot move with that script): the same seed gives the same
bytes. They come from the configuration's fixed seed, so the deployment
is the same in every run.

Fragments come from the run's --seed alone. Each is a further-mutated
piece of a backbone row, as in the script, but drawn in bulk: the
fraction of its row that a fragment keeps is stratified over each job
(every job of a run, and of every seed, gets the same set of fractions
in another order), so that a seed changes which fragments a job holds
and not how much work it is.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import sys

import numpy as np


def random_tree(n, rng):
    """Random coalescent topology; returns (children, bl, root) with
    nodes 0..n-1 = leaves, binary internals appended; root = last."""
    nodes = list(range(n))
    children = {}
    bl = {}
    nxt = n
    while len(nodes) > 1:
        i, j = rng.choice(len(nodes), 2, replace=False)
        a, b = nodes[i], nodes[j]
        for x in (i, j) if i > j else (j, i):
            nodes.pop(x)
        children[nxt] = (a, b)
        bl[a] = float(rng.exponential(0.06) + 0.01)
        bl[b] = float(rng.exponential(0.06) + 0.01)
        nodes.append(nxt)
        nxt += 1
    root = nodes[0]
    return children, bl, root


def newick(children, bl, root, names):
    out = []

    def rec(v):
        if v not in children:
            out.append(names[v])
        else:
            a, b = children[v]
            out.append("(")
            rec(a)
            out.append(":%.6f," % bl[a])
            rec(b)
            out.append(":%.6f" % bl[b])
            out.append(")")
    rec(root)
    return "".join(out) + ";"


def evolve(children, bl, root, n, L, rng, col_freqs, gap_p):
    """Evolve codes + presence masks down the tree (iterative DFS)."""
    codes = np.zeros((n, L), np.int8)
    root_codes = np.array(
        [rng.choice(4, p=col_freqs[c]) for c in range(L)], np.int8)
    root_pres = rng.random(L) > gap_p
    stack = [(root, root_codes, root_pres)]
    while stack:
        v, cv, pv = stack.pop()
        if v not in children:
            codes[v] = np.where(pv, cv, -1)
            continue
        for ch in children[v]:
            d = bl[ch]
            p_sub = 1.0 - np.exp(-d)
            c2 = cv.copy()
            mut = rng.random(L) < p_sub
            c2[mut] = rng.integers(0, 4, int(mut.sum()))
            p2 = pv.copy()
            n_ev = rng.poisson(d * 12)
            for _ in range(n_ev):
                s = int(rng.integers(0, L))
                ln = 1 + int(rng.geometric(0.35))
                p2[s:s + ln] = not p2[s] if ln else p2[s]
            stack.append((ch, c2, p2))
    return codes


def make_backbone(n, cols, seed):
    """(names, codes [n, L] int8 with -1 for gaps, newick text), as
    scripts/make_scale_dataset.py --n n --cols cols --seed seed makes
    them."""
    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, 200000))
    try:
        rng = np.random.default_rng(seed)
        conc = np.where(rng.random(cols) < 0.5, 0.3, 5.0)
        col_freqs = np.stack([rng.dirichlet(np.full(4, c)) for c in conc])
        children, bl, root = random_tree(n, rng)
        names = ["S%05d" % i for i in range(n)]
        codes = evolve(children, bl, root, n, cols, rng, col_freqs,
                       gap_p=0.12)
        codes = codes[:, (codes >= 0).any(axis=0)]
        tree = newick(children, bl, root, names) + "\n"
    finally:
        sys.setrecursionlimit(rec)
    return names, codes, tree


def backbone_fasta(names, codes) -> str:
    lut = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for i, name in enumerate(names):
        row = np.where(codes[i] >= 0, lut[np.clip(codes[i], 0, 3)],
                       ord("-")).astype(np.uint8)
        out.append(">%s\n%s\n" % (name, row.tobytes().decode()))
    return "".join(out)


def config_key(config: dict) -> str:
    blob = json.dumps(config, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


def ensure_backbone(config: dict, data_root: str):
    """The configuration's backbone directory (backbone.aln.fasta.gz,
    backbone.tre), made once into data_root/<name>-<key of the config's
    content>/ and read from there afterwards. Returns (dir, names, codes)."""
    d = os.path.join(data_root, "%s-%s" % (config["name"], config_key(config)))
    fa = os.path.join(d, "backbone.aln.fasta.gz")
    tre = os.path.join(d, "backbone.tre")
    npz = os.path.join(d, "codes.npz")
    if not (os.path.exists(fa) and os.path.exists(tre)
            and os.path.exists(npz)):
        b = config["backbone"]
        names, codes, tree = make_backbone(b["sequences"], b["columns"],
                                           b["seed"])
        os.makedirs(d, exist_ok=True)
        tmp = ".%d.tmp" % os.getpid()
        with gzip.open(fa + tmp, "wt") as f:
            f.write(backbone_fasta(names, codes))
        with open(tre + tmp, "w") as f:
            f.write(tree)
        np.savez(npz + tmp + ".npz", codes=codes)
        os.replace(fa + tmp, fa)
        os.replace(tre + tmp, tre)
        os.replace(npz + tmp + ".npz", npz)
    codes = np.load(npz)["codes"]
    names = ["S%05d" % i for i in range(codes.shape[0])]
    return d, names, codes


def make_fragments(codes, seed, n_jobs, per_job, frac_lo, frac_hi,
                   min_len=30):
    """n_jobs x per_job fragments of the backbone rows `codes` (int8, -1
    gaps) from `seed`: a list of n_jobs lists of ACGT strings. Each job's
    kept fractions are per_job evenly spaced points of [frac_lo, frac_hi]
    in an order drawn from the seed; the source row, the substitution
    rate, the substituted sites and the start are drawn as in
    scripts/make_scale_dataset.py."""
    rng = np.random.default_rng(seed)
    n, L = codes.shape
    N = n_jobs * per_job
    strata = frac_lo + (frac_hi - frac_lo) * (np.arange(per_job) + 0.5) \
        / per_job
    frac = np.concatenate([rng.permutation(strata) for _ in range(n_jobs)])
    src = rng.integers(0, n, N)
    p_sub = 1.0 - np.exp(-(rng.exponential(0.05, N) + 0.02))
    u_start = rng.random(N)
    # ungapped rows, left-aligned: row r's residues in seqs[r, :lens[r]]
    present = codes >= 0
    lens = present.sum(axis=1)
    order = np.argsort(~present, axis=1, kind="stable")
    seqs = np.take_along_axis(codes, order, axis=1)
    Lmax = int(lens.max())
    mut = rng.random((N, Lmax)) < p_sub[:, None]
    sub = rng.integers(0, 4, (N, Lmax), dtype=np.int8)
    rows = np.where(mut, sub, seqs[src, :Lmax])
    slen = lens[src]
    ln = np.maximum(min_len, (slen * frac).astype(np.int64))
    ln = np.minimum(ln, slen)
    st = np.floor(u_start * np.maximum(1, slen - ln + 1)).astype(np.int64)
    lut = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for q in range(N):
        out.append(lut[rows[q, st[q]:st[q] + ln[q]]].tobytes().decode())
    return [out[j * per_job:(j + 1) * per_job] for j in range(n_jobs)]
