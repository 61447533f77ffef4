"""The ensemble, worked out again from the backbone and its tree: WITCH's
(and UPP's) hierarchical centroid-edge decomposition, and for each subset
an hmmbuild --symfrac 0 --ere 0.59 profile HMM in HMMER 3.1b2's
semantics (Henikoff position-based weights, fragment marking, entropy
weighting to the adaptive target, the nucleic mixture-Dirichlet emission
prior and single-Dirichlet transition priors), rounded as the HMM text
format rounds it (-ln p at 5 decimals), since WITCH scores the models it
reads back from that text.

Plain numpy, float64, DNA only (the benchmark's data has no degenerate
residues). This is a frozen copy of the semantics that the repository's
parity tests held against the HMMER 3.1b2 binaries (hmmbuild's text
output to < 5e-6 in ln p), kept here so that no later change to the
program can move it.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammaln

K = 4
GAP = 4
TMM, TMI, TMD, TIM, TII, TDM, TDD = range(7)

# HMMER 3.1b2's nucleic priors (p7_prior_CreateNucleic)
TM_PRIOR = np.array([2.0, 0.1, 0.1])
TI_PRIOR = np.array([0.06, 0.2])
TD_PRIOR = np.array([0.1, 0.2])
EM_Q = np.array([0.24, 0.26, 0.08, 0.42])
EM_ALPHA = np.array([
    [0.16, 0.45, 0.12, 0.39],
    [0.09, 0.03, 0.09, 0.04],
    [1.29, 0.40, 6.58, 0.51],
    [1.74, 1.49, 1.57, 1.95],
])
BACKGROUND = np.full(K, 0.25)


# ---------------------------------------------------------------- tree
class _Node:
    __slots__ = ("children", "parent", "length", "label")

    def __init__(self):
        self.children, self.parent, self.length, self.label = [], None, None, None


def parse_newick(text):
    s = text.strip().rstrip(";")
    pos = 0

    def node():
        nonlocal pos
        n = _Node()
        if s[pos] == "(":
            pos += 1
            while True:
                c = node()
                c.parent = n
                n.children.append(c)
                if s[pos] == ",":
                    pos += 1
                    continue
                pos += 1          # ")"
                break
        start = pos
        while pos < len(s) and s[pos] not in "(),:;":
            pos += 1
        n.label = s[start:pos] or None
        if pos < len(s) and s[pos] == ":":
            pos += 1
            start = pos
            while pos < len(s) and s[pos] not in "(),;":
                pos += 1
            n.length = float(s[start:pos])
        return n

    return node()


def _postorder(root):
    stack = [(root, False)]
    while stack:
        n, done = stack.pop()
        if done or not n.children:
            yield n
        else:
            stack.append((n, True))
            for c in reversed(n.children):
                stack.append((c, False))


def _leaves(root):
    return [n.label for n in _postorder(root) if not n.children]


def _deroot(root):
    """A bifurcating root becomes a trifurcation (its internal child
    collapsed into it)."""
    if len(root.children) != 2:
        return
    c0, c1 = root.children
    collapse = c0 if c0.children else c1
    other = c1 if collapse is c0 else c0
    if not collapse.children:
        return
    root.children = [other]
    for cc in collapse.children:
        cc.parent = root
        root.children.append(cc)


def _split(root, min_size):
    """The centroid edge's head: the first node in postorder whose leaf
    count is nearest half, both sides holding at least min_size."""
    counts = {}
    for n in _postorder(root):
        counts[id(n)] = 1 if not n.children else sum(counts[id(c)]
                                                     for c in n.children)
    total = counts[id(root)]
    if total <= min_size:
        return None
    best, best_imb = None, float(total)
    for n in _postorder(root):
        if n.parent is None:
            continue
        below = counts[id(n)]
        if below < min_size or total - below < min_size:
            continue
        imb = abs(total / 2.0 - below)
        if imb < best_imb:
            best, best_imb = n, imb
    return best


def _cut(head):
    """(subtree below head, the rest with its unifurcation suppressed)."""
    tail = head.parent
    tail.children = [c for c in tail.children if c is not head]
    head.parent = None
    if len(tail.children) == 1 and tail.parent is not None:
        child = tail.children[0]
        grand = tail.parent
        grand.children[grand.children.index(tail)] = child
        child.parent = grand
    elif len(tail.children) == 1:
        child = tail.children[0]
        child.parent = None
        return head, child
    root = tail
    while root.parent is not None:
        root = root.parent
    return head, root


def decompose(tree_text, max_size, min_size=2):
    """Leaf-label lists of the ensemble's subsets in WITCH's order: a
    subtree larger than max_size is recorded, then cut at its centroid
    edge, the part below the edge first."""
    out = []

    def rec(root, derooted):
        if not derooted:
            _deroot(root)
        n = len(_leaves(root))
        if n > max_size:
            out.append(_leaves(root))
            head = _split(root, min_size)
            if head is not None:
                a, b = _cut(head)
                rec(a, False)
                rec(b, False)
            else:
                out.append(_leaves(root))
        else:
            out.append(_leaves(root))

    rec(parse_newick(tree_text), False)
    return out


# --------------------------------------------------------------- build
def _posterior_mean(c):
    a = EM_ALPHA
    asum = a.sum(axis=1)
    n = c.sum(axis=-1)
    lw = (np.log(EM_Q) + gammaln(asum) - gammaln(n[..., None] + asum)
          + (gammaln(c[..., None, :] + a) - gammaln(a)).sum(axis=-1))
    lw = lw - lw.max(axis=-1, keepdims=True)
    w = np.exp(lw)
    w /= w.sum(axis=-1, keepdims=True)
    mean = (c[..., None, :] + a) / (n[..., None, None] + asum[:, None])
    return (w[..., None] * mean).sum(axis=-2)


def _pb_weights(codes):
    n, L = codes.shape
    onehot = np.zeros((n, L, K))
    r, c = np.nonzero(codes < K)
    onehot[r, c, codes[r, c]] = 1.0
    cnt = onehot.sum(axis=0)
    kinds = (cnt > 0).sum(axis=1)
    denom = cnt * kinds[:, None]
    inv = np.zeros_like(cnt)
    np.divide(1.0, denom, out=inv, where=denom > 0)
    w = np.einsum("nlk,lk->n", onehot, inv)
    nres = (codes < K).sum(axis=1).astype(np.float64)
    w = np.divide(w, nres, out=np.ones(n), where=nres > 0)
    return w * (n / w.sum()) if w.sum() > 0 else np.ones(n)


def _counts(codes, weights, fragthresh=0.5):
    n, M = codes.shape
    res = codes < K
    e = np.zeros((M + 1, K))
    for x in range(K):
        e[1:, x] = weights @ (codes == x)
    t = np.zeros((M + 1, 7))
    first = np.argmax(res, axis=1)
    last = M - 1 - np.argmax(res[:, ::-1], axis=1)
    has = res.sum(axis=1) > 0
    frag = ((last - first + 1) / M) < fragthresh
    s = np.where(frag, first, 0)
    en = np.where(frag, last, M - 1)
    w = weights * has
    full = w * ~frag
    at_s = res[np.arange(n), s]
    t[0, TMM] += (full * at_s).sum()
    t[0, TMD] += (full * ~at_s).sum()
    pos = np.arange(M - 1)[None, :]
    span = (pos >= s[:, None]) & (pos < en[:, None]) & has[:, None]
    a, b = res[:, :-1], res[:, 1:]
    wv = w[:, None] * span
    t[1:M, TMM] += (wv * (a & b)).sum(axis=0)
    t[1:M, TMD] += (wv * (a & ~b)).sum(axis=0)
    t[1:M, TDM] += (wv * (~a & b)).sum(axis=0)
    t[1:M, TDD] += (wv * (~a & ~b)).sum(axis=0)
    at_e = res[np.arange(n), en]
    np.add.at(t, (en + 1, TMM), full * at_e)
    return e, t


def _mre(mat):
    p = mat[1:]
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = p * (np.log2(p) - np.log2(BACKGROUND[None, :]))
    return float(np.nan_to_num(terms).sum() / p.shape[0])


def _effn(ecounts, nseq, M, ere=0.59, esigma=45.0):
    target = max(ere, (esigma - np.log2(2.0 / (M * (M + 1)))) / M)

    def f(neff):
        mat = np.vstack([np.zeros((1, K)),
                         _posterior_mean(ecounts[1:] * (neff / nseq))])
        return _mre(mat) - target

    if f(nseq) <= 0:
        return float(nseq)
    lo, hi = 0.0, float(nseq)
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        v = f(mid)
        if v == 0.0 or (hi - lo) < 0.01:
            return mid
        if v > 0:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def _round_text(p):
    with np.errstate(divide="ignore"):
        q = np.exp(-np.round(-np.log(p), 5))
    return np.where(p == 0.0, 0.0, q)


def build(codes):
    """Profile HMM of an all-gap-column-free subalignment (codes [n, M],
    0..3 residues, 4 gap): (match emissions [M+1, 4], insert emissions
    [M+1, 4], transitions [M+1, 7]), rounded as the text format rounds."""
    n, M = codes.shape
    weights = _pb_weights(codes)
    e, t = _counts(codes, weights)
    scale = _effn(e, n, M) / n
    e, t = e * scale, t * scale
    mat = np.zeros((M + 1, K))
    mat[1:] = _posterior_mean(e[1:])
    ins = np.tile(BACKGROUND, (M + 1, 1))
    tr = np.zeros((M + 1, 7))
    tm = t[:M, [TMM, TMI, TMD]] + TM_PRIOR
    tr[:M, [TMM, TMI, TMD]] = tm / tm.sum(axis=1, keepdims=True)
    tl = t[M, [TMM, TMI]] + TM_PRIOR[:2]
    tr[M, TMM], tr[M, TMI] = tl / tl.sum()
    ti = t[:, [TIM, TII]] + TI_PRIOR
    tr[:, [TIM, TII]] = ti / ti.sum(axis=1, keepdims=True)
    td = t[1:M, [TDM, TDD]] + TD_PRIOR
    tr[1:M, [TDM, TDD]] = td / td.sum(axis=1, keepdims=True)
    tr[0, TDM], tr[0, TDD] = 1.0, 0.0
    tr[M, TDM], tr[M, TDD] = 1.0, 0.0
    return _round_text(mat), _round_text(ins), _round_text(tr)


class Model:
    """One ensemble member: its subset's rows and retained backbone
    columns, its size and its profile HMM."""

    def __init__(self, index, rows, columns, nongaps, hmm):
        self.index = index
        self.rows = rows
        self.columns = columns          # backbone column of match state k+1
        self.nongaps = nongaps
        self.mat, self.ins, self.trans = hmm
        self.M = len(columns)
        self.nseq = len(rows)


def ensemble(names, codes, tree_text, alignment_size):
    """{index: Model} of the backbone (names, codes [n, L], -1 gaps)."""
    row_of = {nm: i for i, nm in enumerate(names)}
    c = np.where(codes < 0, GAP, codes).astype(np.int64)
    out = {}
    for i, leaves in enumerate(decompose(tree_text, alignment_size)):
        rows = np.array([row_of[x] for x in leaves])
        sub = c[rows]
        per_col = (sub != GAP).sum(axis=0)
        cols = np.flatnonzero(per_col > 0)
        out[i] = Model(i, rows, cols, per_col[cols],
                       build(np.ascontiguousarray(sub[:, cols])))
    return out
