"""Backbone tree estimation (scenario C: backbone alignment given, tree
missing), counterpart of witch_tpu/tree_estimate.py.

The O(n^2 L) part, the identity counts over mutually ungapped canonical
positions, is two products of one-hot matrices on the device
(torch.matmul; the JAX package leaves the same product to XLA outside
any Pallas kernel, tree_estimate.py:39-45). The products run in float64,
so every count is an exact integer whatever the card's matmul precision
settings. The Jukes-Cantor correction then follows tree_estimate.py:49-56
exactly, on the counts as float32 (the JAX product's dtype), so the
distances equal the JAX package's bit for bit. Neighbour joining, the
Fitch NNI and the ML refinement (neighbor_joining, nni_refine, ml_refine
and their helpers) are copied from witch_tpu/tree_estimate.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .core.alignment import PackedAlignment


def identity_counts(aln: PackedAlignment, device):
    """(matches [n, n], denom [n, n]) float64 host arrays: identical and
    mutually ungapped canonical positions per sequence pair, counted on
    `device`."""
    K = aln.alphabet.K
    codes = torch.as_tensor(aln.codes.astype(np.int64), device=device)
    canon = codes < K
    n, L = codes.shape
    onehot = torch.zeros((n, L, K), dtype=torch.float64, device=device)
    onehot.scatter_(2, codes.clamp(max=K - 1)[..., None],
                    canon[..., None].to(torch.float64))
    flat = onehot.reshape(n, L * K)
    maskf = canon.to(torch.float64)
    matches = torch.matmul(flat, flat.T)
    denom = torch.matmul(maskf, maskf.T)
    return matches.cpu().numpy(), denom.cpu().numpy()


def jc_distances(matches: np.ndarray, denom: np.ndarray, K: int
                 ) -> np.ndarray:
    """Jukes-Cantor distances from identity counts, the arithmetic of
    witch_tpu/tree_estimate.py:49-56 on float32 counts."""
    matches = matches.astype(np.float32)
    denom = denom.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = 1.0 - matches / np.maximum(denom, 1.0)
    p = np.clip(p, 0.0, 0.95 * (K - 1) / K)
    with np.errstate(divide="ignore"):
        d = -(K - 1) / K * np.log(1.0 - K / (K - 1) * p)
    np.fill_diagonal(d, 0.0)
    return d.astype(np.float64)


def pairwise_distances(aln: PackedAlignment, device) -> np.ndarray:
    """JC-corrected pairwise distances [n, n] (float64, host)."""
    matches, denom = identity_counts(aln, device)
    return jc_distances(matches, denom, aln.alphabet.K)


def neighbor_joining(dist: np.ndarray, names: List[str]) -> str:
    """Classic NJ; returns a newick string (trifurcating root)."""
    n = dist.shape[0]
    assert n == len(names)
    if n == 1:
        return "(%s);" % names[0]
    if n == 2:
        d = max(dist[0, 1], 0.0)
        return "(%s:%.5f,%s:%.5f);" % (names[0], d / 2, names[1], d / 2)
    D = dist.copy()
    active = list(range(n))
    newick = {i: names[i] for i in range(n)}
    INF = np.inf
    while len(active) > 3:
        m = len(active)
        idx = np.array(active)
        sub = D[np.ix_(idx, idx)]
        r = sub.sum(axis=1)
        q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, INF)
        a, b = np.unravel_index(np.argmin(q), q.shape)
        i, j = idx[a], idx[b]
        dij = sub[a, b]
        di = 0.5 * dij + (r[a] - r[b]) / (2 * (m - 2))
        dj = dij - di
        di, dj = max(di, 0.0), max(dj, 0.0)
        # new node
        newD = 0.5 * (D[i, idx] + D[j, idx] - dij)
        k = D.shape[0]
        D = np.pad(D, ((0, 1), (0, 1)))
        D[k, idx] = newD
        D[idx, k] = newD
        D[k, k] = 0.0
        newick[k] = "(%s:%.5f,%s:%.5f)" % (newick[i], di, newick[j], dj)
        active = [x for x in active if x not in (i, j)] + [k]
    i, j, k = active
    dij, dik, djk = D[i, j], D[i, k], D[j, k]
    bi = max(0.0, 0.5 * (dij + dik - djk))
    bj = max(0.0, 0.5 * (dij + djk - dik))
    bk = max(0.0, 0.5 * (dik + djk - dij))
    return "(%s:%.5f,%s:%.5f,%s:%.5f);" % (newick[i], bi, newick[j], bj,
                                           newick[k], bk)


class _Tree:
    """Light rooted view of an unrooted newick (root = trifurcation)."""

    def __init__(self):
        self.children: List[List[int]] = []
        self.parent: List[int] = []
        self.name: List[Optional[str]] = []
        self.blen: List[float] = []

    def add(self, parent: int, name=None, blen=0.0) -> int:
        i = len(self.children)
        self.children.append([])
        self.parent.append(parent)
        self.name.append(name)
        self.blen.append(blen)
        if parent >= 0:
            self.children[parent].append(i)
        return i

    @classmethod
    def parse(cls, newick: str) -> "_Tree":
        t = cls()
        s = newick.strip().rstrip(";")
        pos = 0
        root = t.add(-1)
        cur = root

        def read_label(p):
            j = p
            while j < len(s) and s[j] not in ",():;":
                j += 1
            return s[p:j], j

        while pos < len(s):
            ch = s[pos]
            if ch == "(":
                cur = t.add(cur)
                pos += 1
            elif ch == ",":
                cur = t.parent[cur]
                cur = t.add(cur)
                pos += 1
            elif ch == ")":
                cur = t.parent[cur]
                pos += 1
                if pos < len(s) and s[pos] not in ",():;":
                    lbl, pos = read_label(pos)  # internal label: ignore
            elif ch == ":":
                lbl, pos2 = read_label(pos + 1)
                t.blen[cur] = float(lbl)
                pos = pos2
            else:
                lbl, pos = read_label(pos)
                t.name[cur] = lbl
        # collapse the double root introduced by the leading "("
        if len(t.children[root]) == 1:
            only = t.children[root][0]
            for c in t.children[only]:
                t.parent[c] = root
            t.children[root] = t.children[only]
            t.children[only] = []
        return t

    def newick(self) -> str:
        def rec(i):
            if not self.children[i]:
                return "%s:%.5f" % (self.name[i], self.blen[i])
            inner = ",".join(rec(c) for c in self.children[i])
            if self.parent[i] < 0:
                return "(%s);" % inner
            return "(%s):%.5f" % (inner, self.blen[i])
        root = next(i for i in range(len(self.children))
                    if self.parent[i] < 0)
        return rec(root)


def nni_refine(newick: str, aln: PackedAlignment, max_sweeps: int = 30,
               log=None) -> str:
    """Fitch-parsimony NNI refinement of an NJ topology.

    The reference estimates this tree with FastTree2's ML heuristics
    (witch_msa/gcmm/backbone.py:296-319); plain NJ topologies are
    measurably worse for centroid decomposition. Each sweep computes
    Fitch state-set bitmasks up and down the tree (vectorized over
    alignment columns), then evaluates the two alternative pairings of
    the four subtrees around every internal edge with the local-quartet
    parsimony criterion and applies improving swaps."""
    K = aln.alphabet.K
    if K > 30:
        return newick
    t = _Tree.parse(newick)
    n_nodes = len(t.children)
    name_to_row = {nm: r for r, nm in enumerate(aln.names)}
    codes = aln.codes
    L = codes.shape[1]
    full = np.uint32((1 << K) - 1)

    leaf_mask = np.zeros((n_nodes, L), np.uint32)
    for i in range(n_nodes):
        if not t.children[i] and t.name[i] is not None:
            row = codes[name_to_row[t.name[i]]]
            m = np.where(row < K, np.uint32(1) << row.astype(np.uint32),
                         full)
            leaf_mask[i] = m

    def combine(a, b):
        inter = a & b
        empty = inter == 0
        out = np.where(empty, a | b, inter)
        return out, empty

    def fitch_score():
        order = []
        stack = [next(i for i in range(n_nodes) if t.parent[i] < 0)]
        seen = []
        while stack:
            x = stack.pop()
            seen.append(x)
            stack.extend(t.children[x])
        up_l = {}
        score = 0
        for x in seen[::-1]:
            if not t.children[x]:
                up_l[x] = leaf_mask[x]
            else:
                acc = up_l[t.children[x][0]]
                for c in t.children[x][1:]:
                    acc, e = combine(acc, up_l[c])
                    score += int(e.sum())
            if t.children[x]:
                up_l[x] = acc
        return score

    improved_total = 0
    best_score = fitch_score()
    best_state = ([list(c) for c in t.children], list(t.parent))
    for sweep in range(max_sweeps):
        order = []
        stack = [next(i for i in range(n_nodes) if t.parent[i] < 0)]
        seen = []
        while stack:
            x = stack.pop()
            seen.append(x)
            stack.extend(t.children[x])
        order = seen[::-1]                      # post-order
        up = np.zeros((n_nodes, L), np.uint32)
        for x in order:
            if not t.children[x]:
                up[x] = leaf_mask[x]
            else:
                acc = up[t.children[x][0]]
                for c in t.children[x][1:]:
                    acc, _ = combine(acc, up[c])
                up[x] = acc
        down = np.full((n_nodes, L), full, np.uint32)
        for x in seen:                          # pre-order
            p = t.parent[x]
            if p < 0:
                continue
            acc = None
            if t.parent[p] >= 0:
                acc = down[p]
            for sib in t.children[p]:
                if sib == x:
                    continue
                acc = up[sib] if acc is None else combine(acc, up[sib])[0]
            down[x] = acc if acc is not None else full

        def pair_cost(a, b):
            s, e = combine(a, b)
            return s, e.astype(np.int64)

        improved = 0
        dirty = set()
        for v in range(n_nodes):
            if t.parent[v] < 0 or not t.children[v]:
                continue
            u = t.parent[v]
            if len(t.children[v]) != 2:
                continue
            if v in dirty or u in dirty:
                continue
            A, B = t.children[v]
            sibs = [c for c in t.children[u] if c != v]
            if not sibs:
                continue
            C = sibs[0]
            # D = everything above u plus u's other children beyond C
            # the quartet {A, B, C, rest}: rest = down of u combined
            # with u's children other than v and C
            acc = None
            if t.parent[u] >= 0:
                acc = down[u]
            for c in t.children[u]:
                if c in (v, C):
                    continue
                acc = up[c] if acc is None else combine(acc, up[c])[0]
            if acc is None:
                continue
            SA, SB, SC, SR = up[A], up[B], up[C], acc
            sAB, cAB = pair_cost(SA, SB)
            sCR, cCR = pair_cost(SC, SR)
            _, c3 = pair_cost(sAB, sCR)
            cost_cur = int((cAB + cCR + c3).sum())
            sAC, cAC = pair_cost(SA, SC)
            sBR, cBR = pair_cost(SB, SR)
            _, c3a = pair_cost(sAC, sBR)
            cost_a = int((cAC + cBR + c3a).sum())
            sBC, cBC = pair_cost(SB, SC)
            sAR, cAR = pair_cost(SA, SR)
            _, c3b = pair_cost(sBC, sAR)
            cost_b = int((cBC + cAR + c3b).sum())
            best = min(cost_cur, cost_a, cost_b)
            if best == cost_cur:
                continue
            # apply swap: exchange C with B (alt a) or with A (alt b)
            swap_child = B if best == cost_a else A
            t.children[v].remove(swap_child)
            t.children[u].remove(C)
            t.children[v].append(C)
            t.children[u].append(swap_child)
            t.parent[C] = v
            t.parent[swap_child] = u
            improved += 1
            # up/down vectors are stale around the swap: lock the
            # neighborhood for the rest of this sweep
            dirty.update((u, v, t.parent[u]))
            dirty.update(t.children[u])
            dirty.update(t.children[v])
        score = fitch_score()
        if log:
            log("nni sweep %d: %d swaps, parsimony %d (best %d)"
                % (sweep, improved, score, best_score))
        if score < best_score:
            best_score = score
            best_state = ([list(c) for c in t.children], list(t.parent))
            improved_total += improved
        else:
            break
        if improved == 0:
            break
    t.children = [list(c) for c in best_state[0]]
    t.parent = list(best_state[1])
    if log and improved_total:
        log("nni refinement: %d swaps kept, parsimony %d" % (
            improved_total, best_score))
    return t.newick()


def ml_refine(newick: str, aln: PackedAlignment, max_sweeps: int = 16,
              tune: bool = True, model: str = "hky", log=None) -> str:
    """Maximum-likelihood NNI refinement under HKY+Gamma(4).

    Approximates what the reference gets from FastTree2's ML stage
    (witch_msa/gcmm/backbone.py:296-319) without shelling out.  Any
    reversible model works through one eigendecomposition of the
    symmetrized rate matrix: P(t) = A diag(exp(lambda r t)) Ainv, so
    CLV propagation is two [K,K] matmuls per edge per rate category.
    For DNA the exchangeabilities are HKY (kappa grid-estimated on the
    start tree); other alphabets get equal-input (F81) with empirical
    frequencies.  Rate heterogeneity uses 4 equal-probability gamma
    categories (Yang 1994 median rates), alpha grid-estimated.

    Conditional likelihoods are kept per site pattern with one shared
    per-site scale across categories; NNI candidates around an edge
    share the four subtree CLVs so scales cancel and the three
    pairings compare by exact conditional likelihood with the central
    branch re-optimized (golden section over log t) per pairing.
    Sweeps are verified against the recomputed total likelihood and
    reverted when batched stale-CLV updates regress it.
    """
    K = aln.alphabet.K
    t = _Tree.parse(newick)
    n_nodes = len(t.children)
    root = next(i for i in range(n_nodes) if t.parent[i] < 0)
    name_to_row = {nm: r for r, nm in enumerate(aln.names)}
    # site-pattern compression: identical columns share one CLV slot
    pat, w = np.unique(aln.codes.T, axis=0, return_counts=True)
    P = pat.shape[0]
    w = w.astype(np.float64)
    cnt = np.bincount(aln.codes[aln.codes < K].ravel(),
                      minlength=K).astype(np.float64) + 1.0
    pi = cnt / cnt.sum()
    T_MIN, T_MAX = 1e-6, 10.0
    S_MIN, S_MAX = np.log(T_MIN), np.log(T_MAX)

    def gamma_rates(alpha, C=4):
        if not np.isfinite(alpha):
            return np.ones(1)
        from scipy.stats import gamma as _gamma
        qs = (np.arange(C) + 0.5) / C
        r = _gamma.ppf(qs, alpha, scale=1.0 / alpha)
        return np.maximum(r / r.mean(), 1e-6)

    # model state (rebuilt by set_model)
    mdl = {}

    # exchangeability pair order for full GTR (canonical "ACGT"):
    # AC, AG, AT, CG, CT, GT — GT is the reference rate (fixed 1.0)
    GTR_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

    def set_model(kappa, alpha, ex=None):
        S = np.ones((K, K))
        if K == 4 and ex is not None:
            for r, (a, b) in zip(ex, GTR_PAIRS):
                S[a, b] = S[b, a] = r
        elif K == 4 and kappa is not None:
            S[0, 2] = S[2, 0] = kappa      # A<->G (canonical "ACGT")
            S[1, 3] = S[3, 1] = kappa      # C<->T
        Q = S * pi[None, :]
        np.fill_diagonal(Q, 0.0)
        np.fill_diagonal(Q, -Q.sum(1))
        Q /= -(pi * np.diag(Q)).sum()      # 1 expected subst / unit t
        d = np.sqrt(pi)
        B = Q * d[:, None] / d[None, :]
        lam, U = np.linalg.eigh(0.5 * (B + B.T))
        mdl["lam"] = lam
        mdl["A"] = U / d[:, None]          # P(t) = A e^{lam t} Ainv
        mdl["Ainv"] = U.T * d[None, :]
        mdl["rates"] = gamma_rates(alpha)
        mdl["C"] = len(mdl["rates"])

    def make_leaf(i):
        row = pat[:, name_to_row[t.name[i]]]
        m = np.ones((P, K))
        ok = row < K
        m[ok] = 0.0
        m[ok, row[ok]] = 1.0
        return np.broadcast_to(m, (mdl["C"], P, K))

    def pv(clv, blen):
        b = min(max(float(blen), T_MIN), T_MAX)
        scale = np.exp(np.outer(mdl["rates"], mdl["lam"]) * b)
        y = clv @ mdl["Ainv"].T
        y = y * scale[:, None, :]
        return np.maximum(y @ mdl["A"].T, 0.0)

    def opt_t(coeff, t0):
        """maximize f(t) = w . log(mean_c sum_m coeff[c,:,m] e^{lam_m
        r_c t}) by golden section over log t; keep t0 unless strictly
        better (flat objectives drift to a bracket end)."""
        lam, rates = mdl["lam"], mdl["rates"]

        def f(s):
            e = np.exp(np.outer(rates, lam) * np.exp(s))
            v = np.einsum("cpm,cm->p", coeff, e) / mdl["C"]
            return float(w @ np.log(np.maximum(v, 1e-300)))
        lo, hi = S_MIN, S_MAX
        gr = 0.6180339887498949
        c = hi - gr * (hi - lo)
        d_ = lo + gr * (hi - lo)
        fc, fd = f(c), f(d_)
        for _ in range(24):
            if fc >= fd:
                hi, d_, fd = d_, c, fc
                c = hi - gr * (hi - lo)
                fc = f(c)
            else:
                lo, c, fc = c, d_, fd
                d_ = lo + gr * (hi - lo)
                fd = f(d_)
        s = 0.5 * (lo + hi)
        fs = f(s)
        s0 = np.log(min(max(float(t0), T_MIN), T_MAX))
        f0 = f(s0)
        return (np.exp(s), fs) if fs > f0 + 1e-9 else (float(t0), f0)

    def edge_coeff(x, y):
        """coefficients for the edge likelihood between CLVs x
        (gets the pi prior) and y: f(t) = sum_m u_m v_m e^{lam r t}"""
        u = (pi * x) @ mdl["A"]
        v = y @ mdl["Ainv"].T
        return u * v

    def orders():
        seen = []
        stack = [root]
        while stack:
            x = stack.pop()
            seen.append(x)
            stack.extend(t.children[x])
        return seen                                # pre-order

    def passes(need_down=True):
        pre = orders()
        C = mdl["C"]
        up = np.empty((n_nodes, C, P, K))
        slog = np.zeros((n_nodes, P))
        for x in pre[::-1]:
            if not t.children[x]:
                up[x] = make_leaf(x)
                slog[x] = 0.0
                continue
            acc = None
            sl = np.zeros(P)
            for c in t.children[x]:
                pc = pv(up[c], t.blen[c])
                acc = pc if acc is None else acc * pc
                sl += slog[c]
            m = np.maximum(acc.max((0, 2)), 1e-300)
            up[x] = acc / m[None, :, None]
            slog[x] = sl + np.log(m)
        if not need_down:
            return up, slog, None, None
        down = np.ones((n_nodes, C, P, K))
        dlog = np.zeros((n_nodes, P))
        for x in pre:
            p = t.parent[x]
            if p < 0:
                continue
            acc = None
            sl = np.zeros(P)
            if t.parent[p] >= 0:
                acc = pv(down[p], t.blen[p])
                sl += dlog[p]
            for sib in t.children[p]:
                if sib == x:
                    continue
                ps = pv(up[sib], t.blen[sib])
                acc = ps if acc is None else acc * ps
                sl += slog[sib]
            m = np.maximum(acc.max((0, 2)), 1e-300)
            down[x] = acc / m[None, :, None]
            dlog[x] = sl + np.log(m)
        return up, slog, down, dlog

    def total_loglik(up, slog):
        like = (pi * up[root]).sum(-1).mean(0)
        return float(w @ (np.log(np.maximum(like, 1e-300)) + slog[root]))

    def current_ll():
        up, slog, _, _ = passes(need_down=False)
        return total_loglik(up, slog)

    def save_state():
        return ([list(c) for c in t.children], list(t.parent),
                list(t.blen))

    def restore_state(st):
        t.children = [list(c) for c in st[0]]
        t.parent = list(st[1])
        t.blen = list(st[2])

    def bl_pass():
        """One Jacobi round of per-edge length optimization on frozen
        CLVs (edges interact, so the outer loop verifies globally)."""
        up, slog, down, dlog = passes()
        for x in orders():
            if t.parent[x] < 0:
                continue
            co = edge_coeff(up[x], down[x])
            t.blen[x], _ = opt_t(co, t.blen[x])

    def nni_pass(max_swaps):
        up, slog, down, dlog = passes()
        swaps = 0
        dirty = set()
        for v in range(n_nodes):
            u = t.parent[v]
            if u < 0 or len(t.children[v]) != 2:
                continue
            if v in dirty or u in dirty:
                continue
            A_, B_ = t.children[v]
            sibs = [c for c in t.children[u] if c != v]
            if not sibs:
                continue
            C_ = sibs[0]
            acc = None
            if t.parent[u] >= 0:
                acc = pv(down[u], t.blen[u])
            for c in t.children[u]:
                if c in (v, C_):
                    continue
                pc = pv(up[c], t.blen[c])
                acc = pc if acc is None else acc * pc
            if acc is None:
                continue
            UA = pv(up[A_], t.blen[A_])
            UB = pv(up[B_], t.blen[B_])
            UC = pv(up[C_], t.blen[C_])
            UR = acc
            res = []
            for x_, y_ in ((UA * UB, UC * UR), (UA * UC, UB * UR),
                           (UB * UC, UA * UR)):
                res.append(opt_t(edge_coeff(x_, y_), t.blen[v]))
            cur, alt_a = res[0], res[1]
            best = max(res, key=lambda r: r[1])
            if best[1] <= cur[1] + 1e-4:
                continue
            swap_child = B_ if best is alt_a else A_
            t.children[v].remove(swap_child)
            t.children[u].remove(C_)
            t.children[v].append(C_)
            t.children[u].append(swap_child)
            t.parent[C_] = v
            t.parent[swap_child] = u
            t.blen[v] = best[0]
            swaps += 1
            if swaps >= max_swaps:
                break
            # CLVs are stale after a swap everywhere on the path to the
            # root; lock the immediate neighborhood and let the outer
            # monotone guard catch cross-talk between distant swaps
            dirty.update((u, v, t.parent[u]))
            dirty.update(t.children[u])
            dirty.update(t.children[v])
        return swaps

    def detach_leaf(x):
        """Prune leaf x; its parent p is parked (parent=-2, no
        children) for regrafting.  Returns restore info, or None when
        x hangs off the root or a polytomy."""
        p = t.parent[x]
        if p < 0 or t.parent[p] < 0 or len(t.children[p]) != 2:
            return None
        g = t.parent[p]
        ch = t.children[p]
        s = ch[0] if ch[1] == x else ch[1]
        info = (x, p, g, s, t.blen[s], t.blen[p], list(t.children[g]))
        t.children[g][t.children[g].index(p)] = s
        t.parent[s] = g
        t.blen[s] = t.blen[s] + t.blen[p]
        t.children[p] = []
        t.parent[p] = -2
        return info

    def undo_detach(info):
        x, p, g, s, bs, bp, gch = info
        t.children[g] = list(gch)
        t.parent[p] = g
        t.children[p] = [s, x]
        t.parent[s] = p
        t.parent[x] = p
        t.blen[s] = bs
        t.blen[p] = bp

    def regraft(x, p, c):
        """Reinsert parked node p (carrying leaf x) into edge above c."""
        g2 = t.parent[c]
        t.children[g2][t.children[g2].index(c)] = p
        t.parent[p] = g2
        t.children[p] = [c, x]
        t.parent[c] = p
        t.parent[x] = p
        half = max(t.blen[c] * 0.5, T_MIN)
        t.blen[p] = half
        t.blen[c] = half

    def spr_pass(ll_now, max_moves=6, subtrees=False):
        """SPR: prune-and-regraft for clades that NNI cannot walk out
        of a wrong position (each NNI step through the intervening
        edges is individually non-improving, so pure NNI stalls;
        FastTree escapes the same way).  Candidates are the longest
        branches (terminal only, or any subtree edge with
        subtrees=True) -- a misplaced clade gets its branch stretched.
        Each candidate is pruned exactly, every edge of the pruned
        tree is scored by the exact three-way joint at the insertion
        point (per-edge scale logs included so scores compare across
        edges; the pruned clade's own scale log is a constant), and
        the winning regraft is kept only if the exact recomputed total
        likelihood improves."""
        cand_nodes = [i for i in range(n_nodes)
                      if t.parent[i] >= 0 and
                      (t.children[i] if subtrees
                       else (not t.children[i] and
                             t.name[i] is not None))]
        cand_nodes.sort(key=lambda i: -t.blen[i])
        cand = cand_nodes[:min(25, max(4, len(cand_nodes) // 10))]
        moves = 0
        up_pre = slog_pre = None
        for x in cand:
            if moves >= max_moves:
                break
            if t.children[x]:
                if up_pre is None:
                    up_pre, slog_pre, _, _ = passes(need_down=False)
                Xclv = up_pre[x]
            else:
                Xclv = np.array(make_leaf(x))
            info = detach_leaf(x)
            if info is None:
                continue
            up, slog, down, dlog = passes()
            X = pv(Xclv, t.blen[x])
            best_c, best_val, stay_val = None, -np.inf, -np.inf
            for c in orders():
                if t.parent[c] < 0:
                    continue
                half = max(t.blen[c] * 0.5, T_MIN)
                inside = pv(up[c], half) * X
                like = (pi * inside * pv(down[c], half)).sum(-1).mean(0)
                val = float(w @ (np.log(np.maximum(like, 1e-300))
                                 + slog[c] + dlog[c]))
                if c == info[3]:
                    stay_val = val
                if val > best_val:
                    best_val, best_c = val, c
            if best_c is None or best_c == info[3] \
                    or best_val <= stay_val + 1e-2:
                undo_detach(info)
                continue
            regraft(x, info[1], best_c)
            ll_new = current_ll()
            if ll_new > ll_now + 1e-6:
                ll_now = ll_new
                moves += 1
                up_pre = slog_pre = None   # topology changed
                if log:
                    log("ml spr: regrafted %s (logL %.2f)"
                        % (t.name[x] if t.name[x] is not None
                           else "clade@%d" % x, ll_now))
            else:
                detach_leaf(x)
                undo_detach(info)
        return moves, ll_now

    # model selection: kappa x alpha grid, then golden refinement of
    # each parameter (in log space); repeated mid-refinement because
    # the optimal rates shift as the topology and lengths improve
    state = {"kappa": 4.0 if K == 4 else None, "alpha": 1.0}

    def tune_model():
        if K == 4:
            grid = [(ka, al) for ka in (1.0, 2.0, 4.0, 8.0)
                    for al in (0.25, 0.5, 1.0, np.inf)]
        else:
            grid = [(None, al) for al in (0.25, 0.5, 1.0, np.inf)]
        best = None
        for ka, al in grid:
            set_model(ka, al)
            ll = current_ll()
            if best is None or ll > best[0]:
                best = (ll, ka, al)
        ll_b, ka, al = best
        if not tune and model != "gtr":
            state["kappa"], state["alpha"] = ka, al
            set_model(ka, al)
            if log:
                log("ml model: kappa=%s alpha=%s logL %.2f (grid)"
                    % (ka, al, ll_b))
            return ll_b

        def golden(setter, lo, hi, x0, f0):
            gr = 0.6180339887498949
            c = hi - gr * (hi - lo)
            d_ = lo + gr * (hi - lo)

            def f(x):
                setter(x)
                return current_ll()
            fc, fd = f(c), f(d_)
            for _ in range(6):
                if fc >= fd:
                    hi, d_, fd = d_, c, fc
                    c = hi - gr * (hi - lo)
                    fc = f(c)
                else:
                    lo, c, fc = c, d_, fd
                    d_ = lo + gr * (hi - lo)
                    fd = f(d_)
            x = 0.5 * (lo + hi)
            fx = f(x)
            return (x, fx) if fx > f0 else (x0, f0)

        if np.isfinite(al):
            al, ll_b = golden(lambda a: set_model(ka, np.exp(a)),
                              np.log(0.05), np.log(8.0),
                              np.log(al), ll_b)
            al = float(np.exp(al))
        if ka is not None:
            ka, ll_b = golden(lambda k: set_model(np.exp(k), al),
                              np.log(0.5), np.log(32.0),
                              np.log(ka), ll_b)
            ka = float(np.exp(ka))
        state["kappa"], state["alpha"] = ka, al
        set_model(ka, al)
        if model == "gtr" and K == 4:
            # full 6-parameter GTR: start from the fitted HKY (AG=CT=
            # kappa) and coordinate-descent the 5 free exchangeabilities
            # (GT fixed at 1) by golden section in log space — the same
            # continuous fit FastTree's -gtr performs
            # (witch_msa/gcmm/backbone.py:305).
            ex = np.ones(6)
            ex[1] = ex[4] = ka if ka is not None else 1.0
            for _round in range(2):
                for p in range(5):
                    def setter(v, p=p):
                        ex[p] = np.exp(v)
                        set_model(None, al, ex=ex)
                    x, ll_b = golden(setter, np.log(0.05), np.log(32.0),
                                     np.log(ex[p]), ll_b)
                    ex[p] = float(np.exp(x))
                al, ll_b = golden(
                    lambda a: set_model(None, np.exp(a), ex=ex),
                    np.log(0.05), np.log(8.0), np.log(al), ll_b)
                al = float(np.exp(al))
            state["ex"], state["alpha"] = ex.copy(), al
            set_model(None, al, ex=ex)
            if log:
                log("ml model: GTR ex=%s alpha=%.3f logL %.2f"
                    % (np.round(ex, 3).tolist(), al, ll_b))
            return ll_b
        if log:
            log("ml model: kappa=%s alpha=%s logL %.2f" % (ka, al, ll_b))
        return ll_b

    ll_cur = tune_model()

    # monotone outer loop: every phase is verified against the exact
    # recomputed likelihood and reverted if it regressed (Jacobi branch
    # updates and batched stale-CLV swaps are only locally optimal)
    for sweep in range(max_sweeps):
        st = save_state()
        bl_pass()
        ll_new = current_ll()
        if ll_new > ll_cur + 1e-9:
            ll_cur = ll_new
        else:
            restore_state(st)
        st = save_state()
        swaps = nni_pass(n_nodes)
        progressed = False
        if swaps:
            ll_new = current_ll()
            if ll_new > ll_cur + 1e-9:
                ll_cur = ll_new
                progressed = True
            else:
                # batch conflicted; retry with the single best swap
                restore_state(st)
                if nni_pass(1):
                    ll_new = current_ll()
                    if ll_new > ll_cur + 1e-9:
                        ll_cur = ll_new
                        progressed = True
                        swaps = 1
                    else:
                        restore_state(st)
        if not progressed:
            # NNI converged; try escaping with single-leaf SPR, then
            # whole-subtree SPR (FastTree moves subtrees too)
            moves, ll_spr = spr_pass(ll_cur)
            if moves:
                ll_cur = ll_spr
                progressed = True
            else:
                moves, ll_spr = spr_pass(ll_cur, subtrees=True)
                if moves:
                    ll_cur = ll_spr
                    progressed = True
        if log:
            log("ml sweep %d: logL %.2f, %d swaps%s"
                % (sweep, ll_cur, swaps if progressed else 0,
                   "" if progressed or not swaps else " (reverted)"))
        if not progressed:
            break
        if sweep == 3 and (tune or model == "gtr"):
            ll_cur = max(ll_cur, tune_model())
    if log:
        log("ml refinement: final logL %.2f" % ll_cur)
    return t.newick()


def estimate_tree(aln: PackedAlignment, out_path: Optional[str], device,
                  nni: bool = True, ml: bool = False, model: str = "hky",
                  log=None) -> str:
    """Newick of the backbone tree (witch_tpu/tree_estimate.py:867-894
    with the device distances); written to out_path when given."""
    nwk = neighbor_joining(pairwise_distances(aln, device), aln.names)
    if nni:
        try:
            nwk = nni_refine(nwk, aln, log=log)
        except Exception as e:   # noqa: BLE001 - the reference's contract
            if log:
                log("nni refinement skipped (%s)" % e)
    if ml:
        try:
            nwk = ml_refine(nwk, aln, max_sweeps=8, tune=False,
                            model=model, log=log)
        except Exception as e:   # noqa: BLE001 - the reference's contract
            if log:
                log("ml refinement skipped (%s)" % e)
    if out_path:
        with open(out_path, "w") as f:
            f.write(nwk + "\n")
    return nwk
