"""HMMER's Plan7 dynamic programming in plain PyTorch, batched over
(fragment, model) pairs: the search profile's configuration, Forward and
Backward in log space, posterior decoding and the optimal-accuracy (OA)
fill.

A batch pads its models to one width with states that no path reaches
(-inf scores), and its fragments to one length; each pair keeps its own
length model. The delete chain of a row is a linear recurrence, solved
in closed form with cumulative sums of its log transitions and a
log-cumulative-sum-exp, as HMMER's semantics allow (no approximation).
The dtype is the caller's: float64 for the reference, a lower precision
for its control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .hmmbuild import BACKGROUND, TDD, TDM, TII, TIM, TMD, TMI, TMM

NEG = float("-inf")
FLT_MIN = 1.17549435e-38    # HMMER's multiplier of a disallowed OA move
OMEGA = 1.0 / 256.0


def configure(model):
    """Local search profile of a Model (HMMER's p7_ProfileConfig): match
    log-odds against the background, insert scores 0, local entry B->Mk
    by occupancy, free exits; log transitions out of each node.
    Returns {name: float64 array [M+1]} and msc [M+1, 4]."""
    M = model.M
    t = model.trans
    with np.errstate(divide="ignore"):
        msc = np.log(model.mat / BACKGROUND[None, :])
        msc[0] = NEG
        prof = {n: np.log(t[:, c]) for n, c in
                (("tmm", TMM), ("tmi", TMI), ("tmd", TMD), ("tim", TIM),
                 ("tii", TII), ("tdm", TDM), ("tdd", TDD))}
    for n in ("tmi", "tim", "tii"):
        prof[n][M] = NEG                    # no insert state at node M
    occ = np.zeros(M + 1)
    occ[1] = t[0, TMI] + t[0, TMM]
    for k in range(2, M + 1):
        occ[k] = (occ[k - 1] * (t[k - 1, TMM] + t[k - 1, TMI])
                  + (1.0 - occ[k - 1]) * t[k - 1, TDM])
    Z = (occ[1:] * (M - np.arange(1, M + 1) + 1)).sum()
    bm = np.full(M + 1, NEG)
    with np.errstate(divide="ignore"):
        bm[1:] = np.log(occ[1:] / Z)
    prof["bm"] = bm
    return prof, msc


class Batch:
    """Pairs (model profile, fragment codes) padded into tensors."""

    NAMES = ("tmm", "tmi", "tmd", "tim", "tii", "tdm", "tdd", "bm")

    def __init__(self, profiles, codes_list, dtype, device, Lmodel=None):
        B = len(profiles)
        self.B = B
        self.M = torch.tensor([p[1].shape[0] - 1 for p in profiles],
                              device=device)
        M1 = int(self.M.max()) + 1
        self.M1 = M1
        self.lens = torch.tensor([len(c) for c in codes_list], device=device)
        Lmax = int(self.lens.max())
        self.Lmax = Lmax
        # the length the N/C/J states are configured for: the fragment's
        # own (an envelope is rescored under its whole fragment's length)
        self.Lmodel = self.lens if Lmodel is None else torch.tensor(
            Lmodel, device=device)
        t = {n: np.full((B, M1), NEG) for n in self.NAMES}
        msc = np.full((B, M1, 4), NEG)
        for b, (pr, ms) in enumerate(profiles):
            m1 = ms.shape[0]
            msc[b, :m1] = ms
            for n in self.NAMES:
                t[n][b, :m1] = pr[n]
        self.t = {n: torch.tensor(v, dtype=dtype, device=device)
                  for n, v in t.items()}
        self.msc = torch.tensor(msc, dtype=dtype, device=device)
        codes = np.zeros((B, max(Lmax, 1)), np.int64)
        for b, c in enumerate(codes_list):
            codes[b, :len(c)] = c
        self.codes = torch.tensor(codes, device=device)
        self.dtype, self.device = dtype, device
        k = torch.arange(M1, device=device)
        self.real = k[None, :] <= self.M[:, None]          # states 0..M
        self.kk = k

    def emis(self, i):
        """Match scores of residue i (1-based) for every pair [B, M1]."""
        x = self.codes[:, i - 1]
        return self.msc.gather(2, x[:, None, None].expand(
            self.B, self.M1, 1)).squeeze(2)

    def length_model(self, mode):
        """(loop, move, e_loop, e_move) [B] for the N/C/J states: mode
        "multi" (multihit, hmmsearch) or "uni" (unihit: hmmalign, and
        domain definition's rescoring of an envelope alone)."""
        L = self.Lmodel.to(self.dtype)
        z = torch.zeros_like(L)
        nj = 1.0 if mode == "multi" else 0.0
        pmove = (2.0 + nj) / (L + 2.0 + nj)
        loop, move = torch.log1p(-pmove), torch.log(pmove)
        if mode == "multi":
            h = math.log(0.5)
            return loop, move, z + h, z + h
        return loop, move, z + NEG, z


def _lse(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.logaddexp(out, x)
    return out


def _row_lse(x):
    return torch.logsumexp(x, dim=1)


def forward(bt, mode, keep_rows=False):
    """Forward. Returns (fwd [B] nats, specials {N,B,E,J,C: [B, Lmax+1]},
    rows {M, I: [B, Lmax+1, M1]} when keep_rows)."""
    B, M1, dt, dev = bt.B, bt.M1, bt.dtype, bt.device
    loop, move, e_loop, e_move = bt.length_model(mode)
    t = bt.t
    neg = torch.full((B, M1), NEG, dtype=dt, device=dev)
    Mp, Ip, Dp = neg, neg, neg
    sp = {n: torch.full((B, bt.Lmax + 1), NEG, dtype=dt, device=dev)
          for n in "NBEJC"}
    sp["N"][:, 0] = 0.0
    sp["B"][:, 0] = move
    rows = None
    if keep_rows:
        rows = {n: torch.full((B, bt.Lmax + 1, M1), NEG, dtype=dt,
                              device=dev) for n in "MI"}
    tdd = torch.where(torch.isfinite(t["tdd"]), t["tdd"],
                      torch.zeros_like(t["tdd"]))
    ca = torch.zeros_like(tdd)
    ca[:, 2:] = torch.cumsum(tdd[:, 1:-1], dim=1)     # sum tdd[1..k-1]
    ncol = torch.full((B, 1), NEG, dtype=dt, device=dev)
    for i in range(1, bt.Lmax + 1):
        act = (i <= bt.lens)
        ms = bt.emis(i)
        src = _lse(Mp[:, :-1] + t["tmm"][:, :-1], Ip[:, :-1] + t["tim"][:, :-1],
                   Dp[:, :-1] + t["tdm"][:, :-1],
                   sp["B"][:, i - 1, None] + t["bm"][:, 1:])
        Mc = torch.cat([ncol, src + ms[:, 1:]], dim=1)
        Ic = torch.cat([ncol, torch.logaddexp(Mp[:, 1:] + t["tmi"][:, 1:],
                                              Ip[:, 1:] + t["tii"][:, 1:])],
                       dim=1)
        b = torch.full_like(Mc, NEG)
        b[:, 2:] = Mc[:, 1:-1] + t["tmd"][:, 1:-1]
        Dc = ca + torch.logcumsumexp(b - ca, dim=1)
        Dc = torch.where(bt.real & (bt.kk >= 2), Dc, neg)
        E = torch.logaddexp(_row_lse(Mc[:, 1:]), _row_lse(Dc[:, 1:]))
        J = torch.logaddexp(sp["J"][:, i - 1] + loop, E + e_loop)
        C = torch.logaddexp(sp["C"][:, i - 1] + loop, E + e_move)
        N = sp["N"][:, i - 1] + loop
        Bn = torch.logaddexp(N + move, J + move)
        for n, v in (("E", E), ("J", J), ("C", C), ("N", N), ("B", Bn)):
            sp[n][:, i] = torch.where(act, v, sp[n][:, i - 1])
        Mp = torch.where(act[:, None], Mc, Mp)
        Ip = torch.where(act[:, None], Ic, Ip)
        Dp = torch.where(act[:, None], Dc, Dp)
        if keep_rows:
            rows["M"][:, i] = torch.where(act[:, None], Mc, neg)
            rows["I"][:, i] = torch.where(act[:, None], Ic, neg)
    last = sp["C"].gather(1, bt.lens[:, None]).squeeze(1)
    return last + move, sp, rows


def backward(bt, mode, fwd, fsp, frows=None, usage=False):
    """Backward, folded into posteriors as it goes. Returns
    {N, J, C: [B, Lmax+1] residue-emission posteriors of the flanks
    (row i emitted on the loop into row i), B, E: state posteriors at
    row i}, and, given the forward rows, the match and insert
    posteriors pp {M, I: [B, Lmax+1, M1]}, or with usage=True only their
    sums over the rows {M, I: [B, M1]} (the expected state usage)."""
    B, M1, dt, dev = bt.B, bt.M1, bt.dtype, bt.device
    loop, move, e_loop, e_move = bt.length_model(mode)
    t = bt.t
    neg = torch.full((B, M1), NEG, dtype=dt, device=dev)
    negv = torch.full((B,), NEG, dtype=dt, device=dev)
    post = {n: torch.zeros((B, bt.Lmax + 1), dtype=dt, device=dev)
            for n in "NJCBE"}
    pp = None
    if frows is not None:
        shape = (B, M1) if usage else (B, bt.Lmax + 1, M1)
        pp = {n: torch.zeros(shape, dtype=dt, device=dev) for n in "MI"}
    # suffix sums of tdd over [k, M-1] for each pair's own M
    tdd = torch.where(torch.isfinite(t["tdd"]) & (bt.kk < bt.M[:, None]),
                      t["tdd"], torch.zeros_like(t["tdd"]))
    ca = torch.flip(torch.cumsum(torch.flip(tdd, [1]), 1), [1])
    real1 = bt.real & (bt.kk >= 1)
    Mn, In = neg, neg          # row i+1
    Nn, Jn, Cn = negv, negv, negv
    for i in range(bt.Lmax, -1, -1):
        at_end = bt.lens == i
        inside = i < bt.lens
        if i < bt.Lmax:
            ms = bt.emis(i + 1)
            nxt = torch.cat([Mn[:, 1:] + ms[:, 1:], neg[:, :1]], dim=1)
        else:
            nxt = neg
        # nxt[k] = M(i+1, k+1) + emission of residue i+1 at k+1
        Bv = _row_lse(t["bm"][:, 1:] + nxt[:, :-1])
        Bv = torch.where(inside, Bv, negv)
        N = torch.where(inside, torch.logaddexp(Nn + loop, Bv + move), negv)
        J = torch.where(inside, torch.logaddexp(Jn + loop, Bv + move), negv)
        C = torch.where(at_end, move, torch.where(inside, Cn + loop, negv))
        E = torch.where(at_end, move + e_move,
                        torch.where(inside, torch.logaddexp(C + e_move,
                                                            J + e_loop), negv))
        c = torch.logaddexp(nxt + t["tdm"], E[:, None])
        c = torch.where(real1, c, neg)
        D = ca + torch.flip(torch.logcumsumexp(torch.flip(c - ca, [1]), 1),
                            [1])
        D = torch.where(real1, D, neg)
        Dn = torch.cat([D[:, 1:], neg[:, :1]], dim=1)
        Mc = _lse(E[:, None] + torch.zeros_like(nxt), nxt + t["tmm"],
                  In + t["tmi"], Dn + t["tmd"])
        Mc = torch.where(real1, Mc, neg)
        Ic = torch.logaddexp(nxt + t["tim"], In + t["tii"])
        Ic = torch.where(real1, Ic, neg)
        live = (i <= bt.lens)
        Mc = torch.where(live[:, None], Mc, neg)
        Ic = torch.where(live[:, None], Ic, neg)
        # posteriors at row i
        post["B"][:, i] = torch.exp(fsp["B"][:, i] + Bv - fwd)
        post["E"][:, i] = torch.exp(fsp["E"][:, i] + E - fwd)
        if i >= 1:
            for n, v in (("N", N), ("J", J), ("C", C)):
                post[n][:, i] = torch.where(
                    live, torch.exp(fsp[n][:, i - 1] + loop + v - fwd),
                    torch.zeros_like(fwd))
            if frows is not None:
                for n, v in (("M", Mc), ("I", Ic)):
                    p = torch.nan_to_num(torch.exp(frows[n][:, i] + v
                                                   - fwd[:, None]))
                    if usage:
                        pp[n] += p
                    else:
                        pp[n][:, i] = p
        Mn, In, Nn, Jn, Cn = Mc, Ic, N, J, C
    for n in post:
        post[n] = torch.nan_to_num(post[n])
    return post, pp


def oa_fill(bt, pp, post, multihit=False):
    """HMMER's optimal-accuracy fill over the posteriors (unihit: no J).
    Returns {M, I, D: [B, Lmax+1, M1], N, B, E, J, C: [B, Lmax+1]}."""
    B, M1, dt, dev = bt.B, bt.M1, bt.dtype, bt.device
    t = bt.t

    def delta(v):
        return torch.where(torch.isfinite(v), torch.ones_like(v),
                           torch.full_like(v, FLT_MIN))

    d = {n: delta(t[n]) for n in Batch.NAMES}
    neg = torch.full((B, M1), NEG, dtype=dt, device=dev)
    mx = {n: torch.full((B, bt.Lmax + 1, M1), NEG, dtype=dt, device=dev)
          for n in "MID"}
    sp = {n: torch.full((B, bt.Lmax + 1), NEG, dtype=dt, device=dev)
          for n in "NBEJC"}
    sp["N"][:, 0] = 0.0
    sp["B"][:, 0] = 0.0
    ncol = neg[:, :1]
    kM = bt.kk[None, :] < bt.M[:, None]
    for i in range(1, bt.Lmax + 1):
        pM, pI, pD = mx["M"][:, i - 1], mx["I"][:, i - 1], mx["D"][:, i - 1]
        cand = torch.maximum(
            torch.maximum(d["tmm"][:, :-1] * pM[:, :-1],
                          d["tim"][:, :-1] * pI[:, :-1]),
            torch.maximum(d["tdm"][:, :-1] * pD[:, :-1],
                          d["bm"][:, 1:] * sp["B"][:, i - 1, None]))
        Mi = torch.cat([ncol, pp["M"][:, i, 1:] + cand], dim=1)
        Mi = torch.where(bt.real, Mi, neg)
        Ii = pp["I"][:, i] + torch.maximum(d["tmi"] * pM, d["tii"] * pI)
        Ii = torch.where(kM & (bt.kk >= 1), Ii, neg)
        Di = torch.full_like(Mi, NEG)
        Di[:, 2:] = torch.cummax(d["tmd"][:, 1:-1] * Mi[:, 1:-1], dim=1).values
        Di = torch.where(bt.real, Di, neg)
        E = torch.maximum(Mi[:, 1:].max(dim=1).values,
                          Di[:, 1:].max(dim=1).values)
        Jl = sp["J"][:, i - 1] + post["J"][:, i]
        J = torch.maximum(Jl, E) if multihit else torch.full_like(E, NEG)
        Cl = torch.where(torch.isfinite(sp["C"][:, i - 1]),
                         sp["C"][:, i - 1] + post["C"][:, i],
                         torch.full_like(E, NEG))
        C = torch.maximum(Cl, E)
        N = sp["N"][:, i - 1] + post["N"][:, i]
        Bn = torch.maximum(N, J) if multihit else N
        mx["M"][:, i], mx["I"][:, i], mx["D"][:, i] = Mi, Ii, Di
        for n, v in (("E", E), ("J", J), ("C", C), ("N", N), ("B", Bn)):
            sp[n][:, i] = v
    mx.update(sp)
    return mx


def oa_columns(prof, post_b, mx_b, L):
    """HMMER's OA traceback (first maximum wins, in its select order) for
    one unihit pair; host arrays of that pair. Returns the 0-based match
    state of each residue, -1 for residues of inserts and flanks."""
    M = prof["tmm"].shape[0] - 1
    Mx, Ix, Dx = mx_b["M"], mx_b["I"], mx_b["D"]
    Cs, Es, Ns = mx_b["C"], mx_b["E"], mx_b["N"]
    ppC = post_b["C"]

    def delta(v):
        return 1.0 if v > NEG else FLT_MIN

    out = np.full(L, -1, np.int64)
    i, state, k = L, "C", 0
    for _ in range(4 * (L + M) + 16):
        if state == "N" and i == 0:
            return out
        if state == "C":
            lp = Cs[i - 1] + ppC[i] if i > 0 and np.isfinite(Cs[i - 1]) \
                else NEG
            if lp >= Es[i]:
                i -= 1
            else:
                state = "E"
        elif state == "E":
            inter = np.empty(2 * M)
            inter[0::2] = Mx[i, 1:M + 1]
            inter[1::2] = Dx[i, 1:M + 1]
            j = int(np.argmax(inter))
            state, k = ("M" if j % 2 == 0 else "D"), j // 2 + 1
        elif state == "M":
            out[i - 1] = k - 1
            cands = [delta(prof["tmm"][k - 1]) * Mx[i - 1, k - 1],
                     delta(prof["tim"][k - 1]) * Ix[i - 1, k - 1],
                     delta(prof["tdm"][k - 1]) * Dx[i - 1, k - 1],
                     delta(prof["bm"][k]) * mx_b["B"][i - 1]]
            j = int(np.argmax(cands))
            state, k = [("M", k - 1), ("I", k - 1), ("D", k - 1),
                        ("B", 0)][j]
            i -= 1
        elif state == "I":
            a = delta(prof["tmi"][k]) * Mx[i - 1, k]
            b = delta(prof["tii"][k]) * Ix[i - 1, k]
            state = "M" if a >= b else "I"
            i -= 1
        elif state == "D":
            a = delta(prof["tmd"][k - 1]) * Mx[i, k - 1]
            b = delta(prof["tdd"][k - 1]) * Dx[i, k - 1]
            state, k = ("M" if a >= b else "D"), k - 1
        elif state == "B":
            state = "N"
        elif state == "N":
            i -= 1
    raise RuntimeError("OA traceback did not end (L=%d, M=%d)" % (L, M))
