"""Multihit flank posterior rows for the reporting-gate prefilter: kernel
(csrc/flank.cu), its plain PyTorch version, and the wrapper.

Counterpart of witch_tpu/hmm/flank_device.py:_flank_one, vmapped over
the [Q, H] grid by flank_rows_bank (XLA scans there, not a Pallas
kernel). Per (model, query) pair: a multihit Forward and Backward in
the odds domain, rescaled per row by max(M, C, N) with a 1e-35 floor,
combined into the special-state posterior rows the region finder reads:
fwd (nats), and ppB, ppE, mocc over rows 0..L, zero past the query.
Outputs keep the JAX layout: fwd [Q, H], rows [Q, H, Lmax + 1], f32.
"""

from __future__ import annotations

import math

import torch

from .. import _build
from ..device import BankTensors
from ._plain import (bck_chain, bck_chain_coeffs, fwd_chain,
                     fwd_chain_coeffs, shift_l, shift_r)

FLANK_FLOOR = 1e-35          # flank_device.py:93,143
SCRATCH_BYTES = 2 << 30      # device scratch for the stored Forward specials


def flank_rows_ref(bt: BankTensors, codes: torch.Tensor,
                   qlens: torch.Tensor, elems: int = 1 << 24):
    """Plain version: (fwd [Q, H], ppB, ppE, mocc [Q, H, Lc + 1]) on the
    bank's device, query chunks of at most `elems` DP cells per row."""
    H, Mp = bt.H, bt.Mp
    dev = codes.device
    tr = bt.trans[:, :, None, :]                 # [H, 8, 1, Mp]
    tmm, tmi, tmd, tim, tii, tdm, tdd, bm = (tr[:, r] for r in range(8))
    Af, Ab = fwd_chain_coeffs(tdd), bck_chain_coeffs(tdd)
    Q, Lc = codes.shape
    W = Lc + 1
    fwd = torch.zeros((Q, H), dtype=torch.float32, device=dev)
    outs = [torch.zeros((Q, H, W), dtype=torch.float32, device=dev)
            for _ in range(3)]
    qc = max(1, elems // max(1, H * Mp))
    for q0 in range(0, Q, qc):
        sl = slice(q0, min(Q, q0 + qc))
        f, rows = _flank_chunk(bt, codes[sl].long(), qlens[sl], tmm, tmi,
                               tmd, tim, tii, tdm, bm, Af, Ab)
        fwd[sl] = f
        for o, r in zip(outs, rows):
            o[sl, :, :r.shape[-1]] = r
    return (fwd,) + tuple(outs)


def _flank_chunk(bt, c, ql, tmm, tmi, tmd, tim, tii, tdm, bm, Af, Ab):
    H, Mp = bt.H, bt.Mp
    dev = c.device
    n = c.shape[0]
    Lmax = int(ql.max().item()) if n else 0
    inf = float("inf")
    qlf = ql.to(torch.float32)[None, :]                  # [1, n]
    pmove = 3.0 / (qlf + 3.0)
    ploop = 1.0 - pmove
    log_loop = torch.log(ploop)

    def emis(i):
        return bt.em.index_select(1, c[:, i].clamp(min=0))   # [H, n, Mp]

    # ---- forward, log specials N B J C E of rows 0..Lmax ----
    z = torch.zeros((H, n, Mp), dtype=torch.float32, device=dev)
    M, I, D = z, z, z
    N = torch.ones((H, n), device=dev)
    B = pmove.expand(H, n).clone()
    J = torch.zeros((H, n), device=dev)
    C = torch.zeros((H, n), device=dev)
    logs = torch.zeros((H, n), device=dev)
    logF = torch.full((Lmax + 1, 5, H, n), -inf, device=dev)
    logF[0] = torch.log(torch.stack([torch.ones_like(B), B,
                                     torch.zeros_like(B), torch.zeros_like(B),
                                     torch.zeros_like(B)]))
    for i in range(Lmax):
        e = emis(i)
        src = shift_r(M * tmm + I * tim + D * tdm) + B[..., None] * bm
        Mr = src * e
        Ir = M * tmi + I * tii
        Dr = fwd_chain(shift_r(Mr * tmd), Af)
        E = Mr.sum(-1) + Dr.sum(-1)
        Jn = J * ploop + E * 0.5
        Cn = C * ploop + E * 0.5
        Nn = N * ploop
        Bn = Nn * pmove + Jn * pmove
        ys = torch.log(torch.stack([Nn, Bn, Jn, Cn, E])) + logs
        scale = torch.maximum(Mr.amax(-1), torch.maximum(Cn, Nn)).clamp(
            min=FLANK_FLOOR)
        inv = 1.0 / scale
        keep = (i < ql)[None, :]
        k3 = keep[..., None]
        logF[i + 1] = torch.where(keep, ys, -inf)
        M = torch.where(k3, Mr * inv[..., None], M)
        I = torch.where(k3, Ir * inv[..., None], I)
        D = torch.where(k3, Dr * inv[..., None], D)
        N = torch.where(keep, Nn * inv, N)
        B = torch.where(keep, Bn * inv, B)
        J = torch.where(keep, Jn * inv, J)
        C = torch.where(keep, Cn * inv, C)
        logs = torch.where(keep, logs + torch.log(scale), logs)
    fwd = torch.log(C * pmove) + logs                      # [H, n]

    # ---- backward (right to left), log specials N J C B E ----
    EL = (pmove * 0.5)[..., None]                          # [1, n, 1]
    DL = bck_chain(EL.expand(H, n, Mp), Ab)    # D[k] = EL + tdd[k] D[k+1]
    Mn = EL + shift_l(DL) * tmd
    Mn[..., 0] = 0.0
    In = torch.zeros_like(Mn)
    bN = torch.zeros((H, n), device=dev)
    bJ = torch.zeros((H, n), device=dev)
    bC = pmove.expand(H, n).clone()
    blogs = torch.zeros((H, n), device=dev)
    logB = torch.full((Lmax + 1, 5, H, n), -inf, device=dev)
    for i in range(Lmax - 1, -1, -1):
        mne = Mn * emis(i)
        Bv = (bm * mne).sum(-1)
        Ni = bN * ploop + Bv * pmove
        Ji = bJ * ploop + Bv * pmove
        Ci = bC * ploop
        Ei = Ci * 0.5 + Ji * 0.5
        # D[k] = c[k] + tdd[k] D[k+1]: tdd unshifted (flank_device.py:128)
        Di = bck_chain(shift_l(mne) * tdm + Ei[..., None], Ab)
        Mi = Ei[..., None] + shift_l(mne) * tmm + In * tmi \
            + shift_l(Di) * tmd
        Ii = shift_l(mne) * tim + In * tii
        ys = torch.log(torch.stack([Ni, Ji, Ci, Bv, Ei])) + blogs
        scale = torch.maximum(Mi.amax(-1), torch.maximum(Ni, Ci)).clamp(
            min=FLANK_FLOOR)
        inv = 1.0 / scale
        keep = (i < ql)[None, :]
        k3 = keep[..., None]
        logB[i] = torch.where(keep, ys, -inf)
        Mn = torch.where(k3, Mi * inv[..., None], Mn)
        In = torch.where(k3, Ii * inv[..., None], In)
        bN = torch.where(keep, Ni * inv, bN)
        bJ = torch.where(keep, Ji * inv, bJ)
        bC = torch.where(keep, Ci * inv, bC)
        blogs = torch.where(keep, blogs + torch.log(scale), blogs)
    # row qlen: N = J = B = -inf, C = move, E = move * e_move
    lpm = torch.log(pmove)[0]                              # [n]
    bL = torch.stack([torch.full_like(lpm, -inf), torch.full_like(lpm, -inf),
                      lpm, torch.full_like(lpm, -inf),
                      lpm + math.log(0.5)])                # [5, n]
    ar = torch.arange(n, device=dev)
    logB[ql.long(), :, :, ar] = bL.T[:, :, None].expand(n, 5, H)

    # ---- combine (flank_device.py:182-197) ----
    rows_i = torch.arange(Lmax + 1, device=dev)[:, None, None]
    qlb = ql[None, None, :]
    live = (rows_i >= 1) & (rows_i <= qlb)
    upto = rows_i <= qlb
    neg1 = torch.full((1, H, n), -inf, device=dev)

    def shF(v):
        return torch.cat([neg1, v[:-1]], dim=0)

    fN, fB, fJ, fC, fE = (logF[:, k] for k in range(5))
    bN_, bJ_, bC_, bB_, bE_ = (logB[:, k] for k in range(5))
    ppN = torch.where(live, torch.exp(shF(fN) + log_loop + bN_ - fwd), 0.0)
    ppJ = torch.where(live, torch.exp(shF(fJ) + log_loop + bJ_ - fwd), 0.0)
    ppC = torch.where(live, torch.exp(shF(fC) + log_loop + bC_ - fwd), 0.0)
    ppB = torch.where(upto, torch.exp(fB + bB_ - fwd), 0.0)
    ppE = torch.where(upto, torch.exp(fE + bE_ - fwd), 0.0)
    mocc = 1.0 - (torch.nan_to_num(ppN) + torch.nan_to_num(ppJ)
                  + torch.nan_to_num(ppC))
    mocc = torch.where(live, mocc, 0.0)
    # [L + 1, H, n] -> [n, H, L + 1]
    rows = tuple(x.permute(2, 1, 0) for x in (
        torch.nan_to_num(ppB), torch.nan_to_num(ppE), mocc))
    return fwd.T, rows


def flank_rows(bt: BankTensors, codes: torch.Tensor, qlens: torch.Tensor):
    """(fwd [Q, H], ppB, ppE, mocc [Q, H, Lc + 1]) f32 on the bank's
    device: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    dev = bt.device
    if codes.device != dev or qlens.device != dev:
        raise ValueError("bank, codes and qlens must share a device")
    if dev.type == "cpu":
        return flank_rows_ref(bt, codes, qlens)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    codes = codes.to(torch.int32).contiguous()
    qlens = qlens.to(torch.int32).contiguous()
    if codes.dim() != 2 or qlens.shape != (codes.shape[0],):
        raise ValueError("codes [Q, L] and qlens [Q] expected")
    Q, Lc = codes.shape
    H, W = bt.H, Lc + 1
    fwd = torch.empty((Q, H), dtype=torch.float32, device=dev)
    outs = [torch.empty((Q, H, W), dtype=torch.float32, device=dev)
            for _ in range(3)]
    if Q == 0 or H == 0:
        return (fwd,) + tuple(outs)
    chunk = max(1, min(Q, SCRATCH_BYTES // (H * W * 5 * 4)))
    fspec = torch.empty(chunk * H * W * 5, dtype=torch.float32, device=dev)
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    for q0 in range(0, Q, chunk):
        m = min(chunk, Q - q0)
        rc = lib.witch_flank(
            bt.em.data_ptr(), bt.trans.data_ptr(), codes[q0:].data_ptr(),
            qlens[q0:].data_ptr(), fwd[q0:].data_ptr(),
            outs[0][q0:].data_ptr(), outs[1][q0:].data_ptr(),
            outs[2][q0:].data_ptr(), fspec.data_ptr(), H, m, bt.Mp, bt.K,
            Lc, W, stream)
        _build.check(rc, "flank")
    return (fwd,) + tuple(outs)
