"""Multihit flank posterior rows for the reporting-gate prefilter: kernels
(csrc/flank.cu), their plain PyTorch version, and the wrapper.

Counterpart of witch_tpu/hmm/flank_device.py:_flank_one, vmapped over
the [Q, H] grid by flank_rows_bank (XLA scans there, not a Pallas
kernel). Per (model, query) pair: a multihit Forward and Backward in
the odds domain, rescaled per row by max(M, C, N) with a 1e-35 floor,
combined into the special-state posterior rows the region finder reads:
fwd (nats), and ppB, ppE, mocc over rows 0..L, zero past the query.
Outputs keep the JAX layout: fwd [Q, H], rows [Q, H, Lmax + 1], f32.

flank_layout picks the kernel by the bank width alone: wherever
ops/forward.py:fwd_layout keeps the row in registers and the model's
transitions fit in one CTA's shared memory (bank widths up to Mp 6,304),
the warp-per-pair kernel (G warps of npl states per lane per pair,
several pairs of one model per CTA, its tables laid out by flank_tables,
the queries longest first by cta_queries); wider models (from Mp 6,432)
the same design over a thread-block cluster: a pair's G = 8 C warps on C
CTAs, each CTA holding only its own slice of the tables, the row's one
meeting through distributed shared memory. The first version (one CTA
per pair) is reached only with first_version=True, for timing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import _build
from ..device import BankTensors
from ._plain import (bck_chain, bck_chain_coeffs, fwd_chain,
                     fwd_chain_coeffs, shift_l, shift_r)
from .forward import fwd_layout, length_order, slot_index, slot_tables

FLANK_FLOOR = 1e-35          # flank_device.py:93,143
SCRATCH_BYTES = 2 << 30      # device scratch for the stored Forward specials
SPEC = 5                     # stored Forward log specials per row
FLANK_WARPS = 8              # warps per CTA (csrc/flank.cu FL_THREADS / 32)
FLANK_XS = 8                 # floats per warp of a row's exchange
FLANK_WS = 4                 # loop-invariant floats per warp
FLANK_WS_C = 8               # the same in the cluster instance
FLANK_CLUSTER = 8            # most CTAs a cluster (the portable limit)
FLANK_NPL_C = (8, 16, 24)    # the cluster instance's states per lane
T_MD, T_DD = 2, 6            # transition rows (device.py:TRANS_ROWS)


def flank_layout(Mp: int):
    """(layout, G warps per pair, npl states per lane, Mpad) for a bank
    of width Mp. Layout 0, the warp-per-pair kernel: forward's register
    layout (ops/forward.py:fwd_layout) wherever it has one and the
    transitions fit in shared memory (up to Mp 6,304). Layout 1 (wider
    models), the cluster instance: the fewest CTAs C (G = 8 C warps), then
    the fewest states per lane of FLANK_NPL_C (24 keeps a CTA's slice of
    the transitions, 8 x 256 x 24 floats, in its shared memory) that
    cover Mp: C 2 and npl 16 (Mpad 8,192) from Mp 6,432 on, C 3 and npl
    24 at the 16,416-state cap."""
    layout, G, npl, Mpad = fwd_layout(Mp)
    if layout == 0 and smem_bytes(G, Mpad) <= _build.SMEM_ROWS_MAX:
        return 0, G, npl, Mpad
    for C in range(2, FLANK_CLUSTER + 1):
        need = -(-Mp // (32 * FLANK_WARPS * C))
        if need <= FLANK_NPL_C[-1]:
            npl = min(n for n in FLANK_NPL_C if n >= need)
            G = FLANK_WARPS * C
            return 1, G, npl, 32 * G * npl
    raise ValueError("flank kernel: Mp %d exceeds the widest cluster "
                     "layout" % Mp)


def smem_bytes(G: int, Mpad: int, C: int = 1) -> int:
    """Dynamic shared memory of a warp-per-pair CTA (C = 1: the model's
    transitions) or of each CTA of a cluster of C (its slice of them):
    the transitions, the double-buffered row exchange and the
    invariants."""
    if C > 1:
        return 4 * (8 * Mpad // C + 2 * G * FLANK_XS + G * FLANK_WS_C)
    wp = max(1, FLANK_WARPS // G)
    return 4 * (8 * Mpad + 2 * wp * G * FLANK_XS + wp * G * FLANK_WS)


def unit_chain(tdd: torch.Tensor) -> torch.Tensor:
    """D_1[..., k] = 1 + tdd[k] D_1[k + 1] with nothing beyond the last
    state (the Backward delete chain's response to its E state), taken in
    f64 and returned in f32."""
    t = tdd.double()
    return bck_chain(torch.ones_like(t), bck_chain_coeffs(t)).float()


def flank_slot_index(Mp: int, G: int, npl: int, C: int = 1) -> np.ndarray:
    """[Mpad] int64: the state k at each slot of a kernel's tables (-1
    beyond Mp). Each of the C CTAs holding a pair (1: the warp-per-pair
    kernel) reads its own slice of Mpad / C slots in forward's slot
    layout over its own G / C warps: slot c * Mpad / C + (j * G/C + w) *
    32 + lane holds state ((c * G/C + w) * 32 + lane) * npl + j. C = 1 is
    ops/forward.py:slot_index."""
    Gc = G // C
    c, j, w, lane = np.meshgrid(np.arange(C), np.arange(npl), np.arange(Gc),
                                np.arange(32), indexing="ij")
    k = (((c * Gc + w) * 32 + lane) * npl + j).reshape(-1)
    return np.where(k < Mp, k, -1)


def flank_tables(bt: BankTensors, G: int, npl: int, C: int = 1):
    """The flank kernels' tables, cached on the bank. C = 1, the
    warp-per-pair kernel, in forward's slot layout
    (ops/forward.py:slot_index over Mpad = 32 G npl states):
      em_t [H, K, Mpad]  emissions (ops/forward.py:slot_tables);
      tr_t [H, 8, Mpad]  transitions, with t_md and t_dd of state Mp - 1
                         zeroed: the plain chains never read them (its
                         Forward has no D[Mp], its Backward's D[Mp - 1]
                         sees nothing beyond), the kernel's padded row
                         would;
      d1_t [H, Mpad]     D_1 = unit_chain over the padded t_dd: a
                         Backward row's delete chain is D = D_c + E D_1,
                         D_c the chain over c[k] = mne[k + 1] t_dm[k]
                         alone, so the kernel runs D_c before E is known
                         and reads D_1 where a lane's chain enters.
    C > 1, the cluster instance: each CTA's slice in flank_slot_index's
    order, em_t [H, K, Mpad] (slices side by side), tr_t [H, C, 8, Mpad /
    C] (a CTA's transitions together), and d1_t [H, 32 G]: D_1 at the
    first state of the next lane, (v + 1) npl for lane v of the pair, 0
    after the last."""
    key = ("flank_slots", G, npl, C)
    hit = bt.cache.get(key)
    if hit is None:
        Mpad = 32 * G * npl
        tr = torch.zeros((bt.H, 8, Mpad), dtype=torch.float32,
                         device=bt.device)
        tr[:, :, :bt.Mp] = bt.trans
        tr[:, T_MD, bt.Mp - 1] = 0.0
        tr[:, T_DD, bt.Mp - 1] = 0.0
        if C == 1:
            k = torch.as_tensor(slot_index(Mpad, G, npl), device=bt.device)
            hit = (slot_tables(bt, G, npl)[0],
                   tr.index_select(2, k).contiguous(),
                   unit_chain(tr[:, T_DD]).index_select(1, k).contiguous())
        else:
            ks = flank_slot_index(bt.Mp, G, npl, C)
            src = torch.as_tensor(np.maximum(ks, 0), device=bt.device)
            live = torch.as_tensor(ks >= 0, device=bt.device)
            em = bt.em.index_select(2, src) * live
            k = torch.as_tensor(flank_slot_index(Mpad, G, npl, C),
                                device=bt.device)
            trs = tr.index_select(2, k).reshape(bt.H, 8, C, Mpad // C)
            d1 = unit_chain(tr[:, T_DD])
            nxt = torch.arange(1, 32 * G + 1, device=bt.device) * npl
            d1n = torch.where(nxt < Mpad, d1[:, nxt.clamp(max=Mpad - 1)],
                              torch.zeros((), device=bt.device))
            hit = (em.contiguous(), trs.transpose(1, 2).contiguous(),
                   d1n.contiguous())
        bt.cache[key] = hit
    return hit


def cta_queries(qlens: torch.Tensor, wp: int) -> torch.Tensor:
    """The query of each pair slot of the warp-per-pair kernel, int32
    [ceil(Q / wp) * wp]: slot s is the s-th longest query (length_order),
    -1 past the last. CTA c runs model c % H on slots (c // H) * wp ..
    + wp - 1 and writes each pair's outputs at its query's own row."""
    order = length_order(qlens)
    pad = -len(order) % wp
    return torch.cat([order, order.new_full((pad,), -1)])


def spec_floats(Lc: int) -> int:
    """Scratch floats of one pair's stored Forward specials: a record of
    SPEC per row 0..Lc + 1 (csrc/flank.cu, "stored specials")."""
    return SPEC * (Lc + 2)


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


def flank_rows(bt: BankTensors, codes: torch.Tensor, qlens: torch.Tensor,
               first_version: bool = False):
    """(fwd [Q, H], ppB, ppE, mocc [Q, H, Lc + 1]) f32 on the bank's
    device: the CUDA kernel flank_layout picks for CUDA tensors (its
    launches' CUDA-event ms added to _build.KERNEL_MS["flank"]), the plain
    version for CPU tensors. first_version=True runs the first version
    instead (for timing on the same calls; no path takes it)."""
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
    layout, G, npl, Mpad = flank_layout(bt.Mp)
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    ptrs = [x.data_ptr() for x in [fwd] + outs]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if not first_version:
        # layout 1: one pair a cluster of C CTAs
        C = G // FLANK_WARPS if layout == 1 else 1
        em_t, tr_t, d1_t = flank_tables(bt, G, npl, C)
        wp = 1 if layout == 1 else max(1, FLANK_WARPS // G)
        slots = cta_queries(qlens, wp)
        n_groups = len(slots) // wp
        per = max(1, SCRATCH_BYTES // (4 * wp * H * spec_floats(Lc)))
        fspec = torch.empty(min(per, n_groups) * wp * H * spec_floats(Lc),
                            dtype=torch.float32, device=dev)
        entry = lib.witch_flank_cluster if layout == 1 else \
            lib.witch_flank_warp
        ev[0].record()
        for g0 in range(0, n_groups, per):
            rc = entry(
                em_t.data_ptr(), tr_t.data_ptr(), d1_t.data_ptr(),
                codes.data_ptr(), qlens.data_ptr(), slots[g0 * wp:].data_ptr(),
                *ptrs, fspec.data_ptr(), H, min(per, n_groups - g0), bt.K,
                Lc, W, C if layout == 1 else G, npl, Mpad, stream)
            _build.check(rc, "flank", device=dev)
    else:
        chunk = max(1, min(Q, SCRATCH_BYTES // (H * W * SPEC * 4)))
        fspec = torch.empty(chunk * H * W * SPEC, dtype=torch.float32,
                            device=dev)
        ev[0].record()
        for q0 in range(0, Q, chunk):
            rc = lib.witch_flank(
                bt.em.data_ptr(), bt.trans.data_ptr(), codes[q0:].data_ptr(),
                qlens[q0:].data_ptr(), fwd[q0:].data_ptr(),
                outs[0][q0:].data_ptr(), outs[1][q0:].data_ptr(),
                outs[2][q0:].data_ptr(), fspec.data_ptr(), H,
                min(chunk, Q - q0), bt.Mp, bt.K, Lc, W, stream)
            _build.check(rc, "flank", device=dev)
    ev[1].record()
    ev[1].synchronize()
    _build.KERNEL_MS["flank"] += ev[0].elapsed_time(ev[1])
    return (fwd,) + tuple(outs)
