"""Fused unihit posterior + optimal-accuracy alignment: kernels
(csrc/oa.cu), their plain PyTorch version, and the pair wrapper.

Counterpart of witch_tpu/ops/pallas_oa.py (pallas_oa,
oa_columns_device, bank_strictly_positive). Per (model, query) pair:
Backward and Forward in the odds domain with exact power-of-two
rescaling, f32 posteriors, the OA DP of witch_tpu/hmm/align_ref.py:
oa_fill in f64, and the first-max-wins traceback of its oa_trace. The
decision margin keeps the TPU kernel's definition (see csrc/oa.cu).

oa_layout picks the kernel by the bank width alone: up to Mp 4,096 the
warp-per-pair kernel (G warps of npl states per lane, its tables laid out
by oa_tables; pairs grouped by model into CTAs, longest first, launches
cut by their own scratch, plan.py:plan_launches); above it the same
design over a thread-block cluster (a pair's G = 8 C warps on C CTAs,
each holding its own slice of the transitions, the row's meetings
through distributed shared memory; one pair a cluster, planned the same
way). The first version (one CTA per pair, scratch of the longest query
for every pair) is reached only with first_version=True, for timing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..device import BankTensors
from ._plain import (SCALE_FLOOR, bck_chain, bck_chain_coeffs, fwd_chain,
                     fwd_chain_coeffs, n_passes, po2_scale, shift_l,
                     shift_r)
from .plan import plan_launches, scratch_cap

NEG = float(-np.finfo(np.float32).max)
LN2 = float(np.float32(np.log(2.0)))
# the first version: scratch of all pairs of a launch, and its working
# rows per state when they live in device memory
SCRATCH_BYTES = 2 << 30
ROW_BYTES = 3 * (8 + 4)      # oM oI oD (f64) + fM fI fD (f32) per state
OA_NPL = (8, 16)             # warp-per-pair kernel: states per lane
OA_WARPS = 8                 # warps per CTA (csrc/oa.cu OA_THREADS / 32)
OA_CLUSTER = 8               # most CTAs a cluster (the portable limit)


def oa_layout(Mp: int):
    """(layout, G warps per pair, npl states per lane, Mpad) for a bank of
    width Mp. Layout 0, the warp-per-pair kernel: the fewest states per
    lane (8, else 16) that G <= 8 warps cover, so Mp up to 32 * 8 * 16 =
    4,096. Layout 1 (wider models), the cluster instance: C = G / 8 CTAs
    of 8 warps a pair, the fewest states per lane (8, else 16) that C <= 8
    CTAs cover, then the fewest CTAs: 8 states a lane up to Mp 16,384
    (the 16-state instance spills), 16 above (Mp 16,416 takes C 5, Mpad
    20,480), up to 32,768."""
    for npl in OA_NPL:
        G = -(-Mp // (32 * npl))
        if G <= OA_WARPS:
            return 0, G, npl, 32 * G * npl
    for npl in OA_NPL:
        C = -(-Mp // (32 * OA_WARPS * npl))
        if C <= OA_CLUSTER:
            G = OA_WARPS * C
            return 1, G, npl, 32 * G * npl
    raise ValueError("oa kernel: Mp %d exceeds the widest cluster layout"
                     % Mp)


def oa_table_index(G: int, npl: int, C: int = 1) -> np.ndarray:
    """[Mpad] int64: the state k at each entry of one transition row of
    the kernel's tables. Each of the C CTAs holding a pair (1 outside a
    cluster) copies its own slice of SB = 32 G / C lanes, entry
    ((c * 8 + r) * npl/4 + h) * SB + s) * 4 + q of a model's table (r the
    transition row) holding state (c * SB + s) * npl + 4 h + q: a lane's
    npl states as npl / 4 float4s, consecutive lanes on consecutive
    float4s."""
    SB = 32 * G // C
    c, h, s, q = np.meshgrid(np.arange(C), np.arange(npl // 4),
                             np.arange(SB), np.arange(4), indexing="ij")
    return ((c * SB + s) * npl + 4 * h + q).reshape(-1)


def oa_tables(bt: BankTensors, G: int, npl: int, C: int = 1):
    """The OA kernels' tables, cached on the bank: emissions [H, K, Mpad]
    in k order, zero beyond Mp; transitions [H, C, 8, Mpad / C] as the
    float4s each CTA copies into shared memory (oa_table_index; zero
    beyond Mp). C = 1: the warp-per-pair kernel, [H, 8, Mpad]."""
    key = ("oa_tables", G, npl, C)
    hit = bt.cache.get(key)
    if hit is None:
        Mpad = 32 * G * npl
        em = torch.zeros((bt.H, bt.K, Mpad), dtype=torch.float32,
                         device=bt.device)
        em[:, :, :bt.Mp] = bt.em
        k = oa_table_index(G, npl, C)
        src = torch.as_tensor(np.where(k < bt.Mp, k, 0), device=bt.device)
        live = torch.as_tensor(k < bt.Mp, device=bt.device)
        tr = bt.trans.index_select(2, src) * live
        if C > 1:
            tr = tr.reshape(bt.H, 8, C, Mpad // C).transpose(1, 2)
        hit = (em, tr.contiguous())
        bt.cache[key] = hit
    return hit


def oa_row_bytes(Mpad: int) -> int:
    """Scratch bytes of one query row of a pair in the warp-per-pair
    kernel: the Backward bM and bI (f32, Mpad each), the pointer bytes
    (Mpad), the bN, bC and exponent specials (3 f32), the E argmax (int32)
    and the E/C flags (1 byte)."""
    return 9 * Mpad + 12 + 5


def ptr_at(row: int, k: int, Mpad: int) -> int:
    """Index of (row, state k) in a pair's pointer plane: a lane's npl
    consecutive states go out as one word, so the plane is row-major in
    k (csrc/oa.cu:ptr_at)."""
    return row * Mpad + k


def bank_strictly_positive(bank) -> bool:
    """True when every in-range core transition of a ProfileBank is > 0
    (prior-smoothed models always are): the precondition under which
    the OA DP's FLT_MIN deltas reduce to lane masks."""
    for h in range(bank.H):
        M = int(bank.M[h])
        if not ((bank.t_mm[h, 1:M] > 0).all()
                and (bank.t_im[h, 1:M] > 0).all()
                and (bank.t_dm[h, 1:M] > 0).all()
                and (bank.t_mi[h, 1:M] > 0).all()
                and (bank.t_ii[h, 1:M] > 0).all()
                and (bank.t_md[h, 1:M] > 0).all()
                and (bank.t_dd[h, 1:M] > 0).all()
                and (bank.bm[h, 1:M + 1] > 0).all()):
            return False
    return True


def _shift1_neg(v):
    out = torch.full_like(v, NEG)
    out[..., 1:] = v[..., :-1]
    return out


def _cummax_neg(v):
    for d in range(n_passes(v.shape[-1])):
        s = 1 << d
        if s >= v.shape[-1]:
            break
        r = torch.full_like(v, NEG)
        r[..., s:] = v[..., :-s]
        v = torch.maximum(v, r)
    return v


def oa_ref(bt: BankTensors, rows, ms, flat, off, lens, pmove,
           chunk: int = 128, Mpad: Optional[int] = None):
    """Plain version. Returns (cols [len(flat)] int32 laid out like
    `flat`, stat [n, 4] f32 = margin, ok, Zlog, steps). The traceback
    reads each pair's pointers from a plane of rows of Mpad states
    (default Mp; the warp-per-pair kernel's is oa_layout's Mpad)."""
    n = rows.shape[0]
    cols = np.full(flat.shape[0], -1, np.int32)
    stat = np.zeros((n, 4), np.float32)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        _oa_chunk(bt, rows[sl].long(), ms[sl], flat, off[sl], lens[sl],
                  pmove[sl], cols, stat[sl], Mpad or bt.Mp)
    return torch.from_numpy(cols), torch.from_numpy(stat)


def _oa_chunk(bt, rows, ms, flat, off, lens, pmove, cols_out, stat_out,
              Mpad):
    n = rows.shape[0]
    dev = bt.device
    L = int(lens.max().item())
    Mp = bt.Mp
    ar = torch.arange(L, device=dev)[None, :]
    idx = (off[:, None] + ar).clamp(max=max(0, flat.shape[0] - 1))
    codes = torch.where(ar < lens[:, None], flat[idx].long(),
                        torch.full_like(idx, bt.pad_code))
    em = bt.em[rows]
    tr = bt.trans[rows]
    tmm, tmi, tmd, tim, tii, tdm, tdd, bm = (tr[:, r] for r in range(8))
    Af, Ab = fwd_chain_coeffs(tdd), bck_chain_coeffs(tdd)
    pm = pmove[:, None]
    pl = 1.0 - pm
    lds = lens[:, None]
    pidx = torch.arange(n, device=dev)
    lane = torch.arange(Mp, device=dev)[None, :]
    Mm = ms[:, None].to(dev)
    kmask = (lane >= 1) & (lane <= Mm)
    imask = (lane >= 1) & (lane <= Mm - 1)
    dmask = (lane >= 2) & (lane <= Mm)

    def emis(x):
        return em[pidx, x]

    # ---- pass A: Backward, rows L..0 kept ----
    bMT = pm + shift_l(bck_chain(pm.expand_as(tdd), Ab)) * tmd
    bM, bI = bMT, torch.zeros_like(bMT)
    bN = torch.zeros_like(pm)
    bC = pm.clone()
    bled = torch.zeros_like(pm)
    BR = [None] * (L + 1)
    BR[L] = (bM, bI, bN, bC, bled)
    for i in range(L - 1, -1, -1):
        at_term = i >= lds
        ex = emis(codes[:, i])
        mne = bM * ex
        Bv = (bm * mne).sum(-1, keepdim=True)
        bNn = bN * pl + Bv * pm
        bCn = bC * pl
        bEn = bCn
        Dk = bck_chain(shift_l(mne) * tdm + bEn, Ab)
        Mi = bEn + shift_l(mne) * tmm + bI * tmi + shift_l(Dk) * tmd
        Ii = shift_l(mne) * tim + bI * tii
        scale = torch.maximum(Mi.amax(-1, keepdim=True), torch.maximum(
            bNn, bCn.clamp(min=SCALE_FLOOR)))
        inv, kexp = po2_scale(scale)
        bM = torch.where(at_term, bMT, Mi * inv)
        bI = torch.where(at_term, 0.0, Ii * inv)
        bN = torch.where(at_term, 0.0, bNn * inv)
        bC = torch.where(at_term, pm, bCn * inv)
        bled = torch.where(at_term, 0.0, bled + kexp)
        BR[i] = (bM, bI, bN, bC, bled)
    Zlog = torch.log(bN.clamp(min=SCALE_FLOOR)) + bled * LN2

    # ---- pass B: Forward + OA fill (f64) ----
    z = torch.zeros_like(tmm)
    fM, fI, fD = z, z, z
    fN = torch.ones_like(pm)
    fB = pm.clone()
    fC = torch.zeros_like(pm)
    fled = torch.zeros_like(pm)
    f64 = torch.float64
    oM = torch.full((n, Mp), NEG, dtype=f64, device=dev)
    oI, oD = oM.clone(), oM.clone()
    oN = torch.zeros((n, 1), dtype=f64, device=dev)
    oC = torch.full((n, 1), NEG, dtype=f64, device=dev)
    mm = torch.full((n, 1), math.inf, dtype=f64, device=dev)
    ptr = torch.zeros((L, n, Mp), dtype=torch.uint8, device=dev)
    rowk = torch.zeros((L, n), dtype=torch.int64, device=dev)
    rowf = torch.zeros((L, n), dtype=torch.int64, device=dev)
    inf = torch.tensor(math.inf, dtype=f64, device=dev)
    for i in range(1, L + 1):
        live = i <= lds
        e = emis(codes[:, i - 1])
        src = shift_r(fM * tmm + fI * tim + fD * tdm) + fB * bm
        Mr = src * e
        Ir = fM * tmi + fI * tii
        Dr = fwd_chain(shift_r(Mr * tmd), Af)
        E = Mr.sum(-1, keepdim=True) + Dr.sum(-1, keepdim=True)
        Cn = fC * pl + E
        Nn = fN * pl
        Bn = Nn * pm
        scale = torch.maximum(Mr.amax(-1, keepdim=True), torch.maximum(
            Cn, Nn.clamp(min=SCALE_FLOOR)))
        inv, kexp = po2_scale(scale)
        fN0, fC0, fled0 = fN, fC, fled
        fM = torch.where(live, Mr * inv, fM)
        fI = torch.where(live, Ir * inv, fI)
        fD = torch.where(live, Dr * inv, fD)
        fN = torch.where(live, Nn * inv, fN)
        fB = torch.where(live, Bn * inv, fB)
        fC = torch.where(live, Cn * inv, fC)
        fled = torch.where(live, fled0 + kexp, fled)

        bMi, bIi, bNi, bCi, bledi = BR[i]
        sc = torch.exp((fled + bledi) * LN2 - Zlog)
        ppM = torch.where(kmask, fM * bMi * sc, 0.0).to(f64)
        ppI = torch.where(imask, fI * bIi * sc, 0.0).to(f64)
        scN = torch.exp((fled0 + bledi) * LN2 - Zlog)
        ppN = (fN0 * pl * bNi * scN).to(f64)
        ppC = (fC0 * pl * bCi * scN).to(f64)

        c_mm, c_im, c_dm = _shift1_neg(oM), _shift1_neg(oI), _shift1_neg(oD)
        c_b = oN.expand_as(oM)
        ch = torch.maximum(torch.maximum(torch.maximum(c_mm, c_im), c_dm),
                           c_b)
        Mx = torch.where(kmask, ch + ppM, NEG)
        pmv = torch.where(c_mm == ch, 0, torch.where(
            c_im == ch, 1, torch.where(c_dm == ch, 2, 3)))
        Ix = torch.where(imask, torch.maximum(oM, oI) + ppI, NEG)
        piv = torch.where(oM >= oI, 0, 1)
        sM1 = _shift1_neg(Mx)
        Dx = torch.where(dmask, _cummax_neg(sM1), NEG)
        pdv = torch.where(sM1 >= _shift1_neg(Dx), 0, 1)
        cE = torch.where(kmask, torch.maximum(Mx, Dx), NEG)
        r = cE.amax(-1, keepdim=True)
        kE = torch.argmax(cE, dim=-1, keepdim=True)    # first maximum
        nbest = (cE == r).sum(-1, keepdim=True)
        s2 = torch.where(cE < r, cE, NEG).amax(-1, keepdim=True)
        m_E = torch.where((nbest > 1) | (s2 == NEG), inf, r - s2)
        MxkE = Mx.gather(1, kE)
        eIsD = r > MxkE
        m_ED = torch.where(MxkE == r, inf, r - MxkE)
        cl = oC + ppC
        cge = cl >= r
        m_C = torch.where(cl == r, inf, (cl - r).abs())
        newmm = torch.minimum(torch.minimum(mm, m_E),
                              torch.minimum(m_C, m_ED))
        oM = torch.where(live, Mx, oM)
        oI = torch.where(live, Ix, oI)
        oD = torch.where(live, Dx, oD)
        oN = torch.where(live, oN + ppN, oN)
        oC = torch.where(live, torch.where(cge, cl, r), oC)
        mm = torch.where(live, newmm, mm)
        ptr[i - 1] = (pmv + 4 * piv + 8 * pdv).to(torch.uint8)
        rowk[i - 1] = kE[:, 0]
        rowf[i - 1] = eIsD[:, 0].long() + 2 * cge[:, 0].long()

    # ---- pass C: traceback per pair ----
    ptr = ptr.cpu().numpy()
    rowk = rowk.cpu().numpy()
    rowf = rowf.cpu().numpy()
    lens_h = lens.cpu().numpy()
    off_h = off.cpu().numpy()
    stat_out[:, 0] = mm[:, 0].float().cpu().numpy()
    stat_out[:, 2] = Zlog[:, 0].cpu().numpy()
    plane = np.zeros((L, Mpad), np.uint8)
    for s in range(n):
        plane[:, :Mp] = ptr[:, s]
        ok, steps, col = _trace(plane.reshape(-1), Mpad, rowk[:, s],
                                rowf[:, s], int(lens_h[s]), Mp, L)
        stat_out[s, 1] = 1.0 if ok else 0.0
        stat_out[s, 3] = steps
        cols_out[off_h[s]:off_h[s] + lens_h[s]] = col


def _trace(ptr, Mpad, rowk, rowf, L, Mp, Ldmax):
    """First-max-wins traceback over one pair's pointer plane (flat,
    indexed by ptr_at with rows of Mpad states). States: 0=C 1=E 2=M
    3=I 4=D 5=N."""
    col = np.full(L, -1, np.int32)
    i, k, st, steps = L, 0, 0, 0
    dead = L <= 0
    max_steps = 2 * Ldmax + Mp + 16
    while not (st == 5 and i == 0) and steps < max_steps and not dead:
        row = max(i, 1) - 1
        fl = int(rowf[row])
        pb = int(ptr[ptr_at(row, k, Mpad)])
        ni, nk, nst = i, k, st
        if st == 0:
            if i > 0 and fl & 2:
                ni = i - 1
            else:
                nst = 1
        elif st == 1:
            nst = 4 if fl & 1 else 2
            nk = int(rowk[row])
        elif st == 2:
            pmv = pb & 3
            if i > 0:
                col[row] = k - 1
            nst = (2, 3, 4, 5)[pmv]
            nk = 0 if pmv == 3 else k - 1
            ni = i - 1
        elif st == 3:
            nst = 2 if (pb >> 2) & 1 == 0 else 3
            ni = i - 1
        elif st == 4:
            nst = 2 if (pb >> 3) & 1 == 0 else 4
            nk = k - 1
        else:
            ni = i - 1
        dead = ni < 0 or nk < 0 or nk >= Mp
        i, k, st = ni, nk, nst
        steps += 1
    return (st == 5 and i == 0 and not dead), steps, col


def oa_nats(bt: BankTensors, rows, ms, flat, off, lens, pmove,
            Ldmax: int = 0, budget: Optional[int] = None,
            first_version: bool = False):
    """(cols [len(flat)] int32, stat [n, 4] f32) in input order: a CUDA
    kernel for CUDA tensors (oa_layout: by width alone), the plain
    version for CPU tensors. `budget` caps the scratch bytes of a launch
    (default: every pair's rows, at most half the memory the card can
    still hand out). first_version=True runs the first version instead
    (for timing on the same calls; no path takes it), whose per-pair
    scratch Ldmax (>= every length) sizes."""
    dev = bt.device
    for t in (rows, ms, flat, off, lens, pmove):
        if t.device != dev:
            raise ValueError("bank and pair tensors must share a device")
    if dev.type == "cpu":
        return oa_ref(bt, rows, ms, flat, off, lens, pmove)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    n = rows.shape[0]
    cols = torch.full((flat.shape[0],), -1, dtype=torch.int32, device=dev)
    stat = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    if n == 0:
        return cols, stat
    rows = rows.to(torch.int32).contiguous()
    ms = ms.to(torch.int32).contiguous()
    flat = flat.to(torch.int32).contiguous()
    off = off.to(torch.int64).contiguous()
    lens = lens.to(torch.int32).contiguous()
    pmove = pmove.to(torch.float32).contiguous()
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    layout, G, npl, Mpad = oa_layout(bt.Mp)
    if not first_version:
        lens_h = lens.cpu().numpy().astype(np.int64)
        # layout 1: one pair a cluster of C CTAs
        C = G // OA_WARPS if layout == 1 else 1
        wp = 1 if layout == 1 else max(1, OA_WARPS // G)
        row_bytes = oa_row_bytes(Mpad)
        if budget is None:
            budget = min(int(lens_h.sum()) * row_bytes, scratch_cap(dev))
        plan = plan_launches(lens_h, rows.cpu().numpy(), wp, row_bytes,
                             budget)
        em_t, tr_t = oa_tables(bt, G, npl, C)
        cta_pair = torch.from_numpy(plan.cta_env).to(dev)
        roff = torch.from_numpy(plan.roff).to(dev)
        most = max(1, max(plan.n_rows))
        brows = torch.empty(most * 2 * Mpad, dtype=torch.float32, device=dev)
        bspec = torch.empty(most * 3, dtype=torch.float32, device=dev)
        ptr = torch.empty(most * Mpad, dtype=torch.uint8, device=dev)
        rowk = torch.empty(most, dtype=torch.int32, device=dev)
        rowf = torch.empty(most, dtype=torch.uint8, device=dev)
        ev[0].record()
        entry = lib.witch_oa_cluster if layout == 1 else lib.witch_oa_warp
        for a, b in zip(plan.cta0[:-1], plan.cta0[1:]):
            rc = entry(
                em_t.data_ptr(), tr_t.data_ptr(), rows.data_ptr(),
                ms.data_ptr(), flat.data_ptr(), off.data_ptr(),
                lens.data_ptr(), pmove.data_ptr(),
                cta_pair[a * wp:].data_ptr(), roff.data_ptr(),
                brows.data_ptr(), bspec.data_ptr(), ptr.data_ptr(),
                rowk.data_ptr(), rowf.data_ptr(), cols.data_ptr(),
                stat.data_ptr(), b - a, bt.K, C if layout == 1 else G, npl,
                bt.Mp, Mpad, stream)
            _build.check(rc, "oa", device=dev)
        ev[1].record()
    else:
        Ldmax = max(int(Ldmax), int(lens.max().item()))
        Mp = bt.Mp
        # the six working rows: shared memory, or a device slice per CTA
        in_dev = ROW_BYTES * Mp > _build.SMEM_ROWS_MAX
        per = ((Ldmax + 1) * (2 * Mp + 3) * 4 + Ldmax * (Mp + 5)
               + (ROW_BYTES * Mp if in_dev else 0))
        chunk = max(1, min(n, SCRATCH_BYTES // per))
        brows = torch.empty(chunk * (Ldmax + 1) * 2 * Mp,
                            dtype=torch.float32, device=dev)
        bspec = torch.empty(chunk * (Ldmax + 1) * 3, dtype=torch.float32,
                            device=dev)
        ptr = torch.empty(chunk * Ldmax * Mp, dtype=torch.uint8, device=dev)
        rowk = torch.empty(chunk * Ldmax, dtype=torch.int32, device=dev)
        rowf = torch.empty(chunk * Ldmax, dtype=torch.uint8, device=dev)
        work = (torch.empty(chunk * ROW_BYTES * Mp, dtype=torch.uint8,
                            device=dev) if in_dev else None)
        ev[0].record()
        for c0 in range(0, n, chunk):
            m = min(chunk, n - c0)
            rc = lib.witch_oa(
                bt.em.data_ptr(), bt.trans.data_ptr(), rows[c0:].data_ptr(),
                ms[c0:].data_ptr(), flat.data_ptr(), off[c0:].data_ptr(),
                lens[c0:].data_ptr(), pmove[c0:].data_ptr(),
                brows.data_ptr(), bspec.data_ptr(), ptr.data_ptr(),
                rowk.data_ptr(), rowf.data_ptr(), cols.data_ptr(),
                stat[c0:].data_ptr(), work.data_ptr() if in_dev else None,
                m, Mp, bt.K, Ldmax, stream)
            _build.check(rc, "oa", device=dev)
        ev[1].record()
    ev[1].synchronize()
    _build.KERNEL_MS["oa"] += ev[0].elapsed_time(ev[1])
    return cols, stat


def pack_pairs(bt: BankTensors, rows_codes: Sequence[Tuple[int, np.ndarray]]):
    """(bank_row, codes) pairs -> the tensors oa_nats takes, on the
    bank's device. pmove = 2/(L+2) (unihit length model)."""
    n = len(rows_codes)
    lens = np.array([len(c) for _, c in rows_codes], np.int32)
    off = np.zeros(n, np.int64)
    if n:
        off[1:] = np.cumsum(lens[:-1], dtype=np.int64)
    flat = (np.concatenate([np.asarray(c, np.int32) for _, c in rows_codes])
            if n else np.zeros(0, np.int32))
    rows = np.array([r for r, _ in rows_codes], np.int32)
    ms = bt.M[rows] if n else np.zeros(0, np.int32)
    pmove = (2.0 / (lens.astype(np.float64) + 2.0)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
        bt.device)
    return t(rows), t(ms.astype(np.int32)), t(flat), t(off), t(lens), \
        t(pmove)


def oa_columns(banks_t, bank_row: Dict[int, Tuple[int, int]],
               pairs: Sequence[Tuple[int, np.ndarray]], Ldmax: int = 0):
    """Device posterior+OA for (hmm_idx, codes) pairs. Returns (cols
    list of int64 [len(codes)], margins [n], ok [n] bool) in input
    order: the contract of witch_tpu/ops/pallas_oa.py:oa_columns_device.
    The caller re-aligns pairs with ok=False or margin < guard."""
    n = len(pairs)
    cols_out: list = [None] * n
    margins = np.zeros(n)
    oks = np.zeros(n, bool)
    by_bank: Dict[int, list] = {}
    for p, (idx, _) in enumerate(pairs):
        bi, row = bank_row[int(idx)]
        by_bank.setdefault(bi, []).append((row, p))
    for bi, plist in sorted(by_bank.items()):
        bt = banks_t[bi]
        packed = pack_pairs(bt, [(row, pairs[p][1]) for row, p in plist])
        cols, stat = oa_nats(bt, *packed, Ldmax=Ldmax)
        cols = cols.cpu().numpy()
        stat = stat.cpu().numpy()
        off = packed[3].cpu().numpy()
        for t, (row, p) in enumerate(plist):
            Lp = len(pairs[p][1])
            cols_out[p] = cols[off[t]:off[t] + Lp].astype(np.int64)
            margins[p] = stat[t, 0]
            oks[p] = stat[t, 1] > 0.5
    return cols_out, margins, oks
