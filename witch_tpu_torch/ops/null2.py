"""Per-envelope null2 expectations for the reporting gate: kernel
(csrc/null2.cu), its plain PyTorch version, and the envelope wrapper.

Counterpart of witch_tpu/ops/pallas_null2.py (pallas_null2,
null2_envelopes_device). Per envelope: the isolated unihit Forward over
the envelope subsequence with pmove = 2/(L_full+2) (envsc, nats) and a
Backward accumulating posterior state usage; outputs
(envsc, n2dot[128] = sum_k useM[k] em[k, x], useI, usetot).

The kernel runs one warp, or G warps for wide models, per envelope;
n2_layout picks G, the states per lane and where the row lives from the
bank width, and the tables are laid out as forward's (slot_tables).
plan_launches groups the envelopes by model into CTAs, longest first,
and cuts the launches by scratch bytes; on the CPU the plain version
runs the same plan, and both write each result back at its input index.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..device import BankTensors
from ._plain import (SCALE_FLOOR, bck_chain, bck_chain_coeffs, fwd_chain,
                     fwd_chain_coeffs, shift_l, shift_r)
from .forward import slot_tables
from .plan import Plan, plan_launches, scratch_cap  # noqa: F401

NCODE = 128


def _pack(entries, device):
    n = len(entries)
    lds = np.array([len(s) for _, s, _ in entries], np.int32)
    off = np.zeros(n, np.int64)
    if n:
        off[1:] = np.cumsum(lds[:-1], dtype=np.int64)
    flat = (np.concatenate([np.asarray(s, np.int32) for _, s, _ in entries])
            if n else np.zeros(0, np.int32))
    rows = np.array([r for r, _, _ in entries], np.int32)
    pmove = np.array([2.0 / (float(lf) + 2.0) for _, _, lf in entries],
                     np.float32)
    t = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    return t(rows), t(flat), t(off), t(lds), t(pmove)


def null2_nats_ref(bt: BankTensors, rows, flat, off, lds, pmove,
                   chunk: int = 256):
    """Plain version. Returns (scal [n, 3] = envsc, useI, usetot;
    n2dot [n, 128]) as f32 tensors on the bank's device. The DP runs in
    f32; the scale ledgers (the logs of the row scales' products) are
    summed in f64, as the kernel sums them: in f32 their rounding alone
    reaches ~1e-4 of the posterior usage over ~1,400 rows."""
    n = rows.shape[0]
    dev = bt.device
    scal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n2dot = torch.zeros((n, NCODE), dtype=torch.float32, device=dev)
    for c0 in range(0, n, chunk):
        sl = slice(c0, min(n, c0 + chunk))
        s, d = _null2_chunk(bt, rows[sl].long(), flat, off[sl], lds[sl],
                            pmove[sl])
        scal[sl] = s
        n2dot[sl, :bt.K] = d
    return scal, n2dot


def _null2_chunk(bt, rows, flat, off, lds, pmove):
    n = rows.shape[0]
    dev = bt.device
    Ld = int(lds.max().item())
    idx = (off[:, None] + torch.arange(Ld, device=dev)[None, :]).clamp(
        max=max(0, flat.shape[0] - 1))
    live_cols = torch.arange(Ld, device=dev)[None, :] < lds[:, None]
    codes = torch.where(live_cols, flat[idx].long(),
                        torch.full_like(idx, bt.pad_code))     # [n, Ld]
    em = bt.em[rows]                                           # [n, K, Mp]
    tr = bt.trans[rows]                                        # [n, 8, Mp]
    tmm, tmi, tmd, tim, tii, tdm, tdd, bm = (tr[:, r] for r in range(8))
    Af, Ab = fwd_chain_coeffs(tdd), bck_chain_coeffs(tdd)
    pm = pmove[:, None]
    pl = 1.0 - pm
    ar = torch.arange(n, device=dev)

    def emis(x):
        return em[ar, x]                                       # [n, Mp]

    z = torch.zeros_like(tmm)
    M, I, D = z, z, z
    N = torch.ones_like(pm)
    B = pm.clone()
    C = torch.zeros_like(pm)
    logs = torch.zeros_like(pm, dtype=torch.float64)   # f64 ledgers
    fM, fI, fled = [None], [None], [None]
    for i in range(1, Ld + 1):
        e = emis(codes[:, i - 1])
        src = shift_r(M * tmm + I * tim + D * tdm) + B * bm
        Mr = src * e
        Ir = M * tmi + I * tii
        Dr = fwd_chain(shift_r(Mr * tmd), Af)
        E = Mr.sum(-1, keepdim=True) + Dr.sum(-1, keepdim=True)
        Cn = C * pl + E
        Nn = N * pl
        Bn = Nn * pm
        scale = torch.maximum(Mr.amax(-1, keepdim=True), torch.maximum(
            Cn, Nn.clamp(min=SCALE_FLOOR)))
        inv = 1.0 / scale
        keep = i <= lds[:, None]
        M = torch.where(keep, Mr * inv, M)
        I = torch.where(keep, Ir * inv, I)
        D = torch.where(keep, Dr * inv, D)
        N = torch.where(keep, Nn * inv, N)
        B = torch.where(keep, Bn * inv, B)
        C = torch.where(keep, Cn * inv, C)
        logs = torch.where(keep, logs + torch.log(scale).double(), logs)
        fM.append(M)
        fI.append(I)
        fled.append(logs)
    envsc = (torch.log(C.clamp(min=SCALE_FLOOR)).double()
             + torch.log(pm).double() + logs)

    bMT = pm + shift_l(bck_chain(pm.expand_as(tdd), Ab)) * tmd
    bM, bI = bMT, torch.zeros_like(bMT)
    bN = torch.zeros_like(pm)
    bC = pm.clone()
    bled = torch.zeros_like(pm, dtype=torch.float64)
    useM = torch.zeros_like(bMT)
    useI = torch.zeros_like(pm)
    usetot = torch.zeros_like(pm)
    for i in range(Ld, 0, -1):
        at_term = i >= lds[:, None]
        if i < Ld:
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
            inv = 1.0 / scale
            bM = torch.where(at_term, bMT, Mi * inv)
            bI = torch.where(at_term, 0.0, Ii * inv)
            bN = torch.where(at_term, 0.0, bNn * inv)
            bC = torch.where(at_term, pm, bCn * inv)
            bled = torch.where(at_term, 0.0, bled + torch.log(scale).double())
        sc = torch.exp((fled[i] + bled - envsc).float())
        live = (i <= lds[:, None]).to(torch.float32)
        ppM = fM[i] * bM * (sc * live)
        ppI = fI[i] * bI * (sc * live)
        useM = useM + ppM
        sI = ppI.sum(-1, keepdim=True)
        useI = useI + sI
        usetot = usetot + sI + ppM.sum(-1, keepdim=True)
    n2dot = torch.einsum("nk,nxk->nx", useM, em)
    return torch.cat([envsc.float(), useI, usetot], dim=1), n2dot


N2_NPL = (8, 16, 24, 32)            # register layouts: states per lane
N2_WARPS = 8                         # warps per CTA (csrc/null2.cu)
N2_XS = 8                            # floats per warp of a meeting
N2_WS = 8                            # invariant floats per warp


def _smem_bytes(regs: bool, G: int, Mpad: int) -> int:
    wp = max(1, N2_WARPS // G)
    return 4 * (2 * wp * G * N2_XS + wp * G * N2_WS
                + (8 if regs else 3) * Mpad)


def n2_layout(Mp: int):
    """(layout, G warps per envelope, npl states per lane, Mpad) for a
    bank of width Mp. Layout 0: the row in registers with the fewest
    states per lane that G <= 8 warps cover, the transitions in shared
    memory (narrower lanes were faster at every width measured: PERF.md,
    null2 layouts). Layout 1 (wider models): one envelope of 8 warps
    per CTA, its row in shared memory, the transitions in device memory."""
    for npl in N2_NPL:
        G = -(-Mp // (32 * npl))
        if G <= N2_WARPS and _smem_bytes(True, G, 32 * G * npl) \
                <= _build.SMEM_ROWS_MAX:
            return 0, G, npl, 32 * G * npl
    G = N2_WARPS
    npl = -(-Mp // (32 * G))
    Mpad = 32 * G * npl
    if _smem_bytes(False, G, Mpad) > _build.SMEM_ROWS_MAX:
        raise ValueError("null2 kernel: Mp %d exceeds the widest layout" % Mp)
    return 1, G, npl, Mpad


def scratch_row_bytes(Mpad: int) -> int:
    """Scratch bytes of one stored Forward row: M and I (f32, Mpad
    slots each) and its f64 ledger entry."""
    return 8 * Mpad + 8


def scratch_budget(dev, layout: int, G: int, npl: int, Mpad: int,
                   lds: np.ndarray, row_bytes: int) -> int:
    """Scratch bytes one launch may hold on the card.

    A launch should hold at least as many envelopes as the card keeps
    resident (SMs x CTAs per SM x envelopes per CTA), or all of them if
    there are fewer, so that no launch runs below a full card; beyond that
    the fewer launches the fewer tails, so the budget is every envelope's
    rows, capped at plan.scratch_cap (half the memory PyTorch can still
    hand out, shared out among the run's query shards). Only when that
    cap is smaller than the resident envelopes' rows does a launch hold
    fewer."""
    import ctypes
    total = int(np.asarray(lds, np.int64).sum()) * row_bytes
    cap = scratch_cap(dev)
    per_sm = ctypes.c_int(0)
    _build.check(_build.lib().witch_null2_ctas_per_sm(
        layout, G, npl, Mpad, ctypes.byref(per_sm)), "null2", count=False)
    resident = torch.cuda.get_device_properties(dev).multi_processor_count \
        * per_sm.value * max(1, N2_WARPS // G)
    longest = np.sort(np.asarray(lds, np.int64))[::-1][:resident]
    if int(longest.sum()) * row_bytes > cap:
        warnings.warn("null2: %d resident envelopes need %d scratch bytes, "
                      "above the %d-byte cap" % (
                          len(longest), int(longest.sum()) * row_bytes, cap))
    return min(total, cap)


def null2_nats(bt: BankTensors, rows, flat, off, lds, pmove,
               budget: Optional[int] = None):
    """(scal [n, 3], n2dot [n, 128]) in input order: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Both run the
    envelopes in plan_launches' order and launches (`budget`: scratch
    bytes per launch; by default scratch_budget on the card, all at once
    on the CPU)."""
    dev = bt.device
    for t in (rows, flat, off, lds, pmove):
        if t.device != dev:
            raise ValueError("bank and envelope tensors must share a device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    if bt.K > NCODE:
        raise ValueError("alphabet wider than %d codes" % NCODE)
    n = rows.shape[0]
    scal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n2dot = torch.zeros((n, NCODE), dtype=torch.float32, device=dev)
    if n == 0:
        return scal, n2dot
    lds_h = lds.cpu().numpy().astype(np.int64)
    layout, G, npl, Mpad = n2_layout(bt.Mp)
    wp = max(1, N2_WARPS // G)
    row_bytes = scratch_row_bytes(Mpad)
    if budget is None:
        budget = (scratch_budget(dev, layout, G, npl, Mpad, lds_h, row_bytes)
                  if dev.type == "cuda" else int(lds_h.sum()) * row_bytes)
    plan = plan_launches(lds_h, rows.cpu().numpy(), wp, row_bytes, budget)
    if dev.type == "cpu":
        for a, b in zip(plan.cta0[:-1], plan.cta0[1:]):
            ids = plan.cta_env[a * wp:b * wp]
            ids = torch.from_numpy(ids[ids >= 0].astype(np.int64))
            s, d = null2_nats_ref(bt, rows[ids], flat, off[ids], lds[ids],
                                  pmove[ids])
            scal[ids] = s
            n2dot[ids] = d
        return scal, n2dot
    rows = rows.to(torch.int32).contiguous()
    flat = flat.to(torch.int32).contiguous()
    off = off.to(torch.int64).contiguous()
    lds = lds.to(torch.int32).contiguous()
    pmove = pmove.to(torch.float32).contiguous()
    em_t, tr_t = slot_tables(bt, G, npl)
    cta_env = torch.from_numpy(plan.cta_env).to(dev)
    roff = torch.from_numpy(plan.roff).to(dev)
    most = max(plan.n_rows)
    rows_s = torch.empty(most * 2 * Mpad, dtype=torch.float32, device=dev)
    fled_s = torch.empty(most, dtype=torch.float64, device=dev)
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for a, b in zip(plan.cta0[:-1], plan.cta0[1:]):
        rc = lib.witch_null2(
            em_t.data_ptr(), tr_t.data_ptr(), rows.data_ptr(),
            flat.data_ptr(), off.data_ptr(), lds.data_ptr(),
            pmove.data_ptr(), cta_env[a * wp:].data_ptr(), roff.data_ptr(),
            rows_s.data_ptr(), fled_s.data_ptr(), scal.data_ptr(),
            n2dot.data_ptr(), b - a, bt.K, layout, G, npl, Mpad, stream)
        _build.check(rc, "null2", device=dev)
    ev[1].record()
    ev[1].synchronize()
    _build.KERNEL_MS["null2"] += ev[0].elapsed_time(ev[1])
    return scal, n2dot


def null2_envelopes(bt: BankTensors,
                    entries: Sequence[Tuple[int, np.ndarray, int]]):
    """Null2 for (bank_row, sub_codes, L_full) envelope entries. Returns
    per entry (envsc nats, n2dot [n, 128], useI, usetot) as f64 numpy,
    in input order: the contract of
    witch_tpu/ops/pallas_null2.py:null2_envelopes_device."""
    n = len(entries)
    if n == 0:
        return np.zeros(0), np.zeros((0, NCODE)), np.zeros(0), np.zeros(0)
    scal, n2dot = null2_nats(bt, *_pack(entries, bt.device))
    scal = scal.double().cpu().numpy()
    return (scal[:, 0], n2dot.double().cpu().numpy(), scal[:, 1],
            scal[:, 2])
