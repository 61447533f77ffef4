"""Per-envelope null2 expectations for the reporting gate: kernel
(csrc/null2.cu), its plain PyTorch version, and the envelope wrapper.

Counterpart of witch_tpu/ops/pallas_null2.py (pallas_null2,
null2_envelopes_device). Per envelope: the isolated unihit Forward over
the envelope subsequence with pmove = 2/(L_full+2) (envsc, nats) and a
Backward accumulating posterior state usage; outputs
(envsc, n2dot[128] = sum_k useM[k] em[k, x], useI, usetot).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..device import BankTensors
from ._plain import (SCALE_FLOOR, bck_chain, bck_chain_coeffs, fwd_chain,
                     fwd_chain_coeffs, shift_l, shift_r)

NCODE = 128
SCRATCH_BYTES = 2 << 30     # device scratch for stored Forward rows


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
    n2dot [n, 128]) as f32 tensors on the bank's device."""
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
    logs = torch.zeros_like(pm)
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
        logs = torch.where(keep, logs + torch.log(scale), logs)
        fM.append(M)
        fI.append(I)
        fled.append(logs)
    envsc = torch.log(C.clamp(min=SCALE_FLOOR)) + torch.log(pm) + logs

    bMT = pm + shift_l(bck_chain(pm.expand_as(tdd), Ab)) * tmd
    bM, bI = bMT, torch.zeros_like(bMT)
    bN = torch.zeros_like(pm)
    bC = pm.clone()
    bled = torch.zeros_like(pm)
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
            bled = torch.where(at_term, 0.0, bled + torch.log(scale))
        sc = torch.exp(fled[i] + bled - envsc)
        live = (i <= lds[:, None]).to(torch.float32)
        ppM = fM[i] * bM * (sc * live)
        ppI = fI[i] * bI * (sc * live)
        useM = useM + ppM
        sI = ppI.sum(-1, keepdim=True)
        useI = useI + sI
        usetot = usetot + sI + ppM.sum(-1, keepdim=True)
    n2dot = torch.einsum("nk,nxk->nx", useM, em)
    return torch.cat([envsc, useI, usetot], dim=1), n2dot


def null2_nats(bt: BankTensors, rows, flat, off, lds, pmove):
    """(scal [n, 3], n2dot [n, 128]): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = bt.device
    for t in (rows, flat, off, lds, pmove):
        if t.device != dev:
            raise ValueError("bank and envelope tensors must share a device")
    if dev.type == "cpu":
        return null2_nats_ref(bt, rows, flat, off, lds, pmove)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    if bt.K > NCODE:
        raise ValueError("alphabet wider than %d codes" % NCODE)
    n = rows.shape[0]
    scal = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n2dot = torch.zeros((n, NCODE), dtype=torch.float32, device=dev)
    if n == 0:
        return scal, n2dot
    rows = rows.to(torch.int32).contiguous()
    flat = flat.to(torch.int32).contiguous()
    off = off.to(torch.int64).contiguous()
    lds = lds.to(torch.int32).contiguous()
    pmove = pmove.to(torch.float32).contiguous()
    Ldmax = int(lds.max().item())
    # the four working rows: shared memory, or a device slice per CTA
    in_dev = 4 * bt.Mp * 4 > _build.SMEM_ROWS_MAX
    per = (Ldmax + 1) * (2 * bt.Mp + 1) * 4 + (16 * bt.Mp if in_dev else 0)
    chunk = max(1, min(n, SCRATCH_BYTES // per))
    rows_s = torch.empty(chunk * (Ldmax + 1) * 2 * bt.Mp,
                         dtype=torch.float32, device=dev)
    fled_s = torch.empty(chunk * (Ldmax + 1), dtype=torch.float32,
                         device=dev)
    work = (torch.empty(chunk * 4 * bt.Mp, dtype=torch.float32, device=dev)
            if in_dev else None)
    lib = _build.lib()
    stream = _build.stream_ptr(dev)
    for c0 in range(0, n, chunk):
        m = min(chunk, n - c0)
        rc = lib.witch_null2(
            bt.em.data_ptr(), bt.trans.data_ptr(), rows[c0:].data_ptr(),
            flat.data_ptr(), off[c0:].data_ptr(), lds[c0:].data_ptr(),
            pmove[c0:].data_ptr(), rows_s.data_ptr(), fled_s.data_ptr(),
            scal[c0:].data_ptr(), n2dot[c0:].data_ptr(),
            work.data_ptr() if in_dev else None, m, bt.Mp, bt.K, Ldmax,
            stream)
        _build.check(rc, "null2")
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
