"""Batched pair-HMM forward log-odds for the anchor embedding of the
consistency backbone aligner: the kernels (csrc/pairhmm.cu, picked by
B's width), their plain PyTorch version, and a float64 numpy reference.

Counterpart of witch_tpu/ops/pairhmm_forward.py (pairhmm_forward_logodds,
XLA, and pairhmm_forward_logodds_np). Per (A, B) pair, the forward pass
of the 3-state pair HMM (M, X = gap in B, Y = gap in A) of
native/pairhmm_kernel.cpp with its interior flank parameters, in the
emission-odds domain, each row rescaled by its max. Rows i run over A,
columns j = 0..len(B) over B:

    M[i, j] = em[A[i-1], B[j-1]] (t_mm M[i-1, j-1] + t_gm X[i-1, j-1]
                                  + t_gm Y[i-1, j-1])      (j >= 1)
    X[i, j] = t_mg M[i-1, j] + t_gg X[i-1, j]
    Y[i, j] = t_mg M[i, j-1] + t_gg Y[i, j-1]              (Y[i, 0] = 0)

with t_mm = 1 - 2 delta, t_mg = delta, t_gm = 1 - eps, t_gg = eps. The
result is log(M + X + Y at [len A, len B]) plus the rows' log scales,
in nats. The JAX version's TPU padding of P and L to multiples of 128
is not carried: the kernel runs each pair at its own lengths.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

PH_WARPS = 4                 # pairs (warps) per CTA of the first version
PH_CH = tuple(range(8, 49, 4))   # columns a lane, the register instances
PH_REG_C_MAX = 63            # the register kernels' codes are bytes 4 c
PHW_CH = tuple(range(8, 33, 4))  # columns a lane, the wide instances
PHW_COLS = 8192              # columns j = 0..LB the wide instances reach
PH_WIDE_LB_MAX = PHW_COLS - 1    # the widest B of the wide layout
# the wide instance the layout takes at every width: of the seven, the
# one whose time came nearest the best candidate's over B 1,536-8,064
# in steps of 128 (tools/pairhmm_bench.py --layouts --widths
# 1536:8192:128, 2,400 pairs of 256 rows; H100 80GB HBM3, 700 W): 1.02x
# the best on average, 1.23x at worst (PERF.md)
PHW_PICK_CH = 24
TINY = 1e-30                 # floor of the final total (the JAX version's)


def transitions(delta: float, eps: float):
    """(t_mm, t_mg, t_gm, t_gg) as float32, as the JAX version casts them."""
    return tuple(float(np.float32(x)) for x in
                 (1.0 - 2.0 * delta, delta, 1.0 - eps, eps))


def phw_gmax(ch: int) -> int:
    """The most warps a CTA of the wide CH instance takes (csrc/
    pairhmm.cu:PhwMax): enough for PHW_COLS columns."""
    return -(-PHW_COLS // (32 * ch))


def wide_candidates(LB: int):
    """[(CH, G)] of every wide instance that holds LB + 1 columns: G =
    ceil((LB + 1) / 32 CH) warps, at most phw_gmax(CH); none above
    PH_WIDE_LB_MAX."""
    out = []
    if LB > PH_WIDE_LB_MAX:
        return out
    for ch in PHW_CH:
        g = -(-(LB + 1) // (32 * ch))
        if g <= phw_gmax(ch):
            out.append((ch, g))
    return out


def pairhmm_layout(C: int, LB: int):
    """(layout, CH, G) for a launch whose B rows are LB wide.

    Layout 0, the register kernel (csrc/pairhmm.cu:pairhmm_reg_kernel):
    one warp a pair (G 1), the smallest CH of PH_CH with 32 CH >= LB + 1
    columns; rows and codes in registers as byte offsets 4 c into em
    [C, C + 1] in shared memory (code C, a zero column, marks B's empty
    columns), so C <= 63. Layout 2, the wide layout (pairhmm_wide_kernel):
    one CTA of G warps a pair, CH = PHW_PICK_CH columns a lane and G =
    ceil((LB + 1) / 32 CH), for B from 32 x 48 = 1,536 up to
    PH_WIDE_LB_MAX residues at C <= 63. Layout 1, the first version
    (pairhmm_kernel; CH 0, G 0), above that or at C > 63; where its rows
    and codes go: first_version_smem."""
    if C <= PH_REG_C_MAX:
        ch = next((c for c in PH_CH if 32 * c >= LB + 1), 0)
        if ch:
            return 0, ch, 1
        g = dict(wide_candidates(LB)).get(PHW_PICK_CH)
        if g:
            return 2, PHW_PICK_CH, g
    return 1, 0, 0


def wide_ctas_per_sm(ch: int, g: int, C: int) -> int:
    """CTAs of the wide (CH, G) instance one SM of the card keeps
    resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = ctypes.c_int(0)
    _build.check(_build.lib().witch_pairhmm_wide_ctas_per_sm(
        ch, g, C, ctypes.byref(n)), "pairhmm", count=False)
    return n.value


def first_version_smem(C: int, LB: int):
    """(rows in shared memory, B's codes in shared memory) of the first
    version at width LB: em [C, C] f32 always, then each of the PH_WARPS
    warps' three f32 rows of LB + 1 and its LB code bytes where they fit
    in _build.SMEM_ROWS_MAX; the rows go to a device buffer first, then
    the codes are read from device memory."""
    em, rows, codes = 4 * C * C, PH_WARPS * 12 * (LB + 1), PH_WARPS * LB
    if em + rows + codes <= _build.SMEM_ROWS_MAX:
        return True, True
    return False, em + codes <= _build.SMEM_ROWS_MAX


def _check(codesA, lensA, codesB, lensB):
    dev = codesA.device
    if any(t.device != dev for t in (lensA, codesB, lensB)):
        raise ValueError("codesA, lensA, codesB and lensB must share a "
                         "device")
    if codesA.dim() != 2 or codesB.dim() != 2 \
            or codesA.shape[0] != codesB.shape[0] \
            or lensA.shape != (codesA.shape[0],) \
            or lensB.shape != (codesA.shape[0],):
        raise ValueError("codesA [P, LA], lensA [P], codesB [P, LB] and "
                         "lensB [P] expected")
    return dev


def _shift1(v: torch.Tensor) -> torch.Tensor:
    """v shifted one column right along the last axis, zero in column 0."""
    return torch.nn.functional.pad(v[:, :-1], (1, 0))


def _gap_scan(b: torch.Tensor, t_gg: float) -> torch.Tensor:
    """y_j = t_gg y_{j-1} + b_j along axis 1 (y_0 = b_0), as a log-step
    scan: after the step of shift s, y_j sums t_gg^t b_{j-t} for t < 2s.
    Coefficients that underflow f32 drop terms below its resolution."""
    y = b
    n = b.shape[1]
    s, coef = 1, t_gg
    while s < n:
        c = float(np.float32(coef))
        if c == 0.0:
            break
        y = y + c * torch.nn.functional.pad(y[:, :-s], (s, 0))
        s, coef = 2 * s, coef * coef
    return y


def pairhmm_forward_logodds_plain(codesA, lensA, codesB, lensB, em,
                                  delta: float, eps: float) -> torch.Tensor:
    """Plain version, on the tensors' device: [P] f32 forward log-odds.

    The XLA version's arithmetic in f32 (one row a step, every pair at
    the batch's padded width, columns past len(B) masked, rows past
    len(A) carried unchanged); the Y recurrence along a row is a log-step
    scan (_gap_scan) instead of the associative scan, and the rows' log
    scales sum in f64 as the kernel's do."""
    dev = _check(codesA, lensA, codesB, lensB)
    cA, cB = codesA.long(), codesB.long()
    lA, lB = lensA.long(), lensB.long()
    em = torch.as_tensor(em, dtype=torch.float32).to(dev)
    P, LA = cA.shape
    LB = cB.shape[1]
    t_mm, t_mg, t_gm, t_gg = transitions(delta, eps)
    f32 = torch.float32
    maskB = (torch.arange(LB + 1, device=dev)[None, :]
             <= lB[:, None]).to(f32)
    fM = torch.zeros((P, LB + 1), dtype=f32, device=dev)
    fM[:, 0] = 1.0
    fX = torch.zeros_like(fM)
    geo = t_mg * torch.full((LB,), t_gg, dtype=f32, device=dev).pow(
        torch.arange(LB, dtype=f32, device=dev))
    fY = torch.nn.functional.pad(geo[None, :].expand(P, LB), (1, 0)) * maskB
    logs = torch.zeros(P, dtype=torch.float64, device=dev)
    zero = torch.zeros((P, 1), dtype=f32, device=dev)
    for i in range(LA):
        active = (i < lA)[:, None]
        e = torch.cat([zero, torch.gather(em[cA[:, i]], 1, cB)], dim=1)
        m = e * (t_mm * _shift1(fM) + t_gm * _shift1(fX)
                 + t_gm * _shift1(fY))
        x = t_mg * fM + t_gg * fX
        m = m * maskB
        x = x * maskB
        y = _gap_scan(t_mg * _shift1(m), t_gg) * maskB
        mx = torch.maximum(torch.maximum(m.amax(1), x.amax(1)), y.amax(1))
        mx = torch.where(mx <= 0, torch.ones_like(mx), mx)[:, None]
        fM = torch.where(active, m / mx, fM)
        fX = torch.where(active, x / mx, fX)
        fY = torch.where(active, y / mx, fY)
        logs = logs + torch.where(active[:, 0], torch.log(mx[:, 0]).double(),
                                  0.0)
    tot = torch.gather(fM + fX + fY, 1, lB[:, None])[:, 0]
    return (torch.log(tot.clamp(min=TINY)).double() + logs).to(f32)


def pairhmm_forward_logodds(codesA, lensA, codesB, lensB, em,
                            delta: float, eps: float,
                            first_version: bool = False) -> torch.Tensor:
    """[P] f32 forward log-odds of each (A, B) pair: codesA [P, LA] and
    codesB [P, LB] padded residue codes, lensA / lensB [P] their lengths,
    em [C, C] emission odds. CUDA tensors launch the kernel that
    pairhmm_layout picks by LB (first_version=True takes the first
    version at any width, to time it against the others), its CUDA-event
    ms added to _build.KERNEL_MS["pairhmm"]; CPU tensors take the plain
    version."""
    dev = _check(codesA, lensA, codesB, lensB)
    if dev.type == "cpu":
        return pairhmm_forward_logodds_plain(codesA, lensA, codesB, lensB,
                                             em, delta, eps)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    em = torch.as_tensor(em, dtype=torch.float32).to(dev).contiguous()
    if em.dim() != 2 or em.shape[0] != em.shape[1] or em.shape[0] > 256:
        raise ValueError("em [C, C] with C <= 256 expected (B's codes "
                         "are staged as bytes)")
    cA = codesA.to(torch.int32).contiguous()
    cB = codesB.to(torch.uint8).contiguous()
    lA = lensA.to(torch.int32).contiguous()
    lB = lensB.to(torch.int32).contiguous()
    P, LA = cA.shape
    LB = cB.shape[1]
    C = em.shape[0]
    out = torch.empty(P, dtype=torch.float32, device=dev)
    if P == 0:
        return out
    lay, ch, g = (1, 0, 0) if first_version else pairhmm_layout(C, LB)
    t = [ctypes.c_float(v) for v in transitions(delta, eps)]
    lib = _build.lib()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if lay == 1:
        rows_smem, codes_smem = first_version_smem(C, LB)
        rows = None if rows_smem else torch.empty(
            P * 3 * (LB + 1), dtype=torch.float32, device=dev)
    ev[0].record()
    if lay == 0:
        rc = lib.witch_pairhmm_reg(
            cA.data_ptr(), lA.data_ptr(), cB.data_ptr(), lB.data_ptr(),
            em.data_ptr(), out.data_ptr(), ch, P, LA, LB, C, *t,
            _build.stream_ptr(dev))
    elif lay == 2:
        rc = lib.witch_pairhmm_wide(
            cA.data_ptr(), lA.data_ptr(), cB.data_ptr(), lB.data_ptr(),
            em.data_ptr(), out.data_ptr(), ch, g, P, LA, LB, C, *t,
            _build.stream_ptr(dev))
    else:
        rc = lib.witch_pairhmm(
            cA.data_ptr(), lA.data_ptr(), cB.data_ptr(), lB.data_ptr(),
            em.data_ptr(), out.data_ptr(),
            rows.data_ptr() if rows is not None else None, int(codes_smem),
            P, LA, LB, C, *t, _build.stream_ptr(dev))
    _build.check(rc, "pairhmm", device=dev)
    ev[1].record()
    ev[1].synchronize()
    _build.KERNEL_MS["pairhmm"] += ev[0].elapsed_time(ev[1])
    return out


def pairhmm_forward_logodds_np(codeA, codeB, em, delta, eps) -> float:
    """float64 numpy reference (a direct port of the native forward);
    the port's copy of witch_tpu/ops/pairhmm_forward.py:
    pairhmm_forward_logodds_np."""
    LA, LB = len(codeA), len(codeB)
    t_mm, t_mg = 1.0 - 2.0 * delta, delta
    t_gm, t_gg = 1.0 - eps, eps
    fM = np.zeros((LA + 1, LB + 1))
    fX = np.zeros((LA + 1, LB + 1))
    fY = np.zeros((LA + 1, LB + 1))
    fM[0, 0] = 1.0
    for j in range(1, LB + 1):
        fY[0, j] = t_mg * fM[0, 0] if j == 1 else t_gg * fY[0, j - 1]
    logs = 0.0
    for i in range(1, LA + 1):
        fX[i, 0] = t_mg * fM[i - 1, 0] if i == 1 else t_gg * fX[i - 1, 0]
        for j in range(1, LB + 1):
            e = em[codeA[i - 1], codeB[j - 1]]
            fM[i, j] = e * (t_mm * fM[i - 1, j - 1] +
                            t_gm * fX[i - 1, j - 1] +
                            t_gm * fY[i - 1, j - 1])
            fX[i, j] = t_mg * fM[i - 1, j] + t_gg * fX[i - 1, j]
            fY[i, j] = t_mg * fM[i, j - 1] + t_gg * fY[i, j - 1]
        mx = max(fM[i].max(), fX[i].max(), fY[i].max(), 1e-300)
        fM[i] /= mx
        fX[i] /= mx
        fY[i] /= mx
        logs += np.log(mx)
    return float(np.log(max(fM[LA, LB] + fX[LA, LB] + fY[LA, LB],
                            1e-300)) + logs)
