"""The pair-HMM kernel's wide layout (csrc/pairhmm.cu:pairhmm_wide_kernel:
one CTA of G warps a pair, CH columns a lane) modelled on the CPU in its
own split, against the plain version (ops/pairhmm.py:
pairhmm_forward_logodds_plain), and the wide layout's pick by width.

blocked_wide repeats the kernel's row: each lane's CH columns in order,
each lane's map of Y composed over its columns, the warp's lanes' maps
scanned, the G warps' maps composed in the kernel's shuffle-tree order
for the value entering each warp, lane 0's diagonal handed from warp
w - 1's record, the row max over the G warps' records, the reciprocal
of the max applied where the next row reads a value, warps past the
pair's own B idle with the identity map and a zero max. Tolerance:
2e-4 nats a residue, the bar of tests/test_pairhmm_forward.py that the
kernel is held to on the card (both sides f32; they differ in the order
of the Y sums, and the plain version drops the scan's underflowing
coefficients)."""

import numpy as np
import pytest
import torch

from witch_tpu_torch.backbone_consistency import _emission_odds
from witch_tpu_torch.core.alphabet import ALPHABETS
from witch_tpu_torch.ops.pairhmm import (PH_WIDE_LB_MAX, PHW_CH, PHW_COLS,
                                         pairhmm_forward_logodds_plain,
                                         pairhmm_layout, phw_gmax,
                                         transitions, wide_candidates)


def _then(f, g):
    """Affine maps (a, b) composed: first f, then g."""
    return f[0] * g[0], f[1] * g[0] + g[1]


def _shift(t, s, dim, fill):
    """t moved s places up (s > 0) or down (s < 0) along dim, fill where
    nothing moved in."""
    n = t.shape[dim]
    out = torch.full_like(t, fill)
    if s > 0:
        out.narrow(dim, s, n - s).copy_(t.narrow(dim, 0, n - s))
    else:
        out.narrow(dim, 0, n + s).copy_(t.narrow(dim, -s, n + s))
    return out


def blocked_wide(cA, lA, cB, lB, em, delta, eps, ch, G, carry="all"):
    """[P] f32 forward log-odds through the wide kernel's split (CPU).
    carry="prev" takes Y entering warp w from warp w - 1's map alone (as
    if Y entered warp w - 1 at 0): the shortcut the carry test rules out."""
    f32 = torch.float32
    P, LA = cA.shape
    C = em.shape[0]
    n = 32 * G * ch
    assert n >= cB.shape[1] + 1
    t_mm, t_mg, t_gm, t_gg = transitions(delta, eps)
    emz = torch.cat([em, torch.zeros(C, 1, dtype=f32)], 1)   # [C, C + 1]
    j = torch.arange(n)
    inB = (j[None, :] >= 1) & (j[None, :] <= lB[:, None])
    code = torch.full((P, n), C, dtype=torch.long)
    src = torch.gather(cB.long(), 1, (j - 1).clamp(0, cB.shape[1] - 1)
                       .expand(P, n))
    code[inB] = src[inB]
    shape = (P, G, 32, ch)
    code = code.view(shape)
    inB4 = (j[None, :] <= lB[:, None]).view(shape)     # columns 0..len B
    live = (32 * torch.arange(G)[None, :] * ch <= lB[:, None])  # [P, G]
    M = (j == 0).to(f32).expand(P, n).clone().view(shape)
    X = torch.zeros(shape, dtype=f32)
    geo = t_mg * torch.pow(torch.full((n,), t_gg, dtype=f32),
                           (j - 1).clamp(min=0).to(f32))
    Y = torch.where(inB, geo[None, :], torch.zeros(())).to(f32).view(shape)
    inv = torch.ones(P, dtype=f32)
    logs = torch.zeros(P, dtype=torch.float64)
    one = torch.ones((P, G, 32), dtype=f32)
    for i in range(LA):
        act = i < lA
        lv = (live & act[:, None])[:, :, None]                 # [P, G, 1]
        iv = inv[:, None, None]
        e = torch.gather(emz[cA[:, i].long()], 1, code.reshape(P, -1)) \
            .view(shape)
        # previous row, column j - 1: lane - 1's last column, or for lane
        # 0 warp - 1's record (0 in warp 0)
        lastM, lastX, lastY = (_shift(v[..., ch - 1], 1, 2, 0.0)
                               for v in (M, X, Y))
        for v, full in zip((lastM, lastX, lastY), (M, X, Y)):
            v[:, 1:, 0] = full[:, :-1, 31, ch - 1]
        pM, pX, pY = lastM * iv, lastX * iv, lastY * iv
        nM, nX = torch.empty_like(M), torch.empty_like(X)
        f = (one.clone(), torch.zeros_like(one))
        for k in range(ch):
            oM, oX, oY = M[..., k] * iv, X[..., k] * iv, Y[..., k] * iv
            m = e[..., k] * (t_mm * pM + t_gm * pX + t_gm * pY)
            nM[..., k] = m
            nX[..., k] = t_mg * oM + t_gg * oX
            pM, pX, pY = oM, oX, oY
            f = _then(f, (torch.full_like(m, t_gg), t_mg * m))
        # the warp scan of its lanes' maps
        x = f
        s = 1
        while s < 32:
            q = (_shift(x[0], s, 2, 1.0), _shift(x[1], s, 2, 0.0))
            x = _then(q, x)                 # identity below lane s
            s *= 2
        # each warp's map (identity past B); Y entering warp w: warps
        # 0..w-1's maps in the kernel's shuffle-tree order, applied to 0
        wa = torch.where(live, x[0][:, :, 31], torch.ones(()))
        wb = torch.where(live, x[1][:, :, 31], torch.zeros(()))
        lane = torch.arange(32)
        below = lane[None, :] < torch.arange(G)[:, None]       # [w, lane]
        if carry == "prev":
            below &= lane[None, :] == torch.arange(G)[:, None] - 1
        ga = torch.where(below, _per_lane(wa, 32), torch.ones(()))
        gb = torch.where(below, _per_lane(wb, 32), torch.zeros(()))
        s = 1
        while s < G:
            ga, gb = _then((ga, gb), (_shift(ga, -s, 2, 1.0),
                                      _shift(gb, -s, 2, 0.0)))
            s *= 2
        yin = gb[..., 0][:, :, None]                           # [P, G, 1]
        ea = _shift(x[0], 1, 2, 1.0)
        eb = _shift(x[1], 1, 2, 0.0)
        y = torch.where(lane[None, None, :] == 0, yin, ea * yin + eb)
        nY = torch.empty_like(Y)
        mxY = torch.zeros_like(y)
        for k in range(ch):
            nY[..., k] = y
            mxY = torch.where(inB4[..., k], torch.maximum(mxY, y), mxY)
            y = t_gg * y + t_mg * nM[..., k]
        wmax = torch.maximum(torch.maximum(nM.amax(3), nX.amax(3)), mxY) \
            .amax(2)
        rmax = torch.where(live, wmax, torch.zeros(())).amax(1)
        mx = torch.where(rmax <= 0, torch.ones(()), rmax)
        keep = lv[..., None]
        M = torch.where(keep, nM, M)
        X = torch.where(keep, nX, X)
        Y = torch.where(keep, nY, Y)
        inv = torch.where(act, 1.0 / mx, inv)
        logs = logs + torch.where(act, torch.log(mx.double()), 0.0)
    flat = [v.reshape(P, -1) for v in (M, X, Y)]
    at = lB.long()[:, None]
    vM, vX, vY = (torch.gather(v, 1, at)[:, 0] for v in flat)
    tot = vM * inv + vX * inv + vY * inv
    return (torch.log(tot.clamp(min=1e-30)).double() + logs).to(f32)


def _per_lane(w, lanes):
    """[P, G] per-warp values laid out as each warp's lanes would read
    them: [P, G (the reading warp), lanes] with lane g holding warp g's
    value (g < G)."""
    P, G = w.shape
    out = torch.zeros((P, G, lanes), dtype=w.dtype)
    out[:, :, :G] = w[:, None, :]
    return out


def _batch(seed, P, LA, LB, lo_a, lo_b):
    rng = np.random.default_rng(seed)
    cA = rng.integers(0, 4, (P, LA)).astype(np.int32)
    # B: A's codes with a few substitutions, so the pairs score high
    cB = rng.integers(0, 4, (P, LB)).astype(np.int32)
    m = min(LA, LB)
    keep = rng.random((P, m)) < 0.8
    cB[:, :m] = np.where(keep, cA[:, :m], cB[:, :m])
    lA = rng.integers(lo_a, LA + 1, P).astype(np.int32)
    lB = rng.integers(lo_b, LB + 1, P).astype(np.int32)
    lB[0] = LB
    return [torch.from_numpy(x) for x in (cA, lA, cB, lB)]


@pytest.mark.parametrize("eps", [0.75, 0.99])
@pytest.mark.parametrize("LB,lo_b,pick", [
    (1536, 1200, None),         # the narrowest wide B
    (1700, 900, (8, 7)),        # 7 warps of 256 columns; B down to 900
    (2600, 2400, None),
    (5000, 3000, (32, 5))])     # warps past the shorter Bs
def test_blocked_model_matches_plain(LB, lo_b, pick, eps):
    """The kernel's split (blocked_wide) against the plain version within
    2e-4 nats a residue, at the layout's own pick or a forced one, with
    pairs shorter than the launch's B by more than a warp's columns."""
    lay = pairhmm_layout(5, LB)
    assert lay[0] == 2
    ch, G = pick or lay[1:]
    assert (ch, G) in wide_candidates(LB)
    P = 3
    cA, lA, cB, lB = _batch(LB, P, 48, LB, 30, lo_b)
    em = torch.from_numpy(_emission_odds(ALPHABETS["dna"], 0.3)
                          .astype(np.float32))
    got = blocked_wide(cA, lA, cB, lB, em, 0.02, eps, ch, G)
    want = pairhmm_forward_logodds_plain(cA, lA, cB, lB, em, 0.02, eps)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    norm = torch.minimum(lA, lB).double()
    err = ((got.double() - want.double()).abs() / norm).max()
    assert err < 2e-4, (LB, ch, G, eps, float(err))
    if lo_b < LB - 32 * ch:
        assert not bool((32 * torch.arange(G)[None, :] * ch
                         <= lB[:, None]).all()), "no warp past a B"


def test_blocked_model_carries_y_across_warps():
    """At eps 0.99 a warp's map of Y over its 32 CH columns keeps
    t_gg^(32 CH) ~ 0.076 at CH 8 (at eps 0.75 it is below f32's
    resolution): Y entering warp w taken from warp w - 1's map alone
    misses the plain version by more than the bar, the composition of
    all G records meets it."""
    LB, ch, G = 1700, 8, 7
    cA, lA, cB, lB = _batch(3, 2, 40, LB, 40, LB)
    em = torch.from_numpy(_emission_odds(ALPHABETS["dna"], 0.3)
                          .astype(np.float32))
    assert transitions(0.02, 0.99)[3] ** (32 * ch) > 0.05
    assert transitions(0.02, 0.75)[3] ** (32 * ch) < 1e-30
    plain = pairhmm_forward_logodds_plain(cA, lA, cB, lB, em, 0.02, 0.99)
    norm = torch.minimum(lA, lB).double()
    err = {c: float(((blocked_wide(cA, lA, cB, lB, em, 0.02, 0.99, ch, G,
                                   carry=c).double() - plain.double())
                     .abs() / norm).max()) for c in ("all", "prev")}
    assert err["all"] < 2e-4 < err["prev"], err


@pytest.mark.parametrize("ch", PHW_CH)
def test_wide_candidates_at_each_g_step(ch):
    """G = ceil((LB + 1) / 32 CH): 32 G CH - 1 is the widest B of G
    warps, one more takes G + 1, up to the instance's most warps
    (phw_gmax: enough for PHW_COLS columns) and the cap PH_WIDE_LB_MAX."""
    gmax = phw_gmax(ch)
    assert 32 * gmax * ch >= PHW_COLS > 32 * (gmax - 1) * ch
    for G in range(2, gmax + 1):
        LB = min(32 * G * ch - 1, PH_WIDE_LB_MAX)
        assert (ch, G) in wide_candidates(LB)
        if LB < PH_WIDE_LB_MAX:
            nxt = dict(wide_candidates(LB + 1)).get(ch)
            assert nxt == (G + 1 if G < gmax else None), (ch, G, nxt)
    assert wide_candidates(PH_WIDE_LB_MAX + 1) == []


def test_wide_pick_covers_every_width():
    """From 1,536 to the cap the pick is a wide candidate holding LB + 1
    columns with no warp wholly past B; C 64 takes the first version."""
    for LB in range(1536, PH_WIDE_LB_MAX + 1, 7):
        lay, ch, G = pairhmm_layout(17, LB)
        assert lay == 2 and (ch, G) in wide_candidates(LB)
        assert 32 * (G - 1) * ch <= LB
    assert pairhmm_layout(64, 1700) == (1, 0, 0)
