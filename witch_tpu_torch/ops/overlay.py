"""The exact-f32 print overlay on the card: the native engine's
exact_scores32 (native/domaindef_kernel.cpp:exact32_target) split at its
transcendental functions, its L x M value streams in csrc/overlay.cu.

For the pairs of a model whose striped rows fit the kernel
(stripes(M) <= Q_MAX):
  host  exact32_tables     the model's striped f32 profile, once a model
  card  launch A           the full-sequence multihit Forward and Backward
                           (stream mode): both xmx rows, own-scales flag
  host  exact32_regions    domain decoding, region scan, fwdsc
  card  launch B           per single-envelope region: the unihit Forward,
                           Backward, posterior decoding, null2
  host  exact32_finish     n2sc, domcorr, envsc, the score assembly
A pair with a multidomain region goes whole to exact_scores32 (its trace
ensemble stays native), and so do the pairs of wider models; a pool of
host threads runs them beside the launches. Every score equals
exact_scores32's bit for bit: the card computes only IEEE multiplies,
adds, divides and compares, in the engine's order, and every libm call
(x_log, x_logf, p7_flogsum: the reference binary's libm when installed)
stays in the host stages.

A launcher runs the launches (`prepare(tables, codes)` once, then one call
a launch): CardLauncher on a CUDA device, HostLauncher (the host engine's
own outputs, exact32_intermediates) on any other, so the CPU runs the
same split chain as the card.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from .. import _build
from ..spans import span
from .plan import scratch_cap

# Stripes (4 states each) of the widest model on the card: csrc/overlay.cu
# stages a row's 4 Q cells in its 256 threads' registers, 8 a thread, and
# keeps one row of Q x 12 floats in shared memory (24.6 KB at Q_MAX).
# Wider models (dnawide's, Mp 7,000+) stay on the native engine.
Q_MAX = 512
# Launch B's stored planes per launch (M and I of every envelope row,
# ~4.3 GB for a dna1k job's ~705 envelopes), at most plan.scratch_cap; a
# larger call runs in several launches
PLANE_BYTES = 8 << 30


def stripes(M: int) -> int:
    return max(2, (M + 3) // 4)


def on_card(M: int) -> bool:
    return stripes(M) <= Q_MAX


@dataclasses.dataclass
class Table:
    """One model's striped profile (exact32_tables)."""
    Q: int
    nj: float
    rfv: np.ndarray       # f32 [ncodes * Q * 4]
    tfv: np.ndarray       # f32 [8 * Q * 4]
    xargs: tuple          # the native engine's model arguments


def table(xargs) -> Table:
    from ..native import _domaindef
    return Table(*_domaindef.exact32_tables(*xargs), tuple(xargs))


@dataclasses.dataclass
class Items:
    """One launch's items: pair g's codes[i0 : i0 + ld] against model
    `model` (an index into the launcher's tables), length model lseq."""
    model: np.ndarray     # int32 [n]
    pair: np.ndarray      # int32 [n]
    i0: np.ndarray        # int32 [n]
    ld: np.ndarray        # int32 [n]
    lseq: np.ndarray      # int32 [n]

    def __len__(self):
        return len(self.ld)

    def row_offsets(self) -> np.ndarray:
        """Each item's first xmx row (rows 0..ld of each, in order)."""
        return np.r_[0, np.cumsum(self.ld.astype(np.int64) + 1)]


class HostLauncher:
    """The launches on the host engine (exact32_intermediates), one model
    a worker of a pool of nthreads, each in an `overlay.model` span under
    `parent`: what the card must reproduce bit for bit."""

    def __init__(self, nthreads: int = 1, parent=None):
        self.nthreads = nthreads
        self.parent = parent

    def prepare(self, tables: Sequence[Table], codes: Sequence[np.ndarray]):
        self.tables, self.codes = tables, codes

    def _model(self, items: Items, mode: int, m: int):
        from ..native import _domaindef
        idx = np.flatnonzero(items.model == m)
        with span("overlay.model", parent=self.parent, items=len(idx)):
            return idx, _domaindef.exact32_intermediates(
                *self.tables[m].xargs, [self.codes[p] for p in items.pair[idx]],
                np.ascontiguousarray(items.i0[idx], np.int32),
                np.ascontiguousarray(items.ld[idx], np.int32),
                np.ascontiguousarray(items.lseq[idx], np.int32), mode, 1)

    def __call__(self, items: Items, mode: int):
        off = items.row_offsets()
        n = len(items)
        xf = np.zeros(off[-1] * 6, np.float32)
        xb = np.zeros(off[-1] * 6, np.float32)
        fl = np.zeros(n, np.int32)
        null2 = None
        with ThreadPoolExecutor(max_workers=max(1, self.nthreads)) as pool:
            done = list(pool.map(lambda m: self._model(items, mode, m),
                                 np.unique(items.model)))
        for idx, (f, b, g, n2) in done:
            sub = np.r_[0, np.cumsum(items.ld[idx].astype(np.int64) + 1)] * 6
            for t, e in enumerate(idx):
                xf[off[e] * 6:off[e + 1] * 6] = f[sub[t]:sub[t + 1]]
                xb[off[e] * 6:off[e + 1] * 6] = b[sub[t]:sub[t + 1]]
            fl[idx] = g
            if null2 is None:
                null2 = np.zeros((n, len(n2) // len(idx)), np.float32)
            null2[idx] = n2.reshape(len(idx), -1)
        return xf, xb, fl, null2


class CardLauncher:
    """The launches on `device`'s card (csrc/overlay.cu). prepare uploads
    the tables and the pairs' codes once a call of exact_scores; each
    launch's kernel ms go to _build.KERNEL_MS["overlay"]."""

    def __init__(self, device, kc: int):
        self.device = device
        self.kc = kc
        # one (mode, items, max ld x Q, kernel ms) a launch call
        self.calls = []

    def prepare(self, tables: Sequence[Table], codes: Sequence[np.ndarray]):
        import torch
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa
            self.device)
        rf_off = np.r_[0, np.cumsum([len(x.rfv) for x in tables])]
        tf_off = np.r_[0, np.cumsum([len(x.tfv) for x in tables])]
        self.m_Q = np.array([x.Q for x in tables], np.int32)
        self.rf = t(np.concatenate([x.rfv for x in tables]))
        self.tf = t(np.concatenate([x.tfv for x in tables]))
        self.m = [t(self.m_Q), t(np.array([x.nj for x in tables], np.float32)),
                  t(rf_off[:-1].astype(np.int64)),
                  t(tf_off[:-1].astype(np.int64))]
        lens = np.array([len(c) for c in codes], np.int64)
        self.code_off = np.r_[0, np.cumsum(lens)]
        self.codes = t(np.concatenate(codes).astype(np.uint8)
                       if len(codes) else np.zeros(1, np.uint8))

    def __call__(self, items: Items, mode: int):
        import torch
        dev = self.device
        n = len(items)
        off = items.row_offsets()
        xf = torch.empty(int(off[-1]) * 6, dtype=torch.float32, device=dev)
        xb = torch.empty_like(xf)
        fl = torch.zeros(n, dtype=torch.int32, device=dev)
        null2 = torch.zeros((n, self.kc), dtype=torch.float32, device=dev)
        q = self.m_Q[items.model].astype(np.int64)
        plane = 8 * items.ld.astype(np.int64) * q if mode else \
            np.zeros(n, np.int64)
        # launches cut where the stored planes pass the budget
        budget = min(PLANE_BYTES, scratch_cap(dev)) if mode else 0
        cut = [0]
        acc = 0
        for e in range(n):
            if acc and (acc + plane[e]) * 4 > budget:
                cut.append(e)
                acc = 0
            acc += plane[e]
        cut.append(n)
        poff = np.zeros(n, np.int64)
        most = 1
        for a, b in zip(cut[:-1], cut[1:]):
            poff[a:b] = np.r_[0, np.cumsum(plane[a:b])][:-1]
            most = max(most, int(plane[a:b].sum()))
        scratch = torch.empty(most if mode else 1, dtype=torch.float32,
                              device=dev)
        t = lambda a, d: torch.from_numpy(np.ascontiguousarray(a, d)).to(  # noqa
            dev)
        it = [t(items.model, np.int32), t(items.ld, np.int32),
              t(items.lseq, np.int32),
              t(self.code_off[items.pair] + items.i0, np.int64),
              t(off[:-1], np.int64), t(poff, np.int64)]
        with _build.on_card(dev):
            lib = _build.lib()
            stream = _build.stream_ptr(dev)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for a, b in zip(cut[:-1], cut[1:]):
                if b == a:
                    continue
                rc = lib.witch_overlay(
                    self.rf.data_ptr(), self.tf.data_ptr(),
                    *[x.data_ptr() for x in self.m], self.codes.data_ptr(),
                    *[x[a:].data_ptr() for x in it], xf.data_ptr(),
                    xb.data_ptr(), fl[a:].data_ptr(), null2[a:].data_ptr(),
                    scratch.data_ptr(), b - a, self.kc,
                    int(q[a:b].max()), mode, stream)
                _build.check(rc, "overlay", device=dev)
            ev[1].record()
            ev[1].synchronize()
            ms = ev[0].elapsed_time(ev[1])
            _build.KERNEL_MS["overlay"] += ms
        self.calls.append((mode, n, int((items.ld * q).max(initial=0)), ms))
        return (xf.cpu().numpy(), xb.cpu().numpy(), fl.cpu().numpy(),
                null2.cpu().numpy())


Jobs = Sequence[Tuple[tuple, List[np.ndarray]]]


def overlay_scores(jobs: Jobs, device, kc: int, nthreads: int, parent):
    """The print overlay's exact_scores32 over every (model args, codes
    list) job through the split chain, its launches on the card on a CUDA
    device (CardLauncher; kc canonical codes) and on the host engine
    anywhere else. Returns (ok, seq, pre) lists; the counters of
    exact_scores go to `parent`."""
    import torch
    if torch.device(device).type == "cuda":
        launch = CardLauncher(device, kc)
    else:
        launch = HostLauncher(nthreads, parent)
    ok, seq, pre, cnt = exact_scores(jobs, launch, nthreads, parent)
    parent.counters.update(cnt)
    return ok, seq, pre


def _native(jobs, k, idx, parent):
    """exact_scores32 on job k's pairs idx, in an `overlay.model` span."""
    from ..native import _domaindef
    xargs, cl = jobs[k]
    with span("overlay.model", parent=parent, pairs=len(idx)):
        o, s, p = _domaindef.exact_scores32(*xargs, [cl[t] for t in idx], 1)
    return k, idx, o, s, p


def _results(jobs):
    return ([np.zeros(len(cl), np.uint8) for _, cl in jobs],
            [np.zeros(len(cl), np.float64) for _, cl in jobs],
            [np.zeros(len(cl), np.float64) for _, cl in jobs])


def _collect(futs, ok, seq, pre):
    for f in futs:
        k, idx, o, s, p = f.result()
        ok[k][idx] = o
        seq[k][idx] = s
        pre[k][idx] = p


def exact_scores(jobs: Jobs, launch, nthreads: int, parent=None):
    """exact_scores32 over every job through the split chain, its
    launches by `launch`. Returns (ok, seq, pre, counters): device_pairs
    (decided by the split), native_pairs = multidomain + wide (run by
    exact_scores32 in a pool of nthreads), refused (own-scales or
    decoding refusals: ok = 0, as exact_scores32 gives them)."""
    ok, seq, pre = _results(jobs)
    cnt = dict(device_pairs=0, native_pairs=0, multidomain=0, wide=0,
               refused=0)
    card = [k for k, (xargs, _) in enumerate(jobs)
            if on_card(xargs[0].shape[0] - 1)]
    with ThreadPoolExecutor(max_workers=max(1, nthreads)) as pool:
        futs = []
        for k, (xargs, cl) in enumerate(jobs):
            if not on_card(xargs[0].shape[0] - 1) and cl:
                cnt["wide"] += len(cl)
                futs.append(pool.submit(_native, jobs, k, np.arange(len(cl)),
                                        parent))
        if card:
            _split(jobs, card, launch, pool, parent, futs, (ok, seq, pre),
                   cnt)
        _collect(futs, ok, seq, pre)
    cnt["native_pairs"] = cnt["multidomain"] + cnt["wide"]
    return ok, seq, pre, cnt


def _split(jobs, card, launch, pool, parent, futs, out, cnt):
    """The split chain over the jobs `card`; multidomain pairs are
    submitted to `pool` (their futures appended to futs)."""
    from ..native import _domaindef
    tables = list(pool.map(lambda k: table(jobs[k][0]), card))
    codes, pk, pt = [], [], []
    for m, k in enumerate(card):
        for t, c in enumerate(jobs[k][1]):
            codes.append(np.ascontiguousarray(c, np.int32))
            pk.append(m)
            pt.append(t)
    pk = np.array(pk, np.int32)
    pt = np.array(pt, np.int64)
    L = np.array([len(c) for c in codes], np.int32)
    launch.prepare(tables, codes)
    n = len(codes)
    xf, xb, fl, _ = launch(Items(pk, np.arange(n, dtype=np.int32),
                                 np.zeros(n, np.int32), L, L), 0)
    nj = np.array([tables[m].nj for m in pk], np.float32)
    status, fwdsc, rp, ri, rj = _domaindef.exact32_regions(xf, xb, fl, L, nj)
    multi = np.flatnonzero(status == 2)
    cnt["multidomain"] += len(multi)
    for m in np.unique(pk[multi]):
        g = multi[pk[multi] == m]
        futs.append(pool.submit(_native, jobs, card[m], pt[g], parent))
    cnt["refused"] += int(np.sum(status == 3))
    cnt["device_pairs"] += int(np.sum(status == 1))
    good = np.flatnonzero(status == 0)
    if not len(good):
        return
    xf, _, efl, n2 = launch(Items(pk[rp], rp, ri - 1, rj - ri + 1, L[rp]), 1)
    where = np.full(n, -1, np.int64)
    where[good] = np.arange(len(good))
    okx, seqx, prex = _domaindef.exact32_finish(
        [codes[g] for g in good], fwdsc[good],
        where[rp].astype(np.int32), ri, rj, xf, efl,
        np.ascontiguousarray(n2, np.float32).reshape(-1))
    cnt["refused"] += int(np.sum(okx == 0))
    cnt["device_pairs"] += int(np.sum(okx != 0))
    ok, seq, pre = out
    for t, g in enumerate(good):
        k = card[pk[g]]
        ok[k][pt[g]] = okx[t]
        seq[k][pt[g]] = seqx[t]
        pre[k][pt[g]] = prex[t]
