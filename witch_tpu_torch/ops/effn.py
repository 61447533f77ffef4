"""The ensemble's entropy weighting on the card: hmm/build.py's
entropy_weight bisection for every model at once, in one launch of
csrc/effn.cu on a CUDA device and in its plain PyTorch version (the same
lock-step bisection in f64) on the CPU.

No TPU counterpart: the JAX package builds its models on host NumPy.

Each model's effn depends only on the signs of the bisection's f values
(each midpoint is an exact function of the branches taken), and the
card's f differs from NumPy's only in its last bits. So both versions
return, beside each effn, the smallest |f| of its steps, and effn_all
redoes on the host (entropy_weight) every model whose smallest |f| is
below EFFN_GUARD or NaN: every effn it returns equals the host's bit for
bit. The guard is 1e-9 bits; the smallest |f| seen over a dna1k job's
285 models was ~1e-7, against f64 rounding gaps near 1e-15.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..hmm.build import Counts, hmm_effn
from ..hmm.priors import get_background, get_emission_prior

EFFN_GUARD = 1e-9
MAX_ITER = 100        # entropy_weight's max_iter


def prior_table(molecule: str) -> np.ndarray:
    """The emission prior as the kernel reads it: [NC, K + 1], each
    component's mixture coefficient, then its pseudocounts."""
    pr = get_emission_prior(molecule)
    return np.ascontiguousarray(np.c_[pr.q, pr.alpha], np.float64)


def pack(counts: Sequence[Counts]):
    """The models' match-emission counts back to back ([sum M, K] f64) and
    each model's first row ([n + 1] int64)."""
    rows = [c.ecounts[1:] for c in counts]
    off = np.r_[0, np.cumsum([len(r) for r in rows])].astype(np.int64)
    return np.ascontiguousarray(np.concatenate(rows), np.float64), off


def effn_args(counts: Sequence[Counts], molecule: str, device):
    """effn_ref's and effn_card's inputs for `counts` on `device`: the
    packed counts and offsets, each model's nseq and target, the prior
    table and the background."""
    flat, off = pack(counts)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    return (t(flat), t(off),
            t(np.array([c.nseq for c in counts], np.float64)),
            t(np.array([c.etarget for c in counts], np.float64)),
            t(prior_table(molecule)),
            t(np.asarray(get_background(molecule), np.float64)))


def effn_ref(counts: torch.Tensor, off: torch.Tensor, nseq: torch.Tensor,
             etarget: torch.Tensor, prior: torch.Tensor, bg: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: entropy_weight's bisection for every model in lock
    step. Returns (effn, smallest |f|) [n] f64, NaN where an f was."""
    n, dev = nseq.shape[0], counts.device
    M = off[1:] - off[:-1]
    seg = torch.repeat_interleave(torch.arange(n, device=dev), M)
    q, a = prior[:, 0], prior[:, 1:]                     # [NC], [NC, K]
    asum = a.sum(dim=1)
    cst = torch.log(q) + torch.lgamma(asum)
    lga = torch.lgamma(a)
    l2bg = torch.log2(bg)

    def f_at(neff):
        c = counts * (neff / nseq)[seg, None]             # [C, K]
        cn = c.sum(dim=-1)
        lw = (cst - torch.lgamma(cn[:, None] + asum)
              + (torch.lgamma(c[:, None, :] + a) - lga).sum(dim=-1))
        w = torch.exp(lw - lw.max(dim=-1, keepdim=True).values)
        w = w / w.sum(dim=-1, keepdim=True)
        cm = (c[:, None, :] + a) / (cn[:, None, None] + asum[:, None])
        p = (w[..., None] * cm).sum(dim=-2)
        terms = torch.where(p > 0, p * (torch.log2(p) - l2bg),
                            torch.zeros_like(p))
        tot = torch.zeros(n, dtype=counts.dtype, device=dev).index_add_(
            0, seg, terms.sum(dim=-1))
        return tot / M.to(counts.dtype) - etarget

    fb = f_at(nseq)
    minf = fb.abs()
    done = fb <= 0
    effn = torch.where(done, nseq, torch.full_like(nseq, float("nan")))
    lo, hi = torch.zeros_like(nseq), nseq.clone()
    for _ in range(MAX_ITER):
        if bool(done.all()):
            break
        live = ~done
        mid = 0.5 * (lo + hi)
        f = f_at(mid)
        minf = torch.where(live, torch.minimum(minf, f.abs()), minf)
        stop = live & ((f == 0) | ((hi - lo) < 0.01))
        effn = torch.where(stop, mid, effn)
        done = done | stop
        go = live & ~stop
        hi = torch.where(go & (f > 0), mid, hi)
        lo = torch.where(go & ~(f > 0), mid, lo)
    effn = torch.where(done, effn, 0.5 * (lo + hi))
    return effn, minf


def effn_card(counts: torch.Tensor, off: torch.Tensor, nseq: torch.Tensor,
              etarget: torch.Tensor, prior: torch.Tensor, bg: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on the tensors' card: one launch, its CUDA-event ms added
    to _build.KERNEL_MS["effn"]. Same returns as effn_ref."""
    dev = counts.device
    n = nseq.shape[0]
    NC, K1 = prior.shape
    for x in (counts, off, nseq, etarget, prior, bg):
        if x.device != dev or not x.is_contiguous():
            raise ValueError("effn_card: inputs must be contiguous on %s"
                             % dev)
    if counts.dtype != torch.float64 or off.dtype != torch.int64 or \
            counts.shape[1] != K1 - 1 or bg.shape[0] != K1 - 1:
        raise ValueError("effn_card: counts f64 [C, K], off int64, "
                         "prior [NC, K + 1], bg [K]")
    effn = torch.empty(n, dtype=torch.float64, device=dev)
    minf = torch.empty_like(effn)
    with _build.on_card(dev):
        lib = _build.lib()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        rc = lib.witch_effn(counts.data_ptr(), off.data_ptr(),
                            nseq.data_ptr(), etarget.data_ptr(),
                            prior.data_ptr(), bg.data_ptr(), effn.data_ptr(),
                            minf.data_ptr(), n, K1 - 1, NC,
                            _build.stream_ptr(dev))
        _build.check(rc, "effn", count=n > 0, device=dev)
        ev[1].record()
        ev[1].synchronize()
        _build.KERNEL_MS["effn"] += ev[0].elapsed_time(ev[1])
    return effn, minf


def effn_all(counts: Sequence[Counts], molecule: str, device):
    """Every model's effn (entropy_weight's, bit for bit): the bisection
    on `device` (the kernel on a CUDA device, the plain version on the
    CPU), then the host's for the models the guard refuses. Returns
    (effn list, host_redo count)."""
    if not counts:
        return [], 0
    run = effn_card if torch.device(device).type == "cuda" else effn_ref
    got, minf = (x.cpu().numpy()
                 for x in run(*effn_args(counts, molecule, device)))
    effn = [float(e) if m >= EFFN_GUARD else hmm_effn(c, molecule)
            for e, m, c in zip(got, minf, counts)]
    return effn, int(np.sum(~(minf >= EFFN_GUARD)))
