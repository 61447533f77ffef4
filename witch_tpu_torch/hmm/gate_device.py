"""Device reporting gate: per-envelope null2 on the GPU, the rest of
domain definition on the native host engine.

Counterpart of witch_tpu/hmm/gate_device.py:evaluate_gate_device, the
same five stages with the envelope null2 of ops/null2.py:
  1. regions + multidomain split per model from the flank rows (native
     classify_targets_rows);
  2. every single-envelope region's null2 on the device (one batch per
     bank), concurrently with
  3. the multidomain pairs on the native engine (trace ensembles);
  4. per-pair assembly into evaluate_targets_rows' tuple layout;
  5. the envelope-qualification guard: pairs whose envelope score margin
     is within GUARD_NATS of flipping are re-evaluated on the native
     engine; `stats["reeval"]` re-evaluates the print-boundary pairs the
     caller finds (near_print_boundary).
Each stage is a span (spans.py) under the span open where the gate is
called, the device thread's too: gate.classify, gate.null2 (the device
thread: null2 launches, kernel ms and envelopes), gate.multidomain (the
host pool, and a span a model in its workers), gate.wait (the wait for
the device thread after the pool), gate.assemble and gate.reeval (a span
a model re-evaluated).

GUARD_BITS, GUARD_NATS, OMEGA_LOG, _flogsum0 and near_print_boundary are
copied from witch_tpu/hmm/gate_device.py.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from ..ops.null2 import NCODE, null2_envelopes
from ..spans import current, span

GUARD_BITS = 5e-3          # distance to a 0.05 rounding boundary
GUARD_NATS = 5e-3          # envelope-qualification / sum-score guard
OMEGA_LOG = float(np.log(1.0 / 256.0))


def _flogsum0(lw: float) -> float:
    """FLogsum(0, lw) in f64 (the C++ engine's seqbias combiner)."""
    if lw > 0.0:
        return lw + np.log1p(np.exp(-lw))
    return float(np.log1p(np.exp(lw)))


def near_print_boundary(bits: float, eps: float = GUARD_BITS) -> bool:
    """True when `bits` is within eps of a 0.1-bit rounding boundary
    (np.round-to-even on the first decimal)."""
    d = bits * 10.0
    return abs(d - np.floor(d) - 0.5) < eps * 10.0


def evaluate_gate_device(banks_t, bankloc_of_col, allargs, qcodes,
                         by_j: Dict[int, List[int]], flank_rows,
                         nsamples: int = 200, seed: int = 42,
                         nthreads: int = 4):
    """Returns ({j: (nreg, nenv, sbias, fwd_zeros, senv, sbsum, ld)},
    stats) in evaluate_targets_rows' layout (the f64 Forward column is
    zero: the caller supplies it).

    banks_t: BankTensors per scoring bank (device.bank_to_torch).
    bankloc_of_col: (bank_index, bank_row) per score column j.
    allargs: per-column native model args (msc + 8 transition rows).
    qcodes: per-query int32 code arrays.
    by_j: {column j: [query indices]} candidate batches.
    flank_rows: {j: (mocc, ppB, ppE)} f32 rows from the native flank scan.
    """
    from ..native import _domaindef

    items = sorted(by_j.items())
    caller = current()

    # ---- stage 1: regions + multidomain split per model (native) -----
    cls = {}
    entries = []                 # (bank_row, sub_codes, L_full)
    entry_bank = []
    entry_loc = []               # (j, local_pair_idx, ei, ej)
    with span("gate.classify"):
        for j, qlist in items:
            mocc, ppb, ppe = flank_rows[j]
            lens = np.array([len(qcodes[q]) for q in qlist], np.int32)
            nreg, hmulti, pidx, ei, ej = _domaindef.classify_targets_rows(
                lens, mocc, ppb, ppe)
            cls[j] = (np.asarray(nreg), np.asarray(hmulti))
            bi, row = bankloc_of_col[j]
            for r in range(len(pidx)):
                p = int(pidx[r])
                q = qlist[p]
                sub = np.ascontiguousarray(
                    qcodes[q][int(ei[r]) - 1:int(ej[r])], np.int32)
                entries.append((row, sub, len(qcodes[q])))
                entry_bank.append(bi)
                entry_loc.append((j, p, int(ei[r]), int(ej[r])))

    # ---- stages 2+3 concurrently: device null2 | host multidomain ----
    n_e = len(entries)
    envsc = np.zeros(n_e)
    n2dot = np.zeros((n_e, NCODE))
    useI = np.zeros(n_e)
    usetot = np.zeros(n_e)
    entry_bank = np.asarray(entry_bank, np.int64)

    def run_device_null2():
        # its span ends with each bank's copy back, which waits for the
        # kernel: the device null2 stage as the gate sees it
        with span("gate.null2", parent=caller, kernels="null2",
                  envelopes=n_e):
            for bi, bt in enumerate(banks_t):
                sel = np.flatnonzero(entry_bank == bi)
                if len(sel) == 0:
                    continue
                es, nd, ui, ut = null2_envelopes(
                    bt, [entries[r] for r in sel])
                envsc[sel] = es
                n2dot[sel] = nd
                useI[sel] = ui
                usetot[sel] = ut

    def eval_multi(args):
        j, qlist = args
        _, hmulti = cls[j]
        sel = np.flatnonzero(hmulti)
        if len(sel) == 0:
            return j, None, sel
        with span("multidomain.model", parent=multi, pairs=len(sel)):
            mocc, ppb, ppe = flank_rows[j]
            codes_list = [np.ascontiguousarray(qcodes[qlist[p]], np.int32)
                          for p in sel]
            out = _domaindef.evaluate_targets_rows(
                *allargs[j], codes_list, seed, nsamples, 1, 0,
                np.ascontiguousarray(mocc[sel]),
                np.ascontiguousarray(ppb[sel]),
                np.ascontiguousarray(ppe[sel]), 1)
        return j, out, sel

    dev_exc = []

    def dev_wrap():
        try:
            run_device_null2()
        except BaseException as e:   # noqa: BLE001 - re-raised below
            dev_exc.append(e)

    dev_thread = threading.Thread(target=dev_wrap, daemon=True)
    dev_thread.start()
    multi_out = {}
    with span("gate.multidomain") as multi:
        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            for j, out, sel in ex.map(eval_multi, items):
                multi_out[j] = (out, sel)
    with span("gate.wait"):
        dev_thread.join()
    if dev_exc:
        raise dev_exc[0]

    # ---- stage 4: assemble per-pair tuples ---------------------------
    with span("gate.assemble"):
        per_pair: Dict[Tuple[int, int], List[int]] = {}
        for r, (j, p, _, _) in enumerate(entry_loc):
            per_pair.setdefault((j, p), []).append(r)
        if n_e:
            Ldr_a = np.array([len(e[1]) for e in entries], np.float64)
            flat_codes = np.concatenate([e[1] for e in entries])
            flat_r = np.repeat(np.arange(n_e), Ldr_a.astype(np.int64))
            counts_m = np.bincount(flat_r * NCODE + flat_codes,
                                   minlength=n_e * NCODE).reshape(n_e, NCODE)
            xocc_a = np.maximum(Ldr_a - usetot, 0.0)
            n2x_m = (n2dot + useI[:, None] + xocc_a[:, None]) / Ldr_a[:, None]
            with np.errstate(divide="ignore"):
                logs_m = np.log(np.maximum(n2x_m, 1e-30))
            n2sum_a = np.einsum("ij,ij->i", counts_m.astype(np.float64),
                                logs_m)
            margin_a = envsc - n2sum_a
            near_a = np.abs(margin_a) < GUARD_NATS
            pos_a = margin_a > 0.0
        else:
            n2sum_a = near_a = pos_a = Ldr_a = np.zeros(0)

        results = {}
        guard: Dict[int, List[int]] = {}
        for j, qlist in items:
            n = len(qlist)
            nreg, hmulti = cls[j]
            nenv = np.where(hmulti == 0, nreg, 0).astype(np.int32)
            sbias = np.zeros(n)
            senv = np.zeros(n)
            sbsum = np.zeros(n)
            ld = np.zeros(n, np.int32)
            for p in range(n):
                if hmulti[p] or nreg[p] == 0:
                    continue      # no regions: seqbias stays 0 (host engine)
                rows = np.asarray(per_pair.get((j, p), []), np.int64)
                s_total = float(n2sum_a[rows].sum()) if len(rows) else 0.0
                if len(rows):
                    if near_a[rows].any():
                        guard.setdefault(j, []).append(p)
                    sel_r = rows[pos_a[rows]]
                    senv[p] = float(envsc[sel_r].sum())
                    sbsum[p] = float(n2sum_a[sel_r].sum())
                    ld[p] = int(Ldr_a[sel_r].sum())
                sbias[p] = _flogsum0(OMEGA_LOG + s_total)
            out, sel = multi_out[j]
            if out is not None:
                mreg, menv, msbias, _mf, msenv, msbsum, mld = out
                for t, p in enumerate(sel):
                    nreg[p] = mreg[t]
                    nenv[p] = menv[t]
                    sbias[p] = msbias[t]
                    senv[p] = msenv[t]
                    sbsum[p] = msbsum[t]
                    ld[p] = mld[t]
            results[j] = [np.asarray(nreg), np.asarray(nenv), sbias,
                          np.zeros(n), senv, sbsum, ld]

    # ---- stage 5: guards (native re-evaluation) ----------------------
    stats = dict(entries=n_e, multi=sum(int(h.sum())
                                        for _, h in cls.values()),
                 multi_flags={j: cls[j][1] for j, _ in items})

    def reeval(j, plist):
        """Native f64 re-evaluation of pairs of model j; patches
        `results` in place."""
        qlist = by_j[j]
        mocc, ppb, ppe = flank_rows[j]
        sel = np.asarray(sorted(set(plist)), np.int64)
        codes_list = [np.ascontiguousarray(qcodes[qlist[p]], np.int32)
                      for p in sel]
        with span("gate.reeval", pairs=len(sel)):
            out = _domaindef.evaluate_targets_rows(
                *allargs[j], codes_list, seed, nsamples, 1, 0,
                np.ascontiguousarray(mocc[sel]),
                np.ascontiguousarray(ppb[sel]),
                np.ascontiguousarray(ppe[sel]), 1)
        mreg, menv, msbias, _mf, msenv, msbsum, mld = out
        res = results[j]
        for t, p in enumerate(sel):
            res[0][p] = mreg[t]
            res[1][p] = menv[t]
            res[2][p] = msbias[t]
            res[4][p] = msenv[t]
            res[5][p] = msbsum[t]
            res[6][p] = mld[t]

    n_guard = 0
    for j, plist in guard.items():
        n_guard += len(plist)
        reeval(j, plist)
    stats["guard_margin"] = n_guard
    stats["reeval"] = reeval
    return results, stats
