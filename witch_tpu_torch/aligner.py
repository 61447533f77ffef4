"""Per-query alignment stage on the device: adaptive HMM selection ->
fused posterior+OA kernel -> merge (the witch-ng weighted DP, or the
old-witch GCM merge).

Counterpart of witch_tpu/aligner.py (DeviceAligner's OA branch and
align_all_queries). Pairs whose decision margin falls below the guard
(2e-3, the JAX path's calibration) or whose traceback fails are
re-aligned on the native f64 engine (posterior_oa_pair); that guard is
part of the output contract (hmmalign-exact columns), and its count is
logged. select_pairs and HostAligner are copied from witch_tpu/aligner.py
(that module's device aligners reach JAX).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import _build
from .config import Configs
from .device import bank_to_torch
from .ensemble import Ensemble
from .hmm.profile import Profile, configure
from .ops.merge_dp import align_query_row
from .ops.oa import bank_strictly_positive, oa_columns
from .weighting import adaptive_top_hmms

OA_GUARD = 2e-3


def select_pairs(qnames: Sequence[str], weights: Dict[str, tuple],
                 use_weight: bool = True):
    """Adaptive top-HMM selection per query -> list of (qname, [(idx, w)]).
    Queries without weights are returned in `ignored`."""
    selections = {}
    ignored = []
    for qname in qnames:
        w = weights.get(qname, tuple())
        if not w:
            ignored.append(qname)
            continue
        selections[qname] = adaptive_top_hmms(w, use_weight=use_weight)
    return selections, ignored


class HostAligner:
    """float64 numpy per-pair alignment (reference-exact)."""

    def __init__(self, ens: Ensemble):
        self.ens = ens
        self._profiles: Dict[int, Profile] = {}

    def profile(self, idx: int) -> Profile:
        if idx not in self._profiles:
            self._profiles[idx] = configure(self.ens.cores[idx],
                                            multihit=False)
        return self._profiles[idx]

    def aligned_columns(self, idx: int, codes: np.ndarray) -> np.ndarray:
        from .hmm.align_ref import aligned_columns
        return aligned_columns(self.profile(idx), codes)


class DeviceAligner:
    """Device posterior+OA for (hmm_idx, codes) pairs, with the native
    margin guard. Uses the scoring banks (their tables do not depend on
    the multihit flag; the kernel applies the unihit specials)."""

    def __init__(self, ens, device, banks=None):
        self.host = HostAligner(ens)
        if banks is None:
            from .hmm.bank import build_banks
            idx = ens.indices
            banks = build_banks([ens.cores[i] for i in idx], indices=idx,
                                uniform=True, n_buckets=2)
        for b in banks:
            if not bank_strictly_positive(b):
                raise ValueError(
                    "a bank has a zero core transition: the device OA "
                    "kernel requires every in-range transition > 0")
        self.banks_t = [bank_to_torch(b, device) for b in banks]
        self.bank_row = {int(idx): (bi, r) for bi, b in enumerate(banks)
                         for r, idx in enumerate(b.hmm_indices)}

    def native_columns(self, pairs) -> List[np.ndarray]:
        """f64 posterior + OA on the native engine (threaded)."""
        from .hmm.align_ref import _deltas_u8
        from .native import _domaindef
        from .pipeline import _native_args
        args: Dict[int, tuple] = {}
        for idx, _ in pairs:
            if idx not in args:
                prof = self.host.profile(idx)
                args[idx] = (_native_args(prof),
                             [np.ascontiguousarray(x)
                              for x in _deltas_u8(prof)])

        def one(pair):
            idx, codes = pair
            a, d = args[idx]
            c = np.ascontiguousarray(codes, np.int32)
            return np.asarray(_domaindef.posterior_oa_pair(
                *a, c, len(c), 0, *d))[:len(c)]

        workers = max(1, min(8, int(getattr(Configs, "num_cpus", 4))))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(one, pairs))

    def device_columns(self, pairs, Ldmax: int):
        """(cols, margins, oks) straight from the kernel."""
        return oa_columns(self.banks_t, self.bank_row, pairs, Ldmax=Ldmax)

    def aligned_columns_batch(self, pairs, Ldmax: int):
        """Columns per pair: the device kernel, then the native guard
        re-alignment of below-margin / failed-trace pairs."""
        if not pairs:
            return []
        t0 = time.time()
        k_ms, k_n = _build.KERNEL_MS["oa"], _build.LAUNCHES["oa"]
        cols, margins, oks = self.device_columns(pairs, Ldmax)
        k_ms = _build.KERNEL_MS["oa"] - k_ms
        k_n = _build.LAUNCHES["oa"] - k_n
        t1 = time.time()
        redo = [p for p in range(len(pairs))
                if not oks[p] or margins[p] < OA_GUARD]
        if redo:
            fixed = self.native_columns([pairs[p] for p in redo])
            for p, v in zip(redo, fixed):
                cols[p] = v
        Configs.runtime(
            "  align: %d pairs device posterior+OA %.2fs (kernel %.2f ms, "
            "%d launches; %d below-guard native re-aligns) (s): %f"
            % (len(pairs), t1 - t0, k_ms, k_n, len(redo), time.time() - t0))
        return cols


def validate_oa(aligner: DeviceAligner, pairs, Ldmax: int,
                sample: Optional[int] = None, seed: int = 0):
    """Compare device columns with the native f64 chain on (a sample of)
    pairs. Returns dict(n, mismatched, above_guard, redo, min_margin):
    `above_guard` counts mismatches the margin guard would NOT catch."""
    if sample is not None and sample < len(pairs):
        rng = np.random.default_rng(seed)
        pick = np.sort(rng.choice(len(pairs), sample, replace=False))
        pairs = [pairs[p] for p in pick]
    cols, margins, oks = aligner.device_columns(pairs, Ldmax)
    ref = aligner.native_columns(pairs)
    bad = [p for p in range(len(pairs))
           if not np.array_equal(np.asarray(ref[p]), np.asarray(cols[p]))]
    redo = {p for p in range(len(pairs))
            if not oks[p] or margins[p] < OA_GUARD}
    return dict(n=len(pairs), mismatched=len(bad),
                above_guard=len([p for p in bad if p not in redo]),
                redo=len(redo),
                min_margin=float(np.min(margins)) if len(pairs) else 0.0)


def align_all_queries(ens, qnames, qseqs, qcodes,
                      weights: Dict[str, tuple], backbone_length: int,
                      device, banks=None, use_weight: bool = True,
                      done: Optional[Dict[str, str]] = None,
                      checkpoint_cb=None, mode: str = "witch-ng"):
    """Returns (rows [(name, row)], ignored names). mode="old-witch"
    merges with the GCM/MCL path (ops/gcm.py) instead of the witch-ng
    banded DP."""
    done = done or {}
    selections, ignored = select_pairs(qnames, weights, use_weight)
    rows: List[Tuple[str, str]] = []
    todo = []
    for qname in qnames:
        if qname in done:
            rows.append((qname, done[qname]))
        elif qname in selections:
            todo.append(qname)
    name_to_i = {n: i for i, n in enumerate(qnames)}
    pair_list, keys = [], []
    for qname in todo:
        qi = name_to_i[qname]
        for idx, _ in selections[qname]:
            pair_list.append((idx, qcodes[qi]))
            keys.append((qname, idx))
    # scratch/trace bound from the whole query set, not the drawn pairs
    Ldmax = max((len(c) for c in qcodes), default=1)
    cols = DeviceAligner(ens, device, banks).aligned_columns_batch(
        pair_list, Ldmax) if pair_list else []
    cols_of = dict(zip(keys, cols))

    t0 = time.time()

    def per_hmm(qname):
        return [(cols_of[(qname, idx)], ens.retained_columns[idx],
                 ens.nongaps_per_column[idx], float(w))
                for idx, w in selections[qname]]

    def keep(qname, row):
        if not row:
            ignored.append(qname)
            return
        rows.append((qname, row))
        if checkpoint_cb:
            checkpoint_cb(qname, row)

    if mode == "old-witch":
        for qname, row in _gcm_rows(todo, per_hmm, qseqs, name_to_i,
                                    backbone_length):
            keep(qname, row)
    else:
        def merge_one(qname):
            return align_query_row(qseqs[name_to_i[qname]],
                                   backbone_length, per_hmm(qname))

        n_thr = max(1, min(8, int(getattr(Configs, "num_cpus", 4))))
        with ThreadPoolExecutor(max_workers=n_thr) as ex:
            for qname, row in zip(todo, ex.map(merge_one, todo)):
                keep(qname, row)
    Configs.runtime("  align: merge DP for %d queries (s): %f"
                    % (len(todo), time.time() - t0))
    return rows, ignored


def _gcm_rows(todo, per_hmm, qseqs, name_to_i, backbone_length):
    """old-witch merge, yielding (qname, row) in order: the loop of
    witch_tpu/aligner.py:449-500, copied (that module's aligner classes
    reach JAX). -s/--subset-size queries share one MCL clustering per
    batch; --timeout bounds each query's GCM merge, re-running it in
    witch-ng mode as the reference re-queues timed-out GCM tasks
    (witch_msa/gcmm/results_handler.py:167-180)."""
    from .ops.gcm import gcm_align_query_row
    from .ops.merge_dp import sparse_edges

    s_size = max(1, int(getattr(Configs, "subset_size", 1)))
    cluster = getattr(Configs, "graphclustermethod", "mcl")
    if cluster in ("mlrmcl", "rg"):
        Configs.warning("graphclustermethod %s not built; using mcl"
                        % cluster)
        cluster = "mcl"
    if getattr(Configs, "graphtracemethod", "minclusters") != "minclusters":
        Configs.log("graphtracemethod %s: all trace methods reduce to the "
                    "exact banded DP with two constraints"
                    % Configs.graphtracemethod)
    if getattr(Configs, "graphtraceoptimize", "false") == "true":
        Configs.log("graphtraceoptimize: trace is already optimal for "
                    "2-constraint merges; optimization is an identity")
    timeout = float(getattr(Configs, "timeout", 120) or 0)
    inflation = float(getattr(Configs, "inflation_factor", 4.0))
    for s0 in range(0, len(todo), s_size):
        batch = todo[s0:s0 + s_size]
        for qname in batch:
            qi = name_to_i[qname]
            ph = per_hmm(qname)
            t0 = time.time()
            row = gcm_align_query_row(
                qseqs[qi], backbone_length, ph, inflation=inflation,
                clustermethod=cluster,
                extra_edges=[sparse_edges(per_hmm(s))
                             for s in batch if s != qname])
            if timeout and time.time() - t0 > timeout:
                Configs.warning(
                    "query %s GCM merge exceeded --timeout %.0fs; "
                    "re-running in witch-ng mode" % (qname, timeout))
                row = align_query_row(qseqs[qi], backbone_length, ph)
            yield qname, row
