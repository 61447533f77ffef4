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

The scoring stage starts the aligner early (speculative_oa_start, the
counterpart of witch_tpu/aligner.py:speculative_oa_start): a thread runs
DeviceAligner.aligned_columns_batch on the pairs the pre-overlay scores
select while the host runs the exact-f32 print overlay; align_all_queries
joins it (SpeculativeOA.join), aligning the pairs whose selection drifted
on the native engine.

Spans (spans.py): align.oa (the aligner run by the align stage) or
spec_oa (its speculative thread; a child of the scoring stage's span),
each with oa.device (the kernel: its launches and ms are the outer
span's counters) and oa.redo (the native guard re-alignments); align.join
with align.join_wait and the selection-drift count; align.merge_dp.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import Configs
from .device import bank_to_torch
from .ensemble import Ensemble
from .hmm.profile import Profile, configure
from .ops.merge_dp import align_query_row
from .ops.oa import bank_strictly_positive, oa_columns
from .spans import current, span
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
        """Columns per pair: the device kernel (span oa.device), then the
        native guard re-alignment of below-margin / failed-trace pairs
        (span oa.redo, its pairs counted), inside the caller's span."""
        if not pairs:
            return []
        with span("oa.device"):
            cols, margins, oks = self.device_columns(pairs, Ldmax)
        redo = [p for p in range(len(pairs))
                if not oks[p] or margins[p] < OA_GUARD]
        with span("oa.redo", pairs=len(redo)):
            if redo:
                fixed = self.native_columns([pairs[p] for p in redo])
                for p, v in zip(redo, fixed):
                    cols[p] = v
        return cols


def _oa_text(sp) -> str:
    """An aligner run's part of its stage line, from its span (align.oa or
    spec_oa) and that span's parts."""
    return ("%d pairs device posterior+OA %.2fs (kernel %.2f ms, %d "
            "launches; %d below-guard native re-aligns)"
            % (sp.counters["pairs"], sp.child_seconds("oa.device"),
               sp.counters["kernel_ms"], sp.counters["launches"],
               sp.child("oa.redo").counters["pairs"]))


# speculative runs started and not yet joined
_PENDING: List["SpeculativeOA"] = []


def _pair_key(idx, codes):
    return int(idx), np.asarray(codes, np.int32).tobytes()


class SpeculativeOA:
    """The aligner started from the pre-overlay selection: a thread runs
    DeviceAligner.aligned_columns_batch on `pairs` (kernel, then the
    native guard) and caches the columns by (model, query codes)."""

    def __init__(self, aligner: DeviceAligner, pairs, Ldmax: int, device):
        self.aligner = aligner
        self.cache: Dict[tuple, np.ndarray] = {}
        self.error: Optional[BaseException] = None
        # the thread's span, spec_oa, a child of the span that starts it
        self.span = span("spec_oa", parent=current(), kernels="oa",
                         pairs=len(pairs))
        self.thread = threading.Thread(
            target=self._run, args=(pairs, Ldmax, device), daemon=True)
        self.thread.start()

    def _run(self, pairs, Ldmax, device):
        try:
            import torch
            with self.span, torch.cuda.device(device) \
                    if device.type == "cuda" else contextlib.nullcontext():
                cols = self.aligner.aligned_columns_batch(pairs, Ldmax)
            for (idx, c), v in zip(pairs, cols):
                self.cache[_pair_key(idx, c)] = v
        except BaseException as e:   # noqa: BLE001 - re-raised by join
            self.error = e

    def join(self, pairs) -> List[np.ndarray]:
        """Columns of the align stage's `pairs`: the cached ones, and the
        native engine's for pairs the speculative selection missed (the
        selection drifted with the overlay). Re-raises the thread's
        error."""
        with span("align.join", pairs=len(pairs)) as sp:
            with span("align.join_wait"):
                self.thread.join()
            if self in _PENDING:
                _PENDING.remove(self)
            if self.error is not None:
                raise self.error
            out = [self.cache.get(_pair_key(idx, c)) for idx, c in pairs]
            missing = [p for p, v in enumerate(out) if v is None]
            sp.counters["drift"] = len(missing)
            if missing:
                fixed = self.aligner.native_columns(
                    [pairs[p] for p in missing])
                for p, v in zip(missing, fixed):
                    out[p] = v
        Configs.runtime(
            "  align: %d pairs speculative device OA join (%d selection-drift "
            "host aligns) wait %.2fs; speculative thread %s %.2fs (s): %f"
            % (len(pairs), len(missing), sp.child_seconds("align.join_wait"),
               _oa_text(self.span), self.span.seconds, sp.seconds))
        return out


def speculative_oa_start(ens, device, banks, pairs, Ldmax: int) -> None:
    """Start the device aligner on a speculative pair selection in a
    thread (the scoring stage calls this before the exact-f32 overlay, so
    the kernel runs while the host overlays); align_all_queries joins it
    through ens._spec_oa."""
    aligner = DeviceAligner(ens, device, banks)
    ens._spec_oa = SpeculativeOA(aligner, pairs, Ldmax,
                                 aligner.banks_t[0].device)
    _PENDING.append(ens._spec_oa)


def wait_speculative() -> None:
    """Wait out the speculative threads that no join took (a run that
    stopped between their start and the align stage), so that none of
    their launches, kernel ms or device work falls into a later run."""
    while _PENDING:
        _PENDING.pop().thread.join()


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
    spec = getattr(ens, "_spec_oa", None)
    if spec is not None:
        ens._spec_oa = None
        cols = spec.join(pair_list)
    elif pair_list:
        aligner = DeviceAligner(ens, device, banks)
        with span("align.oa", kernels="oa", pairs=len(pair_list)) as sp:
            cols = aligner.aligned_columns_batch(pair_list, Ldmax)
        Configs.runtime("  align: %s (s): %f" % (_oa_text(sp), sp.seconds))
    else:
        cols = []
    cols_of = dict(zip(keys, cols))

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

    with span("align.merge_dp", queries=len(todo)) as sp:
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
                    % (len(todo), sp.seconds))
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
