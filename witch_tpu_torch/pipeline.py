"""The WITCH pipeline on the GPU (the reference's mainAlignmentProcess,
witch_msa/gcmm/gcmm.py:93-267), ported from witch_tpu/pipeline.py.

Stages:
  1. backbone alignment and tree: given (scenario D), the tree estimated
     (scenario C, tree_estimate.py) or both made from unaligned input
     (scenario A, backbone.py) -> eHMM ensemble (host, ensemble.py)
     or a reused decomposition directory
  2. all-vs-all Forward pre-scores on the device (ops/forward.py), or
     over every visible card (the data mesh, parallel/mesh.py)
  3. candidate selection, then the reporting gate: envelope null2 on the
     device (hmm/gate_device.py), regions, trace ensembles and the exact
     f64 Forward on the native engine; or, with --full-search-results,
     the whole grid through the device flank prefilter
     (hmm/flank_device.py) and native domain definition; then the
     exact-f32 print overlay
  4. weights (weighting.py)
  5. per-query posterior+OA on the device (aligner.py) and the merge
     (witch-ng DP or old-witch GCM)
  6. transitive merge into the backbone; outputs

The JAX-free helpers of witch_tpu/pipeline.py (_encode_queries,
_native_args, _candidate_walk, GATE_SAFE, BIAS_FLOOR_BITS,
rank_and_weight, read_checkpoint, clear_temp_files) are copied here:
that module imports JAX at its top.
"""

from __future__ import annotations

import gzip
import os
import pickle
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from .config import Configs
from .core.alignment import PackedAlignment
from .core.alphabet import ALPHABETS, infer_datatype
from .device import bank_to_torch, cache_banks, resolve_device
from .ensemble import (Ensemble, build_ensemble, read_ensemble_dir,
                       read_search_results, write_decomposition,
                       write_search_results)
from .hmm.bank import build_banks
from .hmm.gate_device import evaluate_gate_device, near_print_boundary
from .io.fasta import read_fasta, write_fasta_bytes
from .merger import merge_rows_bytes
from .ops.forward import forward_bits
from .ops.overlay import overlay_scores
from .parallel.dist import (check_ranks, gather_rows, process_shard,
                            replaced, shard_indices, shard_job)
from .parallel.mesh import scoring_mesh, sharded_forward_bits
from .spans import span
from .weighting import calculate_weights, read_weights, write_weights

OMEGA = 1.0 / 256.0           # null2 prior weight (seqbias floor)
BIAS_FLOOR_BITS = float(np.log2(1.0 + OMEGA))
# every observed binary gate-drop sits below -1.7 bits, so pairs at
# >= GATE_SAFE bits are accepted without evaluation
GATE_SAFE = 0.0


def _encode_queries(path: str, alphabet):
    names, seqs, codes = [], [], []
    renamed = {}
    for i, (name, seq) in enumerate(read_fasta(path)):
        seq = seq.upper()
        if "/" in name:
            new = "renamed_query_{}".format(i)
            renamed[name] = new
            name = new
        names.append(name)
        seqs.append(seq)
        codes.append(alphabet.encode(seq))
    return names, seqs, codes, renamed


def _native_args(prof):
    """f64 contiguous (msc + transitions + bm) tuple for the native
    engine, cached on the profile."""
    a = getattr(prof, "_nat_args", None)
    if a is None:
        a = [np.ascontiguousarray(prof.msc, np.float64)] + \
            [np.ascontiguousarray(getattr(prof, x), np.float64)
             for x in ("t_mm", "t_mi", "t_md", "t_im", "t_ii",
                       "t_dm", "t_dd", "bm")]
        try:
            prof._nat_args = a
        except AttributeError:
            pass
    return a


def _candidate_walk(reported, valid, pre, evaluated, gate_ok,
                    size_arr, owned, TOPT):
    """Walk each query's candidates in weight-rank order, dropping
    gated pairs until num_hmms survivors are found (reference rank
    behavior). Returns the updated copy of `valid`."""
    out = valid.copy()
    adj_rep = reported + np.log2(size_arr)[None, :]
    for q in owned:
        top = np.argsort(-adj_rep[q], kind="stable")[:TOPT]
        accepted = 0
        for j in top:
            if pre[q, j] >= GATE_SAFE or not evaluated[q, j] \
                    or gate_ok[q, j]:
                accepted += 1
            else:
                out[q, j] = False
            if accepted >= Configs.num_hmms:
                break
    return out


def compute_scores(ens: Ensemble, qcodes: List[np.ndarray], device,
                   q_owned=None, mesh=None):
    """Forward-score every query against every ensemble HMM on the
    device, or over the cards of `mesh` (parallel/mesh.py: bit-identical
    scores), then gate and overlay the candidates on the device.

    Returns (scores [Q, H] rounded to 0.1 bit, valid [Q, H], indices,
    banks): valid=False where the reporting gate drops a candidate.
    q_owned (query sharding, parallel/dist.py): the host stages (gate,
    overlay, candidate walk, speculative start) run for these queries
    only, and the other rows must not be consumed; device scoring (and
    the full search's prefilter) stays whole-grid, as in the
    reference."""
    from .hmm.profile import configure, null1_score
    from .native import _domaindef, set_trace_alphabet

    indices = ens.indices
    set_trace_alphabet(ens.molecule)
    m_cap = int(os.environ.get("WITCH_TPU_MAX_HMM_STATES", "16384"))
    dropped = [i for i in indices if ens.cores[i].M > m_cap]
    if dropped:
        Configs.warning(
            "skipping %d/%d ensemble HMMs with M > %d states (max %d)"
            % (len(dropped), len(indices), m_cap,
               max(ens.cores[i].M for i in dropped)))
        indices = [i for i in indices if ens.cores[i].M <= m_cap]
        if not indices:
            raise SystemExit("ERROR: every ensemble HMM exceeds the "
                             "%d-state cap" % m_cap)
    cores = [ens.cores[i] for i in indices]

    with span("scoring.bank", models=len(cores)) as sp:
        banks = build_banks(cores, indices=indices, uniform=True,
                            n_buckets=2)
        cache_banks(len(banks), len(mesh) if mesh else 1)
        banks_t = [bank_to_torch(b, device) for b in banks]
        if mesh:
            # each bank once on each card (the primary card's is banks_t's)
            Configs.log("Scoring on %d-device data mesh" % len(mesh))
            mesh_t = [[bank_to_torch(b, d) for d in mesh] for b in banks]
    Configs.runtime("  scoring: bank build/quantize/upload (s): %f"
                    % sp.seconds)
    ev = getattr(Configs, "_art_gate_event", None)
    if ev is not None:
        ev.set()
    col_of = {idx: j for j, idx in enumerate(indices)}

    Q = len(qcodes)
    Lmax = max((len(c) for c in qcodes), default=1)
    codes = np.zeros((Q, Lmax), np.int32)
    lens = np.zeros(Q, np.int32)
    for i, c in enumerate(qcodes):
        codes[i, :len(c)] = c
        lens[i] = len(c)

    H = len(indices)
    owned = np.arange(Q) if q_owned is None else np.asarray(q_owned,
                                                            np.int64)
    pre = np.zeros((Q, H), np.float64)
    for bi, (b, bt) in enumerate(zip(banks, banks_t)):
        where = ""
        with span("scoring.forward", kernels="forward", H=bt.H, Q=Q) as sp:
            if mesh:
                bits, ms = sharded_forward_bits(mesh_t[bi], codes, lens)
                where = " on %d cards (kernel ms %s)" % (
                    len(mesh), ", ".join("%s %.2f" % (d, m)
                                         for d, m in zip(mesh, ms)))
            else:
                bits = forward_bits(bt, codes, lens)
            for j, idx in enumerate(b.hmm_indices):
                pre[:, col_of[int(idx)]] = bits[:, j]
        Configs.runtime("  scoring: device Forward Mp=%d H=%d (kernel %.2f "
                        "ms)%s (s): %f" % (bt.Mp, bt.H,
                                           sp.counters["kernel_ms"], where,
                                           sp.seconds))

    valid = np.ones((Q, H), bool)
    reported = pre - BIAS_FLOOR_BITS
    size_arr = np.array([ens.cores[i].nseq for i in indices], np.float64)
    TOPT = min(H, max(18, int(Configs.num_hmms) + 8))
    gate_ok = np.ones((Q, H), bool)
    evaluated = np.zeros((Q, H), bool)
    nthreads = max(1, min(8, Configs.num_cpus))
    x32 = getattr(_domaindef, "exact_scores32", None)
    mode32 = os.environ.get("WITCH_TPU_EXACT_PRINTS", "")
    band32: Dict[int, set] = {}
    band_of: Dict[tuple, float] = {}

    def consume(j, qlist, out, t):
        """Fold one evaluated pair into reported/gate_ok; returns
        (reported bits, print-guard band)."""
        nreg, nenv, sbias, fwdn, senv, sbsum, ld = out
        q = qlist[t]
        Lq = len(qcodes[q])
        null1 = null1_score(Lq)
        seq = (fwdn[t] - null1 - sbias[t]) / np.log(2.0)
        eps = 3e-4
        if ld[t] > 0:
            # p7_pipeline.c reconstruction-score substitution
            sum_nats = senv[t] + (Lq - ld[t]) * np.log(Lq / (Lq + 3.0))
            bias2 = np.logaddexp(0.0, np.log(1.0 / 256.0) + sbsum[t])
            sumsc = (sum_nats - null1 - bias2) / np.log(2.0)
            if abs(sumsc - seq) < 3e-3:
                eps = float("inf")
            if sumsc > seq:
                seq = sumsc
                eps = 3e-3
        reported[q, j] = seq
        gate_ok[q, j] = bool(nreg[t] > 0 and nenv[t] > 0)
        evaluated[q, j] = True
        if x32 is not None and mode32 != "0":
            band = max(2e-3, 4.5e-6 * Lq)
            if mode32 == "full" or eps == float("inf") \
                    or near_print_boundary(seq, band):
                band32.setdefault(j, set()).add(q)
                band_of[(q, j)] = band
        return seq, eps

    full = getattr(Configs, "full_search_results", False)
    if full:
        with span("scoring.gate"):
            drop = _full_search_gate(ens, indices, banks, banks_t, col_of,
                                     codes, lens, qcodes, consume, nthreads,
                                     owned)
    else:
        # candidate selection: each query's weight-rank top candidates
        # (see witch_tpu/pipeline.py:compute_scores for the rationale)
        adj = pre + np.log2(size_arr)[None, :]
        NEAR = min(H, int(Configs.num_hmms) + 4)
        with span("scoring.gate") as gate:
            with span("gate.select"):
                by_j: Dict[int, List[int]] = {}
                for q in owned:
                    top = np.argsort(-adj[q], kind="stable")[:TOPT]
                    depth = NEAR if np.all(pre[q, top[:NEAR]] >= GATE_SAFE) \
                        else TOPT
                    for j in top[:depth]:
                        by_j.setdefault(int(j), []).append(q)
            _device_gate(ens, indices, banks, banks_t, col_of, qcodes, by_j,
                         consume, nthreads, gate)
        Configs.runtime(_gate_line(gate))
        # speculative alignment: the OA kernel runs on the pre-overlay
        # selection while the host runs the overlay below; the overlay
        # moves scores by <= ~6e-3 bits, so the final selection almost
        # always matches, and the align stage aligns drifted pairs on
        # the native engine (aligner.py:SpeculativeOA.join)
        spec_on = os.environ.get("WITCH_TPU_SPEC_OA", "") != "0"
        if spec_on:
            with span("scoring.spec_select") as sp:
                spec_pairs = _speculative_pairs(
                    ens, indices, qcodes, reported, valid, pre, evaluated,
                    gate_ok, size_arr, owned, TOPT)
                sp.counters["pairs"] = len(spec_pairs)
            if spec_pairs:
                from .aligner import speculative_oa_start
                Ldmax = max((len(c) for c in qcodes), default=1)
                speculative_oa_start(ens, device, banks, spec_pairs, Ldmax)

    # ---- exact-f32 print overlay (print-boundary pairs): the native
    # engine split at its libm calls, its launches on the card or on the
    # host engine ----
    if band32:
        n32 = ok32 = 0
        band_cover = 0.0
        with span("scoring.overlay", kernels="overlay") as overlay:
            items = [(j, sorted(qset)) for j, qset in sorted(band32.items())]
            jobs = [(_native_args(configure(ens.cores[int(indices[j])],
                                            multihit=True)),
                     [np.ascontiguousarray(qcodes[q], np.int32)
                      for q in qlist]) for j, qlist in items]
            okl, seql, _ = overlay_scores(jobs, device,
                                          ALPHABETS[ens.molecule].K,
                                          nthreads, overlay)
            for (j, qlist), okx, seqx in zip(items, okl, seql):
                for t, q in enumerate(qlist):
                    n32 += 1
                    if okx[t]:
                        ok32 += 1
                        b = band_of.get((q, j))
                        if b:
                            d = abs(float(seqx[t]) - reported[q, j])
                            band_cover = max(band_cover, d / b)
                        reported[q, j] = float(seqx[t])
            overlay.counters["pairs"] = n32
        Configs.runtime("  scoring: exact-f32 print overlay %d/%d pairs "
                        "(band cover %.2f) (s): %f"
                        % (ok32, n32, band_cover, overlay.seconds))
        if band_cover >= 1.0 and mode32 != "full":
            Configs.warning(
                "exact-f32 overlay: observed |f32-f64| delta (%.1fx band) "
                "exceeds the empirical candidate band on this data; rerun "
                "with WITCH_TPU_EXACT_PRINTS=full for guaranteed "
                "print-exactness" % band_cover)
    with span("scoring.walk"):
        if full:
            # every pair was evaluated: valid is the complete reported set
            valid = gate_ok.copy()
            valid[drop] = False
        else:
            valid = _candidate_walk(reported, valid, pre, evaluated,
                                    gate_ok, size_arr, owned, TOPT)
    return np.round(reported, 1), valid, indices, banks


def _speculative_pairs(ens, indices, qcodes, reported, valid, pre,
                       evaluated, gate_ok, size_arr, owned, TOPT):
    """The (model, query codes) pairs the align stage would draw from the
    pre-overlay scores: rounded to 0.1 bit, the candidate walk, weights,
    then each owned query's adaptive top models (the selection of
    witch_tpu/pipeline.py:676-698)."""
    from .weighting import adaptive_top_hmms
    rep = np.round(reported, 1)
    valid_spec = _candidate_walk(rep, valid, pre, evaluated, gate_ok,
                                 size_arr, owned, TOPT)
    weights = rank_and_weight(rep, valid_spec, indices, ens.sizes(),
                              list(range(len(qcodes))))
    pairs = []
    for q in owned:
        for idx, _ in adaptive_top_hmms(weights.get(int(q), ()),
                                        use_weight=Configs.use_weight):
            pairs.append((int(idx), np.ascontiguousarray(qcodes[q],
                                                         np.int32)))
    return pairs


def _full_search_gate(ens, indices, banks, banks_t, col_of, codes, lens,
                      qcodes, consume, nthreads, owned):
    """--full-search-results: the device flank prefilter classifies the
    whole grid; the owned queries' pairs with a region run native domain
    definition on the device's rows (evaluate_targets_rows, f64 Forward
    included). The device null2 gate is not used here
    (witch_tpu/pipeline.py:528-535). Returns drop [Q, H] (the pairs the
    prefilter found no region in)."""
    from .hmm.flank_device import prefilter_grid
    from .hmm.profile import configure
    from .native import _domaindef

    Q, H = len(qcodes), len(indices)
    with span("gate.prefilter", kernels="flank") as sp:
        dec, rows = prefilter_grid(
            banks_t, [[col_of[int(idx)] for idx in b.hmm_indices]
                      for b in banks], codes, lens, H)
        drop = dec < 0
    Configs.runtime("  scoring: device gate prefilter dropped %d/%d pairs "
                    "(flank kernel %.2f ms, %d launches) (s): %f"
                    % (int(drop.sum()), Q * H, sp.counters["kernel_ms"],
                       sp.counters["launches"], sp.seconds))
    if len(owned) < Q:
        # a shard evaluates its own queries' pairs (witch_tpu/pipeline.py:
        # 389-391)
        mine = np.zeros(Q, bool)
        mine[owned] = True
        rows = {j: tuple(x[mine[r[0]]] for x in r) for j, r in rows.items()}
        rows = {j: r for j, r in rows.items() if len(r[0])}
    by_j = {j: [int(q) for q in rows[j][0]] for j in sorted(rows)}
    n_pairs = 0
    with span("gate.domaindef") as dd:

        def eval_model(j):
            qs, mo, pb, pe = rows[j]
            with span("domaindef.model", parent=dd, pairs=len(qs)):
                args = _native_args(configure(ens.cores[int(indices[j])],
                                              multihit=True))
                cl = [np.ascontiguousarray(qcodes[q], np.int32) for q in qs]
                return j, _domaindef.evaluate_targets_rows(
                    *args, cl, 42, 200, 1, 1, mo, pb, pe, 1)

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            for j, out in ex.map(eval_model, sorted(rows)):
                n_pairs += len(by_j[j])
                for t in range(len(by_j[j])):
                    consume(j, by_j[j], out, t)
        dd.counters["pairs"] = n_pairs
    Configs.runtime("  scoring: native domaindef %d pairs (s): %f"
                    % (n_pairs, dd.seconds))
    return drop


def _device_gate(ens, indices, banks, banks_t, col_of, qcodes, by_j,
                 consume, nthreads, gate):
    """The candidate pairs' reporting gate, inside its span `gate`: flank
    rows (native AVX-512 scan), f64 Forward (native, in a side thread),
    envelope null2 (device), then the print-boundary re-evaluations. The
    gate's numbers go to the span's counters (_gate_line)."""
    from .hmm.profile import configure
    from .native import _domaindef

    # the gate's flank rows come from the native AVX-512 scan; the port
    # has no host fallback for it
    flank_fn = getattr(_domaindef, "flank_targets_simd", None)
    if flank_fn is None:
        raise RuntimeError(
            "the reporting gate needs a host CPU with AVX-512: the native "
            "engine was built without flank_targets_simd, and witch_tpu_torch "
            "has no fallback for it")
    items = sorted(by_j.items())
    allargs, flank_rows, codes_by, fwd64_by = {}, {}, {}, {}

    with span("gate.prep") as prep:

        def prep_model(item):
            j, qlist = item
            with span("gate.flank", parent=prep, pairs=len(qlist)):
                args = _native_args(configure(ens.cores[int(indices[j])],
                                              multihit=True))
                cl = [np.ascontiguousarray(qcodes[q], np.int32)
                      for q in qlist]
                _, mo, pb, pe = flank_fn(*args, cl, 1)
            return j, args, (mo, pb, pe), cl

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            for j, args, rows3, cl in ex.map(prep_model, items):
                allargs[j] = args
                flank_rows[j] = rows3
                codes_by[j] = cl
    f64_exc = []

    def run_f64():
        try:
            with span("gate.f64", parent=gate) as side:
                def one(item):
                    j, qlist = item
                    with span("f64.model", parent=side, pairs=len(qlist)):
                        return j, np.asarray(_domaindef.forward_targets_exact(
                            *allargs[j], codes_by[j], 1))
                with ThreadPoolExecutor(max_workers=nthreads) as ex:
                    for j, f64 in ex.map(one, items):
                        fwd64_by[j] = f64
        except BaseException as e:   # noqa: BLE001 - re-raised below
            f64_exc.append(e)

    f64_thread = threading.Thread(target=run_f64, daemon=True)
    f64_thread.start()
    bankloc_of_col = {col_of[int(idx)]: (bi, r)
                      for bi, b in enumerate(banks)
                      for r, idx in enumerate(b.hmm_indices)}
    results, stats = evaluate_gate_device(
        banks_t, bankloc_of_col, allargs, qcodes, by_j, flank_rows,
        nthreads=nthreads)
    with span("gate.f64_wait"):
        f64_thread.join()
    if f64_exc:
        raise f64_exc[0]
    n_pairs = 0
    pending: Dict[int, List[int]] = {}
    with span("gate.fold"):
        for j, qlist in items:
            n_pairs += len(qlist)
            out = list(results[j])
            out[3] = fwd64_by[j]
            hmulti = stats["multi_flags"][j]
            for t in range(len(qlist)):
                seq, eps = consume(j, qlist, out, t)
                if not hmulti[t] and (eps == float("inf")
                                      or near_print_boundary(seq, eps)):
                    pending.setdefault(j, []).append(t)
    n_pend = sum(len(v) for v in pending.values())
    for j, plist in pending.items():
        stats["reeval"](j, plist)
        out = list(results[j])
        out[3] = fwd64_by[j]
        for t in plist:
            consume(j, by_j[j], out, t)
    gate.counters.update(pairs=n_pairs, envelopes=stats["entries"],
                         multidomain=stats["multi"],
                         margin_reevals=stats["guard_margin"],
                         boundary_reevals=n_pend)


def _gate_line(gate):
    """The device gate's stage line, from its span and its parts' spans:
    candidate selection and the flank prep pool (prep), the null2 device
    thread (its kernel's ms and launches), the host multidomain pool
    beside it and the wait for that thread after the pool."""
    c = gate.counters
    null2 = gate.child("gate.null2")
    return ("  scoring: device gate %d pairs (%d env on device, %d "
            "multidomain host, %d margin + %d boundary re-evals) prep %.2fs "
            "null2 %.2fs (kernel %.1f ms, %d launches) multi host %.2fs wait "
            "%.2fs total (s): %f"
            % (c["pairs"], c["envelopes"], c["multidomain"],
               c["margin_reevals"], c["boundary_reevals"],
               gate.child_seconds("gate.select")
               + gate.child_seconds("gate.prep"), null2.seconds,
               null2.counters["kernel_ms"], null2.counters["launches"],
               gate.child_seconds("gate.multidomain"),
               gate.child_seconds("gate.wait"), gate.seconds))


def rank_and_weight(scores: np.ndarray, valid: np.ndarray,
                    indices: List[int], sizes: Dict[int, int],
                    qnames: List[str]) -> Dict[str, tuple]:
    """Ranked bitscores -> per-query weight tuples (reference
    rankBitscores + writeWeights)."""
    out = {}
    size_arr = np.array([sizes[i] for i in indices], dtype=np.float64)
    for q, name in enumerate(qnames):
        v = np.flatnonzero(valid[q])
        if v.size == 0:
            continue
        order = v[np.argsort(-scores[q, v], kind="stable")]
        idxs = [indices[j] for j in order]
        if Configs.use_weight:
            w = calculate_weights(
                idxs, scores[q, order], size_arr[order], Configs.num_hmms)
            adj = Configs.weight_adjust
            if adj != "none" and w:
                vals = np.array([x for _, x in w], np.float64)
                den = vals.sum() if adj == "normalize" else vals.max()
                if den > 0:
                    w = tuple((i, float(x / den))
                              for (i, _), x in zip(w, vals))
            out[name] = w
        else:
            k = min(Configs.num_hmms, len(order))
            out[name] = tuple((idxs[t], float(scores[q, order[t]]))
                              for t in range(k))
    return out


def align_queries(ens: Ensemble, qnames, qseqs, qcodes,
                  weights: Dict[str, tuple], backbone_length: int, device,
                  banks=None, checkpoint_path: Optional[str] = None,
                  done: Optional[Dict[str, str]] = None):
    """Per-query adaptive alignment + merge (reference
    alignSubQueriesNew). Returns (rows [(name, row)], ignored names)."""
    from .aligner import align_all_queries

    def checkpoint_cb(qname, row):
        if checkpoint_path:
            with gzip.open(checkpoint_path, "ab") as f:
                f.write("{}\t{}\n".format(qname, row).encode("utf-8"))

    return align_all_queries(ens, qnames, qseqs, qcodes, weights,
                             backbone_length, device, banks=banks,
                             use_weight=Configs.use_weight, done=done,
                             checkpoint_cb=checkpoint_cb, mode=Configs.mode)


def read_checkpoint(path: str) -> Dict[str, str]:
    out = {}
    if os.path.exists(path) and os.stat(path).st_size > 0:
        with gzip.open(path, "rb") as f:
            for line in f.read().decode("utf-8").split("\n"):
                if not line:
                    continue
                taxon = "\t".join(line.split("\t")[:-1])
                out[taxon] = line.split("\t")[-1]
    return out


def main_alignment_process(device=None):
    """The WITCH pipeline end to end (scenarios A, C and D; witch-ng or
    old-witch). `device` defaults to CUDA (raises without it); pass
    device="cpu" to run the kernels' plain versions. Given no card index
    (None or "cuda"), an unsharded run scores over every visible card
    (parallel/mesh.py:scoring_mesh; WITCH_TPU_NO_MESH=1 keeps it on one)
    and runs the rest on the current card. A speculative OA
    run that the align stage did not join (the run stopped earlier) is
    waited out before this returns or raises. The run is one job of
    spans (spans.py): its root, `job`, is open for the whole run, and its
    duration is the last line, Total runtime."""
    from .aligner import wait_speculative
    with span("job") as job:
        try:
            out = _alignment_process(device, job)
        finally:
            wait_speculative()
    Configs.runtime("Total runtime (s): %f" % job.seconds)
    return out


def _write_decomposition(ens, root, parent, gate_event=None):
    """The decomposition writer's thread: waits for `gate_event` (where
    given: the scoring stage sets it once the banks are built), then
    writes `ens`'s artifact directories under `root`."""
    with span("writer", parent=parent, models=len(ens.cores)):
        if gate_event is not None:
            with span("writer.wait"):
                gate_event.wait(timeout=60.0)
        write_decomposition(ens, root)


def _found_dir() -> bool:
    """Whether Configs.hmmdir holds a decomposition to reuse."""
    return os.path.isdir(Configs.hmmdir) and any(
        d.startswith("A_0_") for d in os.listdir(Configs.hmmdir))


def _shard_start(shard, n_shards):
    """A shard's first steps: rank i > 0 writes its stage lines to
    runtime_breakdown.rank<i>.txt (rank 0's file is the job's); a rank
    pool's rank 0 (server.py) looks for a decomposition to reuse, for
    every rank, then starts the other ranks where it must and hands them
    the job, in span `shards`."""
    if shard > 0:
        Configs.runtime_path = os.path.join(
            Configs.outdir, "runtime_breakdown.rank%d.txt" % shard)
    sj = shard_job()
    if sj is None or sj.dispatch is None:
        return
    sj.have_dir = _found_dir()
    with span("shards", ranks=n_shards) as sp:
        sp.counters.update(sj.start())
        with span("shards.dispatch"):
            sj.dispatch()
    Configs.runtime("Time to dispatch job to %d shard ranks (s): %f"
                    % (n_shards, sp.seconds))


def _ensemble_bytes(ens) -> bytes:
    """An ensemble as bytes for another rank, which has the backbone."""
    return pickle.dumps((ens.cores, ens.retained_columns,
                         ens.nongaps_per_column, ens.molecule,
                         ens._subsets), protocol=pickle.HIGHEST_PROTOCOL)


def _ensemble_from(blob: bytes, backbone) -> Ensemble:
    cores, retained, nongaps, molecule, subsets = pickle.loads(blob)
    ens = Ensemble(cores=cores, retained_columns=retained,
                   nongaps_per_column=nongaps, backbone=backbone,
                   molecule=molecule)
    ens._subsets = subsets  # type: ignore
    return ens


def _persist(indices, qnames, scores, valid):
    """The hmmsearch.results.* files of the rounded scores, one a model
    (the reference's persisted search results)."""
    with span("persist", models=len(indices)) as sp:
        for j, idx in enumerate(indices):
            res = {qnames[q]: (0.0, float(scores[q, j]))
                   for q in np.flatnonzero(valid[:, j])}
            write_search_results(Configs.hmmdir, int(idx), res)
    Configs.runtime("Time to persist hmmsearch results (s): %f"
                    % sp.seconds)


def _alignment_process(device, job):
    shard, n_shards = process_shard()
    mesh = scoring_mesh(device, n_shards)
    device = resolve_device(device)
    if not Configs.hmmdir:
        Configs.hmmdir = os.path.join(Configs.outdir, "tree_decomp", "root")
    if n_shards > 1:
        _shard_start(shard, n_shards)
    # the cards this run scores on (a server's .done records them)
    Configs.scoring_cards = [str(d) for d in (mesh or [device])]
    molecule = Configs.molecule
    if molecule is None:
        src = (Configs.backbone_path or Configs.query_path
               or Configs.input_path)
        molecule = infer_datatype(read_fasta(src, remove_gaps=True))
        Configs.log("Inferred molecule type: {}".format(molecule))
    alphabet = ALPHABETS[molecule]

    if not (Configs.backbone_path and os.path.exists(Configs.backbone_path)):
        # scenario A/B: split the input into backbone and queries, align
        # the backbone, estimate its tree (witch_tpu/pipeline.py:873-894)
        if not (Configs.input_path and os.path.exists(Configs.input_path)):
            raise FileNotFoundError(
                "need -i (unaligned input) or -b (backbone alignment)")
        from .backbone import BackboneJob
        with span("backbone") as sp:
            bb_job = BackboneJob(
                Configs.input_path, os.path.join(Configs.outdir, "backbone"),
                device, molecule=molecule,
                backbone_size=Configs.backbone_size,
                selection_strategy=Configs.selection_strategy,
                method=Configs.backbone_method, log=Configs.log)
            bb_path, q_path, tree_path = bb_job.run()
        Configs.backbone_path = bb_path
        if not Configs.query_path:
            Configs.query_path = q_path
        if not Configs.backbone_tree_path:
            Configs.backbone_tree_path = tree_path
        Configs.runtime("Time for backbone job (s): %f" % sp.seconds)
    if not (Configs.query_path and os.path.exists(Configs.query_path)):
        raise FileNotFoundError("query sequences missing (-q)")

    backbone = PackedAlignment.from_fasta(Configs.backbone_path,
                                          molecule=molecule)
    backbone_length = backbone.n_cols

    art_thread = None
    # a rank pool's ranks take rank 0's finding, made before any rank ran:
    # then rank 0 may write the decomposition while the others run
    sj = shard_job()
    pooled = sj is not None and sj.have_dir is not None
    have_dir = sj.have_dir if pooled else _found_dir()
    with span("ensemble") as sp:
        if have_dir:
            Configs.log("Found existing HMM directory: %s" % Configs.hmmdir)
            with span("ensemble.read"):
                ens = read_ensemble_dir(Configs.hmmdir, backbone, molecule)
        elif pooled and shard > 0:
            # a rank pool's rank 0 builds the ensemble (every rank would
            # build the same one, at once) and sends it
            with span("ensemble.receive"):
                ens = _ensemble_from(sj.recv_ensemble(), backbone)
        else:
            if not (Configs.backbone_tree_path
                    and os.path.exists(Configs.backbone_tree_path)):
                # scenario C: estimate the backbone tree (device distances,
                # host NJ + NNI + ML refinement)
                from .tree_estimate import estimate_tree
                tree_dir = os.path.join(Configs.outdir, "tree_decomp")
                os.makedirs(tree_dir, exist_ok=True)
                tree_path = os.path.join(tree_dir, "backbone.est.tre")
                with span("ensemble.tree") as tree_sp:
                    with replaced(tree_path) as tmp:
                        estimate_tree(backbone, tmp, device, ml=True,
                                      log=Configs.log)
                Configs.runtime("Time to estimate backbone tree (s): %f"
                                % tree_sp.seconds)
                Configs.log("Estimated backbone tree (NJ): %s" % tree_path)
                Configs.backbone_tree_path = tree_path
            ens = build_ensemble(backbone, Configs.backbone_tree_path,
                                 Configs.alignment_size,
                                 Configs.alignment_upper_bound, molecule,
                                 n_workers=min(Configs.num_cpus,
                                               Configs.max_concurrent_jobs),
                                 device=device)
            if pooled:
                sj.send_ensemble(_ensemble_bytes(ens))
            if Configs.keep_decomposition and (n_shards == 1 or (
                    pooled and shard == 0)):
                # artifact writes overlap the scoring stage (nothing reads
                # them back in this run); released once the banks are
                # built. Sharded otherwise, the merging process writes them
                # after the gather, so no shard reads a sibling's directory
                # half-written
                Configs._art_gate_event = threading.Event()
                art_thread = threading.Thread(
                    target=_write_decomposition,
                    args=(ens, Configs.hmmdir, job, Configs._art_gate_event),
                    daemon=True)
                art_thread.start()
    Configs.runtime("Time to obtain eHMM ensemble (s): %f" % sp.seconds)
    Configs.log("Ensemble of %d HMMs" % len(ens.cores))
    check_ranks()

    tmp_bb_dir = os.path.join(Configs.outdir, "tree_decomp", "backbone")
    os.makedirs(tmp_bb_dir, exist_ok=True)
    with replaced(os.path.join(tmp_bb_dir, "backbone.aln.fasta")) as tmp:
        backbone.write(tmp)

    qnames, qseqs, qcodes, renamed = _encode_queries(Configs.query_path,
                                                     alphabet)
    Configs.log("Loaded %d queries" % len(qnames))
    job.counters["fragments"] = len(qnames)
    # query sharding (parallel/dist.py): this process gates and aligns
    # its own contiguous block of queries; the rows are gathered to one
    # process for the merge
    q_owned = None
    if n_shards > 1:
        q_owned = shard_indices(len(qnames), shard, n_shards)
        Configs.log("Query shard %d/%d: owns %d/%d queries [%s..%s)"
                    % (shard, n_shards, len(q_owned), len(qnames),
                       q_owned[0] if len(q_owned) else "-",
                       q_owned[-1] + 1 if len(q_owned) else "-"))

    # weights: reuse weights.txt, then persisted search results, then
    # score on the device (the reference's resume ladder)
    banks = None
    # sharded: the owned rows' weights and scores, for the merger to
    # write weights.txt and the search results as the unsharded run does
    own_weights = own_scores = None
    weight_path = os.path.join(Configs.outdir, "weights.txt")
    if os.path.exists(weight_path):
        Configs.log("Found existing weights: %s" % weight_path)
        weights = read_weights(weight_path)
    else:
        scores = valid = None
        if have_dir:
            with span("load_results") as sp:
                search = read_search_results(Configs.hmmdir)
                if search and set(search) == set(ens.indices):
                    Configs.log("Reusing %d hmmsearch result files from %s"
                                % (len(search), Configs.hmmdir))
                    indices = ens.indices
                    name_to_q = {n: q for q, n in enumerate(qnames)}
                    scores = np.full((len(qnames), len(indices)), -np.inf)
                    valid = np.zeros(scores.shape, bool)
                    for j, idx in enumerate(indices):
                        for taxon, (_, bits) in search[idx].items():
                            q = name_to_q.get(taxon)
                            if q is not None:
                                scores[q, j] = bits
                                valid[q, j] = True
            if scores is not None:
                Configs.runtime("Time to load hmmsearch results (s): %f"
                                % sp.seconds)
        if scores is None:
            with span("scoring") as sp:
                scores, valid, indices, banks = compute_scores(
                    ens, qcodes, device, q_owned=q_owned, mesh=mesh)
            Configs.runtime("Time for all-vs-all Forward scoring (s): %f"
                            % sp.seconds)
            check_ranks()
            if art_thread is not None:
                with span("writer.join"):
                    art_thread.join()
                art_thread = None
            if Configs.keep_decomposition and n_shards > 1:
                own_scores = (scores[q_owned], valid[q_owned])
            elif Configs.keep_decomposition \
                    and os.path.isdir(Configs.hmmdir):
                _persist(indices, qnames, scores, valid)
        with span("weights") as sp:
            # sharded, only the owned rows were gate-evaluated here
            w_rows = np.arange(len(qnames)) if q_owned is None else q_owned
            weights = rank_and_weight(scores[w_rows], valid[w_rows],
                                      indices, ens.sizes(),
                                      [qnames[q] for q in w_rows])
        Configs.runtime("Time to obtain weights (s): %f" % sp.seconds)
        if Configs.save_weight and n_shards > 1:
            own_weights = weights
        elif Configs.save_weight:
            write_weights(weights, weight_path)

    ckpt_name = ("checkpoint_alignments.txt.gz" if n_shards == 1 else
                 "checkpoint_alignments.shard%d_of_%d.txt.gz"
                 % (shard, n_shards))
    checkpoint_path = os.path.join(Configs.outdir, ckpt_name)
    done = read_checkpoint(checkpoint_path)
    a_q = range(len(qnames)) if q_owned is None else q_owned
    with span("align") as sp:
        rows, ignored = align_queries(
            ens, [qnames[q] for q in a_q], [qseqs[q] for q in a_q],
            [qcodes[q] for q in a_q], weights, backbone_length, device,
            banks=banks, checkpoint_path=checkpoint_path, done=done)
    Configs.runtime("Time for per-query alignment (s): %f" % sp.seconds)

    if n_shards > 1:
        # every shard's rows, in shard order (= query order, so the merged
        # files are the unsharded run's); one process goes on to merge
        sj = shard_job()
        with span("gather") as sp:
            gathered = gather_rows(rows, ignored, shard, n_shards,
                                   os.path.join(Configs.outdir, "shards"),
                                   (own_weights, own_scores))
            walls = sj.walls if sj is not None else None
            if walls:
                sp.counters.update(rank_wall_max_ms=1e3 * max(walls),
                                   rank_wall_min_ms=1e3 * min(walls))
        if walls:
            Configs.runtime("  shards: rank walls min .. max (s): %f .. %f"
                            % (min(walls), max(walls)))
        Configs.runtime("Time to gather shard rows (s): %f" % sp.seconds)
        if gathered is None:
            Configs.log("Shard %d/%d: rows staged; merge owned by another "
                        "process" % (shard, n_shards))
            return None
        rows, ignored, extras = gathered
        if Configs.keep_decomposition and not have_dir and not pooled:
            art_thread = threading.Thread(
                target=_write_decomposition,
                args=(ens, Configs.hmmdir, job), daemon=True)
            art_thread.start()
        if own_weights is not None:
            # the blocks are contiguous and in shard order: query order
            merged = {}
            for w, _ in extras:
                merged.update(w)
            write_weights(merged, weight_path)
        if own_scores is not None:
            _persist(indices, qnames,
                     np.concatenate([s for _, (s, _) in extras]),
                     np.concatenate([v for _, (_, v) in extras]))

    back = {v: k for k, v in renamed.items()}
    with span("merge") as sp:
        mnames, mmat, ins_mask = merge_rows_bytes(
            backbone.names, backbone.to_bytes_matrix(), rows,
            collapse_singletons=Configs.collapse_singletons)
        mnames = [back.get(n, n) for n in mnames]
        write_fasta_bytes(mnames, mmat, Configs.output_path)
        suffix = Configs.output_path.split(".")[-1]
        if suffix in ("fa", "fasta"):
            masked_path = (".".join(Configs.output_path.split(".")[:-1])
                           + ".masked." + suffix)
        else:
            masked_path = Configs.output_path + ".masked.fasta"
        write_fasta_bytes(mnames, mmat[:, ~ins_mask], masked_path)
    Configs.runtime("Time to merge all outputs (s): %f" % sp.seconds)

    if ignored:
        ignored_path = os.path.join(Configs.outdir, "ignored_queries.fasta")
        seq_of = dict(zip(qnames, qseqs))
        with open(ignored_path, "w") as f:
            for n in ignored:
                f.write(">{}\n{}\n".format(back.get(n, n), seq_of[n]))
        Configs.log("Wrote %d ignored queries to %s"
                    % (len(ignored), ignored_path))
    if art_thread is not None:
        with span("writer.join"):
            art_thread.join()
    clear_temp_files()
    Configs.log("WITCH-TPU (torch) finished; output: %s"
                % Configs.output_path)
    return Configs.output_path


def clear_temp_files():
    """Remove working artifacts after a successful run (the reference's
    clearTempFiles, witch_msa/gcmm/gcmm.py:39-69): the shards' staged rows
    always, the whole tree_decomp tree with --keep-decomposition 0, else
    its uppercased backbone copy (unless --keeptemp)."""
    import shutil
    if Configs.keeptemp:
        return
    td = os.path.join(Configs.outdir, "tree_decomp")
    targets = [os.path.join(Configs.outdir, "shards")]
    targets.append(td if not Configs.keep_decomposition else
                   os.path.join(td, "backbone"))
    for t in targets:
        if os.path.isdir(t):
            try:
                shutil.rmtree(t)
            except OSError as e:
                Configs.warning("temp cleanup failed for %s: %s" % (t, e))
