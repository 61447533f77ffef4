"""eHMM ensemble construction + decomposition artifacts.

Builds the ensemble of profile HMMs from a backbone alignment + tree
(reference DecompositionAlgorithm, witch_msa/gcmm/algorithm.py:32-197) and
manages reference-compatible on-disk artifacts (A_0_<i> directories with
hmmbuild.input/model and hmmsearch.results files) so --keep-decomposition
output from either implementation can be reused by the other.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core.alignment import PackedAlignment, subset_counts
from .core.alphabet import ALPHABETS
from .core.tree import Tree
from .hmm.build import (CoreHMM, hmm_counts, hmm_from_counts,
                        quantize_like_text)
from .io.hmmer_text import read_hmm, write_hmm
from .ops.effn import effn_all
from .spans import current, span


@dataclasses.dataclass
class Ensemble:
    """The eHMM: cores + per-subset backbone column bookkeeping."""
    cores: Dict[int, CoreHMM]                     # index -> quantized core
    retained_columns: Dict[int, np.ndarray]       # subset col -> backbone col
    nongaps_per_column: Dict[int, np.ndarray]
    backbone: PackedAlignment
    molecule: str

    @property
    def indices(self) -> List[int]:
        return sorted(self.cores)

    def sizes(self) -> Dict[int, int]:
        return {i: c.nseq for i, c in self.cores.items()}


def decompose_tree_file(tree_path: str, max_size: int,
                        min_size: int = 2) -> List[List[str]]:
    with open(tree_path) as f:
        tree = Tree.from_newick(f.read())
    tree.resolve_polytomies()
    return tree.decompose(max_size, min_size, hierarchical=True)


def _counts_one(args, parent=None):
    i, codes_bytes, shape, molecule, name = args
    with span("ensemble.counts", parent=parent, sequences=shape[0]):
        codes = np.frombuffer(codes_bytes, dtype=np.uint8).reshape(shape)
        return hmm_counts(codes, ALPHABETS[molecule])


def _finish_one(args, counts, effn, parent=None):
    i, _, shape, molecule, name = args
    with span("ensemble.model", parent=parent, sequences=shape[0]):
        core = hmm_from_counts(counts, effn, ALPHABETS[molecule], molecule,
                               name=name)
        return i, quantize_like_text(core)


def build_ensemble(backbone: PackedAlignment, tree_path: str,
                   alignment_size: int = 10,
                   upper_bound: Optional[int] = None,
                   molecule: str = "dna",
                   n_workers: int = 1, device=None) -> Ensemble:
    """The eHMM of `backbone` on the decomposition of its tree, each
    model's build split at its entropy weighting. Spans, children of the
    caller's open span: ensemble.decompose (the tree's subsets and their
    columns), ensemble.counts (a model's first half, hmm_counts),
    ensemble.effn (every model's bisection at once on `device`: one
    kernel launch on a CUDA device, the plain version elsewhere;
    ops/effn.py) and ensemble.model (a model's second half,
    hmm_from_counts); the halves run in a pool where n_workers > 1."""
    cores: Dict[int, CoreHMM] = {}
    retained: Dict[int, np.ndarray] = {}
    nongaps: Dict[int, np.ndarray] = {}
    jobs = []
    with span("ensemble.decompose") as sp:
        subsets = decompose_tree_file(tree_path, alignment_size)
        for i, leaves in enumerate(subsets):
            if upper_bound is not None and len(leaves) > upper_bound:
                continue
            rows, ret, ng = subset_counts(backbone, leaves)
            retained[i] = ret
            nongaps[i] = ng
            sub_codes = np.ascontiguousarray(backbone.codes[rows][:, ret])
            jobs.append((i, sub_codes.tobytes(), sub_codes.shape, molecule,
                         "A_0_%d" % i))
        sp.counters["models"] = len(jobs)
    parent = current()
    # threads, not processes: the numpy build releases the GIL in part,
    # and fork() after JAX initialization risks deadlocks
    pool = ThreadPoolExecutor(n_workers) \
        if n_workers > 1 and len(jobs) > 4 else None
    run = pool.map if pool is not None else map
    try:
        counts = list(run(_counts_one, jobs, [parent] * len(jobs)))
        with span("ensemble.effn", kernels="effn", models=len(jobs)) as sp:
            effn, redo = effn_all(counts, molecule, device or "cpu")
            sp.counters["device_models"] = len(jobs) - redo
            sp.counters["host_redo"] = redo
        for i, core in run(_finish_one, jobs, counts, effn,
                           [parent] * len(jobs)):
            cores[i] = core
    finally:
        if pool is not None:
            pool.shutdown()
    # subset row names needed for artifact writing
    ens = Ensemble(cores=cores, retained_columns=retained,
                   nongaps_per_column=nongaps, backbone=backbone,
                   molecule=molecule)
    ens._subsets = {i: subsets[i] for i in cores}  # type: ignore
    return ens


def write_decomposition(ens: Ensemble, root: str):
    """Write reference-compatible A_0_<i> artifact directories."""
    os.makedirs(root, exist_ok=True)
    for i, core in ens.cores.items():
        d = os.path.join(root, "A_0_%d" % i)
        os.makedirs(d, exist_ok=True)
        names = ens._subsets[i]  # type: ignore
        rows, ret, _ = subset_counts(ens.backbone, names)
        sub = PackedAlignment([ens.backbone.names[r] for r in rows],
                              ens.backbone.codes[rows][:, ret],
                              ens.backbone.alphabet)
        sub.write(os.path.join(d, "hmmbuild.input.A_0_%d.fasta" % i))
        write_hmm(core, os.path.join(d, "hmmbuild.model.A_0_%d" % i))


def write_search_results(root: str, index: int,
                         results: Dict[str, Tuple[float, float]]):
    """Write an hmmsearch.results.* file in the reference's literal-dict
    format (algorithm.py:579-605 rewrites outputs into python dicts)."""
    d = os.path.join(root, "A_0_%d" % index)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "hmmsearch.results.A_0_%d.fragment_chunk_0"
                        % index)
    with open(path, "w") as f:
        f.write(repr(results))


def read_search_results(hmmdir: str) -> Dict[int, Dict[str, Tuple[float,
                                                                  float]]]:
    """Load hmmsearch.results.* files (ours or the reference's) from a
    decomposition directory: {hmm_index: {taxon: (evalue, bitscore)}}.
    The reference writes these as python dict literals
    (witch_msa/gcmm/algorithm.py:579-605) and re-loads them in
    loader.readHMMSearch (witch_msa/gcmm/loader.py:286-297)."""
    import ast
    out: Dict[int, Dict[str, Tuple[float, float]]] = {}
    for p in glob.glob(os.path.join(hmmdir, "**", "hmmsearch.results.*"),
                       recursive=True):
        m = re.search(r"hmmsearch\.results\.A_0_(\d+)", os.path.basename(p))
        if not m:
            continue
        i = int(m.group(1))
        with open(p) as f:
            txt = f.read().strip()
        if not txt:
            continue
        d = ast.literal_eval(txt)
        cur = out.setdefault(i, {})
        for taxon, (ev, bits) in d.items():
            cur[taxon] = (float(ev), float(bits))
    return out


def read_ensemble_dir(hmmdir: str, backbone: PackedAlignment,
                      molecule: str) -> Ensemble:
    """Load a decomposition directory (ours or the reference's)."""
    cores: Dict[int, CoreHMM] = {}
    retained: Dict[int, np.ndarray] = {}
    nongaps: Dict[int, np.ndarray] = {}
    subsets: Dict[int, List[str]] = {}
    dirs = [p for p in glob.glob(os.path.join(hmmdir, "**", "A_0_*"),
                                 recursive=True) if os.path.isdir(p)]
    for d in dirs:
        m = re.match(r"A_0_(\d+)$", os.path.basename(d))
        if not m:
            continue
        i = int(m.group(1))
        models = glob.glob(os.path.join(d, "hmmbuild.model.*"))
        inputs = glob.glob(os.path.join(d, "hmmbuild.input.*"))
        if not models or not inputs:
            continue
        core = read_hmm(models[0])
        cores[i] = core
        sub = PackedAlignment.from_fasta(inputs[0], molecule=molecule)
        subsets[i] = sub.names
        _, ret, ng = subset_counts(backbone, sub.names)
        retained[i] = ret
        nongaps[i] = ng
    ens = Ensemble(cores=cores, retained_columns=retained,
                   nongaps_per_column=nongaps, backbone=backbone,
                   molecule=molecule)
    ens._subsets = subsets  # type: ignore
    return ens
