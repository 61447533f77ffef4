"""Scenario A/B: backbone selection, alignment and tree from unaligned
input (counterpart of witch_tpu/backbone.py:BackboneJob).

Selection and the backbone aligners are the JAX package's host code
(select_backbone; align_backbone_consistency by default, or the
WITCH_TPU_BACKBONE backends "magus" and "iterhmm", which align on the
native engine through witch_tpu.backbone._align_all; they get
use_device=False and the engine is imported first, so a host without it
raises instead of reaching the JAX or numpy paths). The tree comes from
the port's tree_estimate (device distances). The opt-in device
pair-HMM embedding (WITCH_TPU_DEVICE_EMBED=1) is not ported and raises.
"""

from __future__ import annotations

import os
from typing import Optional

from witch_tpu.backbone import select_backbone
from witch_tpu.core.alphabet import infer_datatype
from witch_tpu.io.fasta import read_fasta, write_fasta

from .tree_estimate import estimate_tree


class BackboneJob:
    """Returns (backbone_aln_path, query_path, tree_path) from run()."""

    def __init__(self, input_path: str, outdir: str, device,
                 molecule: Optional[str] = None,
                 backbone_size: Optional[int] = None, seed: int = 0,
                 selection_strategy: Optional[str] = None,
                 method: Optional[str] = None, log=None):
        self.input_path = input_path
        self.outdir = outdir
        self.device = device
        self.molecule = molecule
        self.backbone_size = backbone_size or 1000
        self.selection_strategy = selection_strategy or "median_length"
        self.method = method or "pasta"
        self.seed = seed
        self.log = log or (lambda *_: None)

    def run(self):
        if os.environ.get("WITCH_TPU_DEVICE_EMBED", "") not in (
                "", "0", "false"):
            raise NotImplementedError(
                "WITCH_TPU_DEVICE_EMBED: the device pair-HMM embedding is "
                "not ported yet (ROADMAP.md, Queue 1: the opt-in device "
                "pair-HMM embedding)")
        records = [(n, s.upper()) for n, s in read_fasta(self.input_path)]
        if self.molecule is None:
            self.molecule = infer_datatype(records)
        os.makedirs(self.outdir, exist_ok=True)
        bb_path = os.path.join(self.outdir, "backbone.aln.fasta")
        q_path = os.path.join(self.outdir, "queries.fasta")
        tree_path = os.path.join(self.outdir, "backbone.tre")
        if os.path.exists(bb_path) and os.path.exists(q_path) and \
                os.path.exists(tree_path):
            self.log("Reusing existing backbone artifacts")
            return bb_path, q_path, tree_path
        backbone, queries = select_backbone(
            records, self.backbone_size, seed=self.seed,
            strategy=self.selection_strategy)
        self.log("Backbone: %d seqs; queries: %d"
                 % (len(backbone), len(queries)))
        names = [n for n, _ in backbone]
        seqs = [s for _, s in backbone]
        backend = os.environ.get(
            "WITCH_TPU_BACKBONE",
            "consistency" if self.method in ("magus", "pasta", "mafft")
            else "iterhmm")
        if backend != "consistency":
            # the backends' aligner; raises on a host without the engine
            from witch_tpu.native import _domaindef  # noqa: F401
        if backend == "consistency":
            from witch_tpu.backbone_consistency import \
                align_backbone_consistency
            aln = align_backbone_consistency(
                names, seqs, self.molecule, seed=self.seed,
                iters=2 if self.method == "pasta" else 1, log=self.log)
        elif backend == "magus":
            from witch_tpu.backbone_magus import align_backbone_magus
            aln = align_backbone_magus(names, seqs, self.molecule,
                                       cluster_size=10, use_device=False,
                                       log=self.log)
        else:
            from witch_tpu.backbone import align_backbone
            aln = align_backbone(names, seqs, self.molecule,
                                 use_device=False, log=self.log)
        aln.write(bb_path)
        write_fasta(queries, q_path)
        estimate_tree(aln, tree_path, self.device, ml=True, log=self.log)
        return bb_path, q_path, tree_path
