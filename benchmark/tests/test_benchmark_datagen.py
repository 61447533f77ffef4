"""The frozen generator makes scripts/make_scale_dataset.py's backbone and
tree byte for byte, and a run's fragments are a function of its seed."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import datagen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("n,cols,seed", [(1000, 1536, 20260820),
                                         (200, 8000, 20261017)],
                         ids=["dna1k", "n200_cols8000"])
def test_backbone_is_the_script_s(tmp_path, n, cols, seed):
    out = tmp_path / "script"
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "scripts", "make_scale_dataset.py"),
                    "--n", str(n), "--cols", str(cols), "--seed", str(seed),
                    "--queries", "0", "--out", str(out)],
                   check=True, capture_output=True, timeout=300)
    names, codes, tree = datagen.make_backbone(n, cols, seed)
    with gzip.open(out / "backbone.aln.fasta.gz", "rt") as f:
        assert f.read() == datagen.backbone_fasta(names, codes)
    assert (out / "backbone.tre").read_text() == tree


def test_fragments_are_a_function_of_the_seed():
    _, codes, _ = datagen.make_backbone(60, 400, 7)
    big = 2 ** 31 + 12345
    a = datagen.make_fragments(codes, big, 3, 10, 0.15, 0.6)
    b = datagen.make_fragments(codes, big, 3, 10, 0.15, 0.6)
    c = datagen.make_fragments(codes, big + 1, 3, 10, 0.15, 0.6)
    assert a == b
    assert a != c
    assert [len(j) for j in a] == [10, 10, 10]
    flat = [s for j in a for s in j]
    assert len(set(flat)) == len(flat)
    assert all(set(s) <= set("ACGT") and len(s) >= 30 for s in flat)


def test_every_job_keeps_the_same_fractions():
    """Each job holds the same stratified set of kept fractions in another
    order, so that a seed changes what a job holds, not its size: on a
    backbone whose rows all have one length, every job of every seed has
    the same fragment lengths."""
    codes = np.random.default_rng(3).integers(0, 4, (50, 400)).astype(np.int8)
    sizes = set()
    for seed in (11, 2 ** 32 + 5):
        for job in datagen.make_fragments(codes, seed, 3, 8, 0.15, 0.6):
            sizes.add(tuple(sorted(len(s) for s in job)))
    assert sizes == {tuple(sorted(max(30, int(400 * (0.15 + 0.45 * (k + 0.5)
                                                      / 8)))
                                  for k in range(8)))}
