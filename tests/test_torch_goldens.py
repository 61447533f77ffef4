"""The JAX package's rows that chip_smoke.py holds the port's against on
the card (tests/golden/, made with JAX_PLATFORMS=cpu python -m witch_tpu;
commands in PERF.md): scenario A's masked rows (phases 5 and 5d), dna1k
scenario C's query rows (4b), amino500 -m old-witch's query rows (3c),
the 7,110-column dnawide backbone's query rows (4w) and scenario A's
masked rows on ~1,670-residue sequences (5e). Each golden
names exactly the sequences of the input that chip_smoke.py regenerates
(none ignored by the JAX run), and its rows are flush."""

import gzip
import os
import subprocess
import sys

import pytest

from witch_tpu_torch.io.fasta import read_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")


def _dataset(tmp, n, queries, seed, cols=None):
    out = os.path.join(tmp, "data")
    subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "make_scale_dataset.py"), "--n", str(n),
        "--queries", str(queries), "--seed", str(seed), "--out", out]
        + (["--cols", str(cols)] if cols else []),
        check=True, capture_output=True, timeout=300)
    return out


def _scen_a_names(tmp):
    """chip_smoke.py:scenario_a_input's sequences: the backbone rows and
    the fragments of make_scale_dataset.py --n 300 --queries 100 --seed
    20261016."""
    d = _dataset(tmp, 300, 100, 20261016)
    return [n for n, _ in read_fasta(os.path.join(
        d, "backbone.aln.fasta.gz"))] + \
        [n for n, _ in read_fasta(os.path.join(d, "queries.fasta"))]


def _scen_a_long(tmp):
    """chip_smoke.py 5e's data: make_scale_dataset.py --n 120 --queries
    30 --cols 1920 --seed 20261018."""
    return _dataset(tmp, 120, 30, 20261018, cols=1920)


def _scen_a_long_names(tmp):
    d = _scen_a_long(tmp)
    return [n for n, _ in read_fasta(os.path.join(
        d, "backbone.aln.fasta.gz"))] + \
        [n for n, _ in read_fasta(os.path.join(d, "queries.fasta"))]


def _dna1k_queries(tmp):
    d = _dataset(tmp, 1000, 1000, 20260820)
    return [n for n, _ in read_fasta(os.path.join(d, "queries.fasta"))]


def _dnawide(tmp):
    """chip_smoke.py phase 4w's data: make_scale_dataset.py --n 200
    --queries 100 --cols 8000 --seed 20261017."""
    return _dataset(tmp, 200, 100, 20261017, cols=8000)


def _dnawide_queries(tmp):
    return [n for n, _ in read_fasta(os.path.join(_dnawide(tmp),
                                                  "queries.fasta"))]


def _amino500_queries(tmp):
    return [n for n, _ in read_fasta(os.path.join(
        GOLD, "ref_amino500.queries.fasta"))]


GOLDENS = {
    "ref_scenA.aligned.masked.fasta.gz": (_scen_a_names, 400),
    "ref_dna1k_c.queries.masked.fasta.gz": (_dna1k_queries, 1000),
    "ref_amino500_ow.queries.masked.fasta.gz": (_amino500_queries, 500),
    "ref_dnawide.queries.masked.fasta.gz": (_dnawide_queries, 100),
    "ref_scenA_long.aligned.masked.fasta.gz": (_scen_a_long_names, 150),
}


def _rows(name):
    with gzip.open(os.path.join(GOLD, name), "rt") as f:
        return list(read_fasta(f))


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_golden_names_equal_the_input(golden, tmp_path):
    names_of, n = GOLDENS[golden]
    want = names_of(str(tmp_path))
    got = [name for name, _ in _rows(golden)]
    assert len(want) == n
    assert len(got) == len(set(got)) == n
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("golden", sorted(GOLDENS))
def test_golden_rows_flush(golden):
    rows = _rows(golden)
    widths = {len(s) for _, s in rows}
    assert len(widths) == 1, widths
    # masked rows: upper-case residues and gaps only
    alphabet = set("".join(s for _, s in rows))
    assert alphabet <= set("ABCDEFGHIJKLMNOPQRSTUVWXYZ-*"), alphabet
    assert any(set(s) - {"-"} for _, s in rows)


def test_dnawide_golden_width_is_the_backbone(tmp_path):
    """The wide golden's rows span the regenerated backbone's 7,110
    columns (a masked row keeps the backbone's columns only), so the
    models of its ensemble reach the cluster layouts' widths."""
    d = _dnawide(str(tmp_path))
    bb = list(read_fasta(os.path.join(d, "backbone.aln.fasta.gz")))
    rows = _rows("ref_dnawide.queries.masked.fasta.gz")
    assert len(bb) == 200 and len(bb[0][1]) == 7110
    assert {len(s) for _, s in rows} == {len(bb[0][1])}


def test_scen_a_long_golden_width(tmp_path):
    """The long scenario A golden: 150 flush masked rows, 1,765 columns
    wide (the JAX package's backbone alignment of the 70 sequences it
    picked), from an input whose 120 full-length sequences are all wider
    than the pair-HMM register kernel's widest B (1,535): each anchor of
    the embedding takes the wide layout."""
    d = _scen_a_long(str(tmp_path))
    full = [s.replace("-", "") for _, s in read_fasta(os.path.join(
        d, "backbone.aln.fasta.gz"))]
    assert len(full) == 120
    assert 1535 < min(len(s) for s in full) <= max(len(s) for s in full) \
        < 1800
    rows = _rows("ref_scenA_long.aligned.masked.fasta.gz")
    assert {len(s) for _, s in rows} == {1765}
