"""The ensemble's entropy weighting on the card (ops/effn.py,
csrc/effn.cu) against the host's bisection (hmm/build.py:entropy_weight).

CPU: the plain lock-step version gives every model's effn bit for bit
with the JAX package's entropy_weight on a 200-sequence dna1k-style
backbone and on the amino golden backbone (K 20, 9 components); a model
that meets its target at full counts keeps nseq; the guard sends models
to the host without changing a result; the ensemble, built split at the
weighting, equals the JAX package's, built whole, core for core and model
file for model file.
Card (`-m cuda`): the kernel on dna1k's 285 models, and the model files
built on the card against the port's whole host build (build_hmm), byte
for byte. The JAX package does not run on the card; the CPU tests hold
the port's host build against it.
"""

import math
import os

import numpy as np
import pytest
import torch

from witch_tpu_torch import _build
from witch_tpu_torch import ensemble as E
from witch_tpu_torch.core.alignment import PackedAlignment, subset_counts
from witch_tpu_torch.core.alphabet import ALPHABETS
from witch_tpu_torch.hmm.build import (Counts, build_hmm, hmm_counts,
                                       hmm_effn, quantize_like_text)
from witch_tpu_torch.io.hmmer_text import write_hmm
from witch_tpu_torch.ops import effn as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
DNA1K = (1000, 1536, 20260820)       # benchmark/configs/dna1k.json


def _backbone(tmp, n, cols, seed):
    from benchmark import datagen
    names, codes, tree = datagen.make_backbone(n, cols, seed)
    aln = os.path.join(tmp, "backbone.fasta")
    tre = os.path.join(tmp, "backbone.tre")
    with open(aln, "w") as f:
        f.write(datagen.backbone_fasta(names, codes))
    with open(tre, "w") as f:
        f.write(tree)
    return aln, tre


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the plain version is many small PyTorch
    calls, which slow down sharply when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def backbones(tmp_path_factory):
    """molecule -> (alignment, tree path): 200 sequences of dna1k's
    generator, and the amino golden backbone."""
    d = str(tmp_path_factory.mktemp("effn"))
    aln, tre = _backbone(d, 200, 1536, 20261021)
    return {"dna": (PackedAlignment.from_fasta(aln, molecule="dna"), tre),
            "amino": (PackedAlignment.from_fasta(
                os.path.join(GOLD, "ref_amino500.backbone.fasta"),
                molecule="amino"),
                os.path.join(GOLD, "ref_amino500.backbone.tre"))}


def _jax_backbone(bb):
    """The JAX package's alignment of the same rows."""
    from witch_tpu.core.alignment import PackedAlignment as JaxAlignment
    from witch_tpu.core.alphabet import ALPHABETS as JAX_ALPHABETS
    return JaxAlignment(list(bb.names), bb.codes.copy(),
                        JAX_ALPHABETS[bb.alphabet.name])


def _counts(bb, tre, molecule):
    out = []
    for leaves in E.decompose_tree_file(tre, 10):
        rows, ret, _ = subset_counts(bb, leaves)
        out.append(hmm_counts(np.ascontiguousarray(bb.codes[rows][:, ret]),
                              ALPHABETS[molecule]))
    return out


def _args(counts, molecule, device="cpu"):
    return F.effn_args(counts, molecule, device)


def _host(counts, molecule):
    """The port's host bisection (hmm_effn)."""
    return [hmm_effn(c, molecule) for c in counts]


def _jax(counts, molecule):
    """The JAX package's entropy_weight on the same counts."""
    from witch_tpu.hmm.build import entropy_weight
    from witch_tpu.hmm.priors import get_background, get_emission_prior
    return [entropy_weight(c.ecounts, c.tcounts, c.nseq, c.etarget,
                           get_emission_prior(molecule), c.ecounts.shape[1],
                           bg=get_background(molecule)) for c in counts]


@pytest.mark.parametrize("molecule", ["dna", "amino"])
def test_plain_version_matches_entropy_weight(backbones, molecule):
    counts = _counts(*backbones[molecule], molecule)
    assert len(counts) > (15 if molecule == "dna" else 5)
    got, minf = F.effn_ref(*_args(counts, molecule))
    want = _jax(counts, molecule)
    assert _host(counts, molecule) == want
    # bit for bit without the guard, and no model below it
    assert got.tolist() == want
    assert float(minf.min()) >= F.EFFN_GUARD
    # some models bisect, and their effn is below nseq
    assert any(e < c.nseq for e, c in zip(want, counts))
    effn, redo = F.effn_all(counts, molecule, "cpu")
    assert effn == want and redo == 0


def test_target_met_at_full_counts_keeps_nseq(backbones):
    counts = _counts(*backbones["dna"], "dna")[:4]
    high = [Counts(c.ecounts, c.tcounts, c.nseq, 100.0) for c in counts]
    got, minf = F.effn_ref(*_args(high, "dna"))
    assert got.tolist() == [float(c.nseq) for c in high]
    assert got.tolist() == _jax(high, "dna") == _host(high, "dna")
    # only the first test ran: |f| is the gap at full counts
    assert float(minf.min()) > 90.0


def test_guard_sends_models_to_the_host_unchanged(backbones, monkeypatch):
    counts = _counts(*backbones["dna"], "dna")
    want = F.effn_all(counts, "dna", "cpu")
    monkeypatch.setattr(F, "EFFN_GUARD", math.inf)
    effn, redo = F.effn_all(counts, "dna", "cpu")
    assert redo == len(counts)
    assert effn == want[0] == _jax(counts, "dna")


def test_nan_margin_goes_to_the_host(backbones, monkeypatch):
    counts = _counts(*backbones["dna"], "dna")[:3]
    real = F.effn_ref

    def poisoned(*a):
        effn, minf = real(*a)
        minf[1] = float("nan")
        effn[1] = -1.0
        return effn, minf
    monkeypatch.setattr(F, "effn_ref", poisoned)
    effn, redo = F.effn_all(counts, "dna", "cpu")
    assert redo == 1 and effn == _jax(counts, "dna")


def _cores_equal(a, b):
    assert sorted(a.cores) == sorted(b.cores)
    for i in a.cores:
        x, y = a.cores[i], b.cores[i]
        for f in ("match_emissions", "insert_emissions", "trans"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), (i, f)
        assert (x.effn, x.nseq, x.consensus, x.name) == \
            (y.effn, y.nseq, y.consensus, y.name)


def _jax_ensemble(bb, tre, molecule, n_workers):
    from witch_tpu.ensemble import build_ensemble
    return build_ensemble(_jax_backbone(bb), tre, 10, None, molecule,
                          n_workers)


@pytest.mark.parametrize("n_workers", [1, 4])
def test_split_build_equals_the_whole_build(backbones, n_workers):
    """build_ensemble, split at the weighting (the plain version on the
    CPU), gives the quantized cores of the JAX package's whole build."""
    from witch_tpu_torch.spans import span
    bb, tre = backbones["dna"]
    whole = _jax_ensemble(bb, tre, "dna", n_workers)
    with span("ensemble") as top:
        split = E.build_ensemble(bb, tre, 10, None, "dna", n_workers,
                                 device="cpu")
    _cores_equal(whole, split)
    sp = top.child("ensemble.effn")
    n = len(split.cores)
    assert sp.counters["models"] == sp.counters["device_models"] == n
    assert sp.counters["host_redo"] == 0
    assert sp.counters["launches"] == 0       # the plain version
    names = [c.name for c in top.children]
    assert names.count("ensemble.counts") == names.count(
        "ensemble.model") == n


def _files_equal(want, got, write_want, tmp_path):
    for i in want.cores:
        a, b = tmp_path / ("w%d" % i), tmp_path / ("g%d" % i)
        write_want(want.cores[i], str(a))
        write_hmm(got.cores[i], str(b))
        assert a.read_bytes() == b.read_bytes(), i


@pytest.mark.parametrize("molecule", ["dna", "amino"])
def test_model_files_equal_the_jax_build(backbones, molecule, tmp_path):
    """The port's model files (no device given: the CPU) byte for byte
    the JAX package's, and the port's whole host build (build_hmm, what
    the card tests hold the kernel's build against) the same cores."""
    from witch_tpu.io.hmmer_text import write_hmm as jax_write_hmm
    bb, tre = backbones[molecule]
    jax = _jax_ensemble(bb, tre, molecule, 4)
    port = E.build_ensemble(bb, tre, 10, None, molecule, 4)
    _cores_equal(jax, port)
    _cores_equal(jax, _whole(bb, tre, molecule))
    _files_equal(jax, port, jax_write_hmm, tmp_path)


def _whole(bb, tre, molecule):
    """The port's host build, model by model: build_hmm whole, with the
    host's bisection."""
    cores = {}
    for i, leaves in enumerate(E.decompose_tree_file(tre, 10)):
        rows, ret, _ = subset_counts(bb, leaves)
        codes = np.ascontiguousarray(bb.codes[rows][:, ret])
        cores[i] = quantize_like_text(build_hmm(
            codes, ALPHABETS[molecule], molecule, name="A_0_%d" % i))
    return E.Ensemble(cores, {}, {}, bb, molecule)


# ---- on the card ------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_matches_the_host_on_dna1k(tmp_path):
    """dna1k's 285 models: the kernel's effn equals entropy_weight's bit
    for bit, none below the guard, in one launch."""
    dev = _card()
    bb_path, tre = _backbone(str(tmp_path), *DNA1K)
    counts = _counts(PackedAlignment.from_fasta(bb_path, molecule="dna"),
                     tre, "dna")
    assert len(counts) == 285
    want = _host(counts, "dna")
    n0 = _build.LAUNCHES["effn"]
    got, minf = F.effn_card(*_args(counts, "dna", dev))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["effn"] == n0 + 1
    assert got.cpu().tolist() == want
    print("effn: smallest margin %.3g bits" % float(minf.min()))
    assert float(minf.min()) >= F.EFFN_GUARD
    effn, redo = F.effn_all(counts, "dna", dev)
    assert effn == want and redo == 0
    # the plain version on the same counts agrees
    assert F.effn_ref(*_args(counts, "dna"))[0].tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("molecule", ["dna", "amino"])
def test_card_model_files_equal_the_host_build(backbones, molecule,
                                               tmp_path):
    dev = _card()
    bb, tre = backbones[molecule]
    host = _whole(bb, tre, molecule)
    n0 = _build.LAUNCHES["effn"]
    card = E.build_ensemble(bb, tre, 10, None, molecule, 4, device=dev)
    assert _build.LAUNCHES["effn"] == n0 + 1
    _cores_equal(host, card)
    _files_equal(host, card, write_hmm, tmp_path)
