"""The port's other entry points on the CPU (plain kernel versions)
against the JAX package end to end: old-witch mode, scenario C (tree
estimation) and scenario A (unaligned input); and the refusal of a bank
with a zero core transition."""

import os
import sys

import numpy as np
import pytest

from witch_tpu.core.alignment import PackedAlignment
from witch_tpu.io.fasta import read_fasta, write_fasta
from witch_tpu_torch.cli import init_parser
from witch_tpu_torch.config import Configs, build_configs

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
AMINO = ["-q", os.path.join(GOLD, "ref_amino.queries.fasta"),
         "-o", "aligned.fasta", "--molecule", "amino"]


def _run_both(args, tmp_path):
    """Run the JAX pipeline and the port (device="cpu") on the same
    arguments, each configured through its own package; returns their
    output directories."""
    from witch_tpu.cli import init_parser as jax_parser
    from witch_tpu.config import build_configs as jax_configs
    from witch_tpu.pipeline import main_alignment_process as jax_main
    from witch_tpu_torch import _build
    from witch_tpu_torch.pipeline import main_alignment_process
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    jax_configs(jax_parser(), args + ["-d", str(out_j)])
    jax_main()
    build_configs(init_parser(), args + ["-d", str(out_p)])
    _build.reset_launches()
    main_alignment_process(device="cpu")
    assert not any(_build.LAUNCHES.values())      # plain versions only
    return out_j, out_p


def _masked(outdir):
    return dict(read_fasta(str(outdir / "aligned.masked.fasta")))


def test_old_witch_matches_jax(tmp_path):
    """-m old-witch on the amino golden: masked rows identical."""
    out_j, out_p = _run_both(AMINO + [
        "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
        "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
        "-m", "old-witch"], tmp_path)
    assert Configs.mode == "old-witch"
    mj, mp = _masked(out_j), _masked(out_p)
    assert len(mj) == 90            # 60 backbone + 30 query rows
    assert mj == mp


def test_scenario_c_matches_jax(tmp_path):
    """-b without -e on the amino golden: the distance matrix equals the
    JAX version's exactly, the estimated tree is the same newick, and
    the masked rows are identical."""
    from witch_tpu.tree_estimate import pairwise_distances as jax_dist
    from witch_tpu_torch.tree_estimate import pairwise_distances
    bb = os.path.join(GOLD, "ref_amino.backbone.fasta")
    aln = PackedAlignment.from_fasta(bb, molecule="amino")
    np.testing.assert_array_equal(pairwise_distances(aln, "cpu"),
                                  jax_dist(aln, use_device=True))
    out_j, out_p = _run_both(AMINO + ["-b", bb, "--keep-decomposition",
                                      "1"], tmp_path)
    tre = os.path.join("tree_decomp", "backbone.est.tre")
    assert open(out_j / tre).read() == open(out_p / tre).read()
    assert _masked(out_j) == _masked(out_p)


def test_pairwise_counts_are_exact():
    """Device identity counts equal a float64 numpy computation."""
    from witch_tpu_torch.tree_estimate import identity_counts
    rng = np.random.default_rng(2)
    from witch_tpu.core.alphabet import DNA
    codes = rng.integers(0, DNA.K + 2, (12, 70)).astype(np.uint8)
    aln = PackedAlignment(["s%d" % i for i in range(12)], codes, DNA)
    m, d = identity_counts(aln, "cpu")
    canon = codes < DNA.K
    onehot = np.zeros((12, 70, DNA.K))
    r, c = np.nonzero(canon)
    onehot[r, c, codes[r, c]] = 1.0
    flat = onehot.reshape(12, -1)
    np.testing.assert_array_equal(m, flat @ flat.T)
    np.testing.assert_array_equal(d, canon.astype(float) @ canon.T)


def test_scenario_a_matches_jax(tmp_path):
    """-i only, on the seeded input of tests/test_pipeline_integration.py
    :88-101: backbone alignment, tree and rows identical."""
    rng = np.random.default_rng(5)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 100)]
    records = []
    for i in range(24):
        s = base.copy()
        mut = rng.random(100) < 0.08
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        records.append((f"f{i}", "".join(s)))
    for i in range(6):
        a = rng.integers(0, 40)
        records.append((f"q{i}", records[i][1][a:a + 45]))
    inp = tmp_path / "all.fasta"
    write_fasta(records, str(inp))
    out_j, out_p = _run_both(["-i", str(inp), "-o", "aligned.fasta"],
                             tmp_path)
    for f in ("backbone.aln.fasta", "backbone.tre", "queries.fasta"):
        assert open(out_j / "backbone" / f).read() == \
            open(out_p / "backbone" / f).read(), f
    rows_j = dict(read_fasta(str(out_j / "aligned.fasta")))
    assert rows_j == dict(read_fasta(str(out_p / "aligned.fasta")))
    assert _masked(out_j) == _masked(out_p)
    assert len(rows_j) == 30
    src = dict(records)
    for name, seq in rows_j.items():
        assert seq.replace("-", "").upper() == src[name]


def test_zero_transition_models_align_natively(tmp_path):
    """build_banks gives prior-smoothed models, whose in-range core
    transitions are all positive, so the device OA kernel aligns every
    bank of a real ensemble; no real input needs the native routing of
    the JAX package (witch_tpu/aligner.py:196-201). A bank with a planted
    zero is refused (the kernel's DP does not take it) instead of being
    aligned wrongly."""
    from witch_tpu_torch.aligner import DeviceAligner
    from witch_tpu_torch.core.alphabet import DNA
    from witch_tpu_torch.ensemble import build_ensemble
    from witch_tpu_torch.hmm.bank import build_banks
    from witch_tpu_torch.ops.oa import bank_strictly_positive
    rng = np.random.default_rng(8)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 60)]
    rows = []
    for i in range(12):
        s = base.copy()
        mut = rng.random(60) < 0.1
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        rows.append("".join(s))
    from witch_tpu_torch.core.alignment import PackedAlignment as PortAln
    aln = PortAln(["s%d" % i for i in range(12)],
                  np.array([DNA.encode(r) for r in rows]), DNA)
    nwk = "(" + ",".join("s%d:0.1" % i for i in range(12)) + ");"
    tre = tmp_path / "t.tre"
    tre.write_text(nwk)
    build_configs(init_parser(), ["-b", "x", "-q", "y", "-d",
                                  str(tmp_path / "out")])
    ens = build_ensemble(aln, str(tre), 5, None, "dna", n_workers=1)
    idx = ens.indices
    banks = build_banks([ens.cores[i] for i in idx], indices=idx,
                        uniform=True, n_buckets=2)
    assert all(bank_strictly_positive(b) for b in banks)
    DeviceAligner(ens, "cpu", banks)
    banks[0].t_dd[0, 1] = 0.0
    with pytest.raises(ValueError, match="zero core transition"):
        DeviceAligner(ens, "cpu", banks)


@pytest.mark.parametrize("backend", ["iterhmm", "magus"])
def test_backbone_backends_need_the_native_engine(backend, tmp_path,
                                                  monkeypatch):
    """The iterhmm and magus backbone backends align on the port's native
    engine only: without it the backbone job raises rather than taking
    the JAX package's device or numpy fallbacks."""
    from witch_tpu_torch.backbone import BackboneJob
    rng = np.random.default_rng(6)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 60)]
    inp = tmp_path / "in.fasta"
    write_fasta([("s%d" % i, "".join(np.where(rng.random(60) < 0.1,
                                              letters[rng.integers(0, 4, 60)],
                                              base)))
                 for i in range(10)], str(inp))
    monkeypatch.setenv("WITCH_TPU_BACKBONE", backend)
    # the engine's extensions live in sys.modules only (native/__init__.py
    # loads them at first access): None there makes the engine missing
    monkeypatch.setitem(sys.modules, "witch_tpu_torch.native._domaindef",
                        None)
    job = BackboneJob(str(inp), str(tmp_path / "bb"), "cpu",
                      backbone_size=6)
    with pytest.raises(ImportError):
        job.run()
