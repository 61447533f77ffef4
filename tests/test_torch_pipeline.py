"""The port's whole scenario-D slice on the CPU (plain versions of the
three kernels) against the amino golden oracle, plus the import and CLI
contracts: no JAX in the port's import closure, and no CPU run behind
the CLI's back."""

import gzip
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")

PORT_MODULES = ("witch_tpu_torch", "witch_tpu_torch.pipeline",
                "witch_tpu_torch.aligner", "witch_tpu_torch.hmm.gate_device",
                "witch_tpu_torch.hmm.flank_device",
                "witch_tpu_torch.ops.forward", "witch_tpu_torch.ops.null2",
                "witch_tpu_torch.ops.oa", "witch_tpu_torch.ops.flank",
                "witch_tpu_torch.tree_estimate", "witch_tpu_torch.backbone",
                "witch_tpu_torch.device", "witch_tpu_torch._build",
                "witch_tpu_torch.__main__", "witch_tpu_torch.server",
                "witch_tpu_torch.benchlib", "witch_tpu_torch.ops.pairhmm",
                "witch_tpu_torch.backbone_consistency")


def _read_fasta_dict(fh):
    d, name, buf = {}, None, []
    for line in fh:
        line = line.strip()
        if line.startswith(">"):
            if name is not None:
                d[name] = "".join(buf)
            name, buf = line[1:].split()[0], []
        else:
            buf.append(line)
    if name is not None:
        d[name] = "".join(buf)
    return d


def test_amino_golden_on_cpu(tmp_path):
    from witch_tpu_torch import _build
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import Configs, build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    build_configs(init_parser(), [
        "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
        "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
        "-q", os.path.join(GOLD, "ref_amino.queries.fasta"),
        "-d", str(tmp_path / "out"), "-o", "aligned.fasta",
        "--molecule", "amino"])
    _build.reset_launches()
    out = main_alignment_process(device="cpu")
    assert not any(_build.LAUNCHES.values())      # plain versions only
    mine = _read_fasta_dict(open(os.path.join(os.path.dirname(out),
                                              "aligned.masked.fasta")))
    with gzip.open(os.path.join(GOLD, "ref_amino.aligned.masked.fasta.gz"),
                   "rt") as f:
        oracle = _read_fasta_dict(f)
    bad = [n for n in oracle if mine.get(n) != oracle[n]]
    assert len(oracle) == 90
    assert not bad, "%d/90 rows diverge: %s" % (len(bad), bad[:8])
    assert Configs.mode == "witch-ng"


def test_port_imports_without_jax():
    code = ("import sys\nsys.modules['jax'] = None\n"
            + "".join("import %s\n" % m for m in PORT_MODULES)
            + "assert not any(k.startswith('jax.') for k in sys.modules)\n"
            + "assert not any(k == 'witch_tpu' or k.startswith('witch_tpu.')"
            + " for k in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_cli_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "witch_tpu_torch",
         "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
         "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
         "-q", os.path.join(GOLD, "ref_amino.queries.fasta"),
         "-d", str(tmp_path / "out"), "-o", "aligned.fasta"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert not (tmp_path / "out").exists()      # nothing ran on the CPU


def test_unported_modes_raise(tmp_path, monkeypatch):
    """What is still unported raises, naming its ROADMAP queue: query
    sharding (WITCH_TPU_SHARD)."""
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    q = os.path.join(GOLD, "ref_amino.queries.fasta")
    monkeypatch.setenv("WITCH_TPU_SHARD", "0/2")
    build_configs(init_parser(), [
        "-q", q, "-d", str(tmp_path / "o"), "-o", "a.fasta",
        "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
        "-e", os.path.join(GOLD, "ref_amino.backbone.tre")])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main_alignment_process(device="cpu")


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's run: it is many small PyTorch
    calls, which slow down sharply when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n_full, width", [(24, 100), (72, 60)])
def test_scenario_a_device_embed_matches_jax(n_full, width, tmp_path,
                                             monkeypatch, one_thread):
    """Scenario A with WITCH_TPU_DEVICE_EMBED=1, the port on the CPU (the
    pair-HMM plain version) against the JAX package: backbone, tree and
    rows identical. 24 full-length rows of 100 are the data of
    tests/test_torch_modes.py:test_scenario_a_matches_jax (aligned
    without clustering, so the embedding is not reached); 72 rows of the
    same kind, 60 wide, are clustered on the anchor embedding, which both
    packages then compute on the device path."""
    import numpy as np
    import witch_tpu.backbone_consistency as jbc
    import witch_tpu_torch.backbone_consistency as pbc
    from test_torch_modes import _masked, _run_both
    from witch_tpu.io.fasta import read_fasta, write_fasta
    calls = {"jax": 0, "port": 0}

    def counted(mod, key):
        orig = mod._device_embedding

        def run(*a, **kw):
            calls[key] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, "_device_embedding", run)

    counted(jbc, "jax")
    counted(pbc, "port")
    monkeypatch.setenv("WITCH_TPU_DEVICE_EMBED", "1")
    rng = np.random.default_rng(5)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, width)]
    records = []
    for i in range(n_full):
        s = base.copy()
        mut = rng.random(width) < 0.08
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        records.append((f"f{i}", "".join(s)))
    for i in range(6):
        a = rng.integers(0, width * 2 // 5)
        records.append((f"q{i}", records[i][1][a:a + width * 9 // 20]))
    inp = tmp_path / "all.fasta"
    write_fasta(records, str(inp))
    out_j, out_p = _run_both(["-i", str(inp), "-o", "aligned.fasta"],
                             tmp_path)
    assert calls == ({"jax": 1, "port": 1} if n_full > 65
                     else {"jax": 0, "port": 0})
    for f in ("backbone.aln.fasta", "backbone.tre", "queries.fasta"):
        assert open(out_j / "backbone" / f).read() == \
            open(out_p / "backbone" / f).read(), f
    rows_j = dict(read_fasta(str(out_j / "aligned.fasta")))
    assert rows_j == dict(read_fasta(str(out_p / "aligned.fasta")))
    assert _masked(out_j) == _masked(out_p)
    assert len(rows_j) == n_full + 6
