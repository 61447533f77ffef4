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
                "witch_tpu_torch.backbone_consistency",
                "witch_tpu_torch.parallel.dist",
                "witch_tpu_torch.parallel.mesh")


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


def test_sharded_matches_unsharded_and_jax(tmp_path, monkeypatch):
    """Query sharding (WITCH_TPU_SHARD, file-staged), the data of
    tests/test_parallel.py:test_pipeline_sharded_end_to_end: shards 0/3
    and 2/3 stage their rows and return None, 1/3 merges; the merged
    aligned.fasta and aligned.masked.fasta are the unsharded port's byte
    for byte and the JAX package's row for row, and the merge removed the
    staged rows."""
    from test_torch_parallel import toy_data
    from witch_tpu.cli import init_parser as jax_parser
    from witch_tpu.config import build_configs as jax_configs
    from witch_tpu.io.fasta import read_fasta
    from witch_tpu.pipeline import main_alignment_process as jax_main
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    args = toy_data(tmp_path) + ["-o", "aligned.fasta"]

    def port(outdir, shard):
        monkeypatch.setenv("WITCH_TPU_SHARD", shard)
        build_configs(init_parser(), args + ["-d", str(outdir)])
        return main_alignment_process(device="cpu")

    monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)
    jax_configs(jax_parser(), args + ["-d", str(tmp_path / "jax")])
    jax_main()
    single = port(tmp_path / "single", "0/1")
    sh = tmp_path / "sharded"
    assert port(sh, "0/3") is None
    assert port(sh, "2/3") is None
    merged = port(sh, "1/3")
    assert merged == str(sh / "aligned.fasta")
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert (sh / f).read_bytes() == (tmp_path / "single" / f).read_bytes()
        rows_j = dict(read_fasta(str(tmp_path / "jax" / f)))
        assert len(rows_j) == 29 and dict(read_fasta(str(sh / f))) == rows_j
    assert single == str(tmp_path / "single" / "aligned.fasta")
    assert not (sh / "shards").exists()


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
