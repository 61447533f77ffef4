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
                "witch_tpu_torch.__main__")


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
    sharding (WITCH_TPU_SHARD) and the device pair-HMM embedding of the
    scenario-A backbone aligner (WITCH_TPU_DEVICE_EMBED)."""
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    q = os.path.join(GOLD, "ref_amino.queries.fasta")
    for env, extra in (
            (("WITCH_TPU_SHARD", "0/2"),
             ["-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
              "-e", os.path.join(GOLD, "ref_amino.backbone.tre")]),
            (("WITCH_TPU_DEVICE_EMBED", "1"), ["-i", q])):
        monkeypatch.setenv(*env)
        build_configs(init_parser(), ["-q", q, "-d", str(tmp_path / "o"),
                                      "-o", "a.fasta"] + extra)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main_alignment_process(device="cpu")
        monkeypatch.delenv(env[0])
