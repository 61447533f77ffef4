"""The port is its own package: no module of witch_tpu_torch (its tools
included) and no line of chip_smoke.py imports witch_tpu or JAX, and a
CPU run of the port's pipeline loads neither."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = os.path.join(ROOT, "witch_tpu_torch")
GOLD = os.path.join(HERE, "golden")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "witch_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_witch_tpu_or_jax(path):
    bad = ["%d: %s" % (ln, m) for ln, m in _imports(path) if _foreign(m)]
    assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_cpu_run_loads_neither(tmp_path):
    code = """
import sys
sys.path.insert(0, %r)
from witch_tpu_torch.cli import init_parser
from witch_tpu_torch.config import build_configs
from witch_tpu_torch.pipeline import main_alignment_process
g = %r
build_configs(init_parser(), [
    "-b", g + "/ref_amino.backbone.fasta", "-e", g + "/ref_amino.backbone.tre",
    "-q", g + "/ref_amino.queries.fasta", "-d", %r, "-o", "aligned.fasta",
    "--molecule", "amino"])
main_alignment_process(device="cpu")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "witch_tpu"))
print("FOREIGN", bad)
""" % (ROOT, GOLD, str(tmp_path / "out"))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOREIGN []" in r.stdout, r.stdout[-2000:]
    assert (tmp_path / "out" / "aligned.masked.fasta").exists()
