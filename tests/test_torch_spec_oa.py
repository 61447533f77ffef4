"""The speculative OA start of the port (aligner.py:speculative_oa_start,
launched by pipeline.compute_scores before the exact-f32 overlay and
joined by align_all_queries), on the CPU with the plain OA version, on
the amino golden's backbone and its first 12 queries: the rows do not
depend on it, a drifted selection is aligned on the native engine and
counted, and an error in its thread stops the run."""

import os
import re

import pytest
import torch

from witch_tpu_torch.cli import init_parser
from witch_tpu_torch.config import build_configs

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")
JOIN = re.compile(r"align: (\d+) pairs speculative device OA join "
                  r"\((\d+) selection-drift host aligns\)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's runs: they are many small
    PyTorch calls, which slow down sharply when test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def queries(tmp_path_factory):
    from witch_tpu_torch.io.fasta import read_fasta, write_fasta
    path = tmp_path_factory.mktemp("q") / "queries.fasta"
    write_fasta(list(read_fasta(os.path.join(
        GOLD, "ref_amino.queries.fasta")))[:12], str(path))
    return str(path)


def _run(outdir, queries):
    """The amino golden's backbone and `queries` through the port on the
    CPU; returns (aligned.fasta bytes, the runtime breakdown)."""
    from witch_tpu_torch.pipeline import main_alignment_process
    build_configs(init_parser(), [
        "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
        "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
        "-q", queries, "-d", str(outdir), "-o", "aligned.fasta",
        "--molecule", "amino"])
    main_alignment_process(device="cpu")
    with open(outdir / "aligned.fasta", "rb") as f:
        rows = f.read()
    with open(outdir / "runtime_breakdown.txt") as f:
        return rows, f.read()


@pytest.fixture(scope="module")
def sequential(tmp_path_factory, queries):
    """The run with the speculative start off (WITCH_TPU_SPEC_OA=0)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WITCH_TPU_SPEC_OA", "0")
    try:
        return _run(tmp_path_factory.mktemp("seq") / "out", queries)
    finally:
        mp.undo()


def test_default_equals_sequential(sequential, queries, tmp_path,
                                   monkeypatch):
    monkeypatch.delenv("WITCH_TPU_SPEC_OA", raising=False)
    rows, rt = _run(tmp_path / "out", queries)
    assert rows == sequential[0]
    assert not JOIN.search(sequential[1])
    m = JOIN.search(rt)
    assert m, rt
    assert int(m.group(1)) > 0 and int(m.group(2)) == 0


def test_drifted_pairs_are_aligned_natively(sequential, queries, tmp_path,
                                            monkeypatch):
    """A speculative selection that misses k pairs of the final one: the
    same rows, and the join counts k selection-drift host aligns."""
    import witch_tpu_torch.pipeline as pl
    k = 3
    orig = pl._speculative_pairs

    def drop_k(*a, **kw):
        return orig(*a, **kw)[k:]

    monkeypatch.delenv("WITCH_TPU_SPEC_OA", raising=False)
    monkeypatch.setattr(pl, "_speculative_pairs", drop_k)
    rows, rt = _run(tmp_path / "out", queries)
    assert rows == sequential[0]
    m = JOIN.search(rt)
    assert m and int(m.group(2)) == k, rt


def test_thread_error_stops_the_run(queries, tmp_path, monkeypatch):
    """An exception in the speculative thread is raised at the join: the
    run fails and writes no alignment (no sequential fallback)."""
    from witch_tpu_torch import spans
    from witch_tpu_torch.aligner import DeviceAligner
    orig = DeviceAligner.aligned_columns_batch

    def fail_spec(self, pairs, Ldmax):
        if spans.current().name == "spec_oa":   # the speculative thread
            raise RuntimeError("speculative thread failed")
        return orig(self, pairs, Ldmax)

    monkeypatch.delenv("WITCH_TPU_SPEC_OA", raising=False)
    monkeypatch.setattr(DeviceAligner, "aligned_columns_batch", fail_spec)
    with pytest.raises(RuntimeError, match="speculative thread failed"):
        _run(tmp_path / "out", queries)
    assert not (tmp_path / "out" / "aligned.fasta").exists()


def test_unjoined_thread_is_waited_out(queries, tmp_path, monkeypatch):
    """A run that stops between the speculative start and the align
    stage's join raises its own error only once the speculative thread
    has ended, so that none of its launches falls into a later run."""
    import time
    import witch_tpu_torch.aligner as aligner
    import witch_tpu_torch.pipeline as pipeline
    from witch_tpu_torch import spans
    orig = aligner.DeviceAligner.aligned_columns_batch
    ended = []

    def slow_spec(self, pairs, Ldmax):
        spec = spans.current().name == "spec_oa"  # the speculative thread
        if spec:
            time.sleep(1.0)
        out = orig(self, pairs, Ldmax)
        ended.append(spec)
        return out

    def fail(path):
        raise OSError("checkpoint unreadable")

    monkeypatch.delenv("WITCH_TPU_SPEC_OA", raising=False)
    monkeypatch.setattr(aligner.DeviceAligner, "aligned_columns_batch",
                        slow_spec)
    monkeypatch.setattr(pipeline, "read_checkpoint", fail)
    with pytest.raises(OSError, match="checkpoint unreadable"):
        _run(tmp_path / "out", queries)
    assert ended == [True]
    assert not aligner._PENDING
