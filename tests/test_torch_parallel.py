"""Query sharding in the port on the CPU (witch_tpu_torch/parallel/dist.py,
the pipeline's shards and witch_tpu_torch/tools/run_distributed.py):
the helpers against witch_tpu/parallel/dist.py, the file-staged gather
under processes started at once, the gloo group through the tool, the
amino golden and --full-search-results as shards."""

import gzip
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from witch_tpu_torch.parallel import dist

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")
TOOL = os.path.join(ROOT, "witch_tpu_torch", "tools", "run_distributed.py")


def toy_data(d):
    """The seeded DNA toy of tests/test_parallel.py:
    test_pipeline_sharded_end_to_end (20 x 90 backbone, 9 queries, no
    tree); returns its -b and -q flags."""
    from witch_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(11)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 90)]
    rows = []
    for i in range(20):
        s = base.copy()
        mut = rng.random(90) < 0.12
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        rows.append((f"t{i}", "".join(s)))
    queries = []
    for i in range(9):
        src = rows[rng.integers(0, 20)][1]
        a = rng.integers(0, 25)
        queries.append((f"q{i}", src[a:a + 45]))
    write_fasta(rows, str(d / "bb.fasta"))
    write_fasta(queries, str(d / "q.fasta"))
    return ["-b", str(d / "bb.fasta"), "-q", str(d / "q.fasta")]


def _port(args, shard, monkeypatch):
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    if shard:
        monkeypatch.setenv("WITCH_TPU_SHARD", shard)
    else:
        monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)
    build_configs(init_parser(), args)
    return main_alignment_process(device="cpu")


@pytest.mark.parametrize("n", range(1, 9))
def test_shard_indices_match_jax(n):
    from witch_tpu.parallel.dist import shard_indices
    for Q in range(61):
        blocks = [dist.shard_indices(Q, i, n) for i in range(n)]
        for i, b in enumerate(blocks):
            np.testing.assert_array_equal(b, shard_indices(Q, i, n))
        np.testing.assert_array_equal(np.concatenate(blocks), np.arange(Q))


@pytest.mark.parametrize("rows, ignored", [
    ([("q\t1", "AC-GT"), ("plain", "--ac")], ["ig\tnored", "x"]),
    ([("a b\tc", "ACGT")], []),
    ([], []),
])
def test_pack_rows_round_trip(rows, ignored):
    from witch_tpu.parallel.dist import _pack_rows
    payload = dist._pack_rows(rows, ignored)
    assert payload == _pack_rows(rows, ignored)
    assert dist._unpack_rows(payload) == (rows, ignored)


def test_process_shard_resolution(monkeypatch):
    """WITCH_TPU_SHARD first, then an initialised process group's rank
    and size, then (0, 1)."""
    import torch.distributed as td
    monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)
    assert dist.process_shard() == (0, 1)
    monkeypatch.setattr(td, "is_initialized", lambda: True)
    monkeypatch.setattr(td, "get_rank", lambda: 3)
    monkeypatch.setattr(td, "get_world_size", lambda: 4)
    assert dist.process_shard() == (3, 4)
    monkeypatch.setenv("WITCH_TPU_SHARD", "1/2")
    assert dist.process_shard() == (1, 2)


@pytest.mark.parametrize("spec", ["2/2", "-1/2", "a/b", "1", "0/0", "1/2/3"])
def test_bad_shard_spec_raises(spec, monkeypatch, tmp_path):
    monkeypatch.setenv("WITCH_TPU_SHARD", spec)
    with pytest.raises(ValueError, match="WITCH_TPU_SHARD"):
        dist.process_shard()
    with pytest.raises(ValueError, match="WITCH_TPU_SHARD"):
        _port(toy_data(tmp_path) + ["-d", str(tmp_path / "o")], spec,
              monkeypatch)
    assert not (tmp_path / "o" / "log.txt").exists()


def test_replaced_lands_whole_or_not_at_all(tmp_path):
    p = tmp_path / "f"
    p.write_text("old")
    with pytest.raises(RuntimeError):
        with dist.replaced(str(p)) as tmp:
            with open(tmp, "w") as f:
                f.write("half")
            raise RuntimeError("stopped while writing")
    assert p.read_text() == "old" and os.listdir(tmp_path) == ["f"]
    with dist.replaced(str(p)) as tmp:
        with open(tmp, "w") as f:
            f.write("new")
    assert p.read_text() == "new" and os.listdir(tmp_path) == ["f"]


def test_file_staged_gather_claims_once(tmp_path):
    """The interleaving in which two shards both find every file: shard 1
    lands last and merges; shard 0 then checks again (as if its check had
    come after shard 1's file) and must not merge a second time."""
    out = str(tmp_path / "shards")
    p0 = dist._pack_rows([("q0", "AC")], [])
    p1 = dist._pack_rows([("q1", "GT")], ["q2"])
    assert dist._gather_files(p0, 0, 2, out) is None
    assert dist._gather_files(p1, 1, 2, out) == (
        [("q0", "AC"), ("q1", "GT")], ["q2"])
    assert dist._gather_files(p0, 0, 2, out) is None


# one staging process: shard K of N stages its rows into ROUNDS outdirs
# in turn, all processes released at once; prints which rounds it merged
STAGE = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from witch_tpu_torch.parallel.dist import _gather_files, _pack_rows
k, n, base, rounds = int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], \
    int(sys.argv[5])
payload = _pack_rows([("q%d" % k, "A-C" * k)], ["i%d" % k])
open(os.path.join(base, "ready%d" % k), "w").close()
while not os.path.exists(os.path.join(base, "go")):
    time.sleep(0.001)
got = {}
for r in range(rounds):
    g = _gather_files(payload, k, n, os.path.join(base, str(r)))
    if g is not None:
        got[r] = g
print(json.dumps(got))
"""


def test_file_staged_gather_merges_once(tmp_path):
    """Six shards staging at once, 20 rounds: every round exactly one
    shard merges, with every shard's rows in shard order."""
    n, rounds = 6, 20
    procs = [subprocess.Popen(
        [sys.executable, "-c", STAGE, ROOT, str(k), str(n), str(tmp_path),
         str(rounds)], stdout=subprocess.PIPE, text=True) for k in range(n)]
    try:
        for _ in range(3000):
            if all((tmp_path / ("ready%d" % k)).exists() for k in range(n)):
                break
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.02)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs)
    merged = {}
    for o in outs:
        for r, g in json.loads(o.strip().splitlines()[-1]).items():
            merged.setdefault(int(r), []).append(g)
    want = [[["q%d" % k, "A-C" * k] for k in range(n)],
            ["i%d" % k for k in range(n)]]
    assert sorted(merged) == list(range(rounds))
    for r, gs in merged.items():
        assert gs == [want], r
    for r in range(rounds):
        files = os.listdir(tmp_path / str(r))
        assert not [f for f in files if f.endswith(".tmp")]


# one port run as shard SHARD of the toy's flags: prints whether it merged
SHARD_RUN = r"""
import sys
sys.path.insert(0, sys.argv[1])
from witch_tpu_torch.cli import init_parser
from witch_tpu_torch.config import build_configs
from witch_tpu_torch.pipeline import main_alignment_process
build_configs(init_parser(), sys.argv[2:])
print("MERGED" if main_alignment_process(device="cpu") else "STAGED")
"""


def test_file_staged_shards_at_once(tmp_path, monkeypatch):
    """WITCH_TPU_SHARD 0/2 and 1/2 started at the same moment into one
    outdir: exactly one merges, to the unsharded run's bytes."""
    args = toy_data(tmp_path) + ["-o", "aligned.fasta"]
    _port(args + ["-d", str(tmp_path / "single")], "", monkeypatch)
    out = tmp_path / "sharded"
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_RUN, ROOT] + args + ["-d", str(out),
                                                          "-t", "2"],
        env=dict(os.environ, WITCH_TPU_SHARD="%d/2" % i,
                 OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    try:
        res = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in res]
    said = sorted(o.strip().splitlines()[-1] for o, _ in res)
    assert said == ["MERGED", "STAGED"]
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert (out / f).read_bytes() == (tmp_path / "single" / f).read_bytes()
    assert not (out / "shards").exists()
    assert sorted(os.listdir(out / "tree_decomp" / "root")) == \
        sorted(os.listdir(tmp_path / "single" / "tree_decomp" / "root"))


def test_gloo_ranks_through_the_tool(tmp_path, monkeypatch):
    """tools/run_distributed.py --device cpu, two gloo ranks: rank 0
    alone merges, to one process's bytes; no kernel launched."""
    args = toy_data(tmp_path) + ["-o", "aligned.fasta"]
    _port(args + ["-d", str(tmp_path / "single")], "", monkeypatch)
    r = subprocess.run(
        [sys.executable, TOOL, "-n", "2", "--device", "cpu", "--timeout",
         "500", "--compare", str(tmp_path / "single" / "aligned.masked.fasta"),
         "--"] + args + ["-d", str(tmp_path / "gloo")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    ranks, summary = lines[:-1], lines[-1]
    assert [x["rank"] for x in ranks] == [0, 1]
    assert [x["merged"] for x in ranks] == [True, False]
    assert summary["merged_ranks"] == [0] and summary["identical"] is True
    assert all(not any(x["launches"].values()) for x in ranks)
    assert all(x["gather_s"] is not None for x in ranks)
    assert (tmp_path / "gloo" / "aligned.fasta").read_bytes() == \
        (tmp_path / "single" / "aligned.fasta").read_bytes()


def test_tool_rank_failure_fails_the_run(tmp_path):
    """A rank that fails (here: no query file) fails the run, nonzero,
    and takes the other rank down with it rather than leaving it in the
    gather."""
    r = subprocess.run(
        [sys.executable, TOOL, "-n", "2", "--device", "cpu", "--timeout",
         "300", "--", "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
         "-q", str(tmp_path / "missing.fasta"), "-d", str(tmp_path / "o")],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=400)
    assert r.returncode != 0
    assert "failed" in r.stderr


def test_amino_golden_as_two_shards(tmp_path, monkeypatch):
    """The amino golden as WITCH_TPU_SHARD 0/2 then 1/2: 90/90 masked
    rows equal the oracle."""
    from witch_tpu_torch.io.fasta import read_fasta
    args = ["-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
            "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
            "-q", os.path.join(GOLD, "ref_amino.queries.fasta"),
            "-d", str(tmp_path / "out"), "-o", "aligned.fasta",
            "--molecule", "amino"]
    assert _port(args, "0/2", monkeypatch) is None
    out = _port(args, "1/2", monkeypatch)
    mine = dict(read_fasta(os.path.join(os.path.dirname(out),
                                        "aligned.masked.fasta")))
    with gzip.open(os.path.join(GOLD, "ref_amino.aligned.masked.fasta.gz"),
                   "rt") as f:
        oracle = dict(read_fasta(f))
    bad = [n for n in oracle if mine.get(n) != oracle[n]]
    assert len(oracle) == 90 and not bad, bad[:8]


def test_full_search_as_two_shards(tmp_path, monkeypatch):
    """--full-search-results 1 as shards 0/2 and 1/2: the merged rows are
    the unsharded run's, and each shard's native domain definition saw
    only its own queries, the two together every pair of the unsharded
    run."""
    from witch_tpu_torch.native import _domaindef
    args = toy_data(tmp_path) + ["-o", "aligned.fasta",
                                 "--full-search-results", "1"]
    qcodes = []
    orig = _domaindef.evaluate_targets_rows

    def counted(*a):
        qcodes.append([bytes(np.asarray(c, np.int32)) for c in a[9]])
        return orig(*a)

    monkeypatch.setattr(_domaindef, "evaluate_targets_rows", counted)
    _port(args + ["-d", str(tmp_path / "single")], "", monkeypatch)
    single = [c for call in qcodes for c in call]
    from witch_tpu_torch.core.alphabet import ALPHABETS
    from witch_tpu_torch.io.fasta import read_fasta
    q = [bytes(ALPHABETS["dna"].encode(s.upper()).astype(np.int32))
         for _, s in read_fasta(str(tmp_path / "q.fasta"))]
    seen = []
    for i in range(2):
        qcodes.clear()
        _port(args + ["-d", str(tmp_path / "sharded")], "%d/2" % i,
              monkeypatch)
        mine = set(q[k] for k in dist.shard_indices(len(q), i, 2))
        got = [c for call in qcodes for c in call]
        assert got and set(got) <= mine
        seen += got
    assert sorted(seen) == sorted(single)
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert (tmp_path / "sharded" / f).read_bytes() == \
            (tmp_path / "single" / f).read_bytes()
