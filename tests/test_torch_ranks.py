"""The server's resident query-shard ranks (witch_tpu_torch/server.py:
_Ranks, parallel/dist.py) on the CPU, with 2 or 4 CPU entries as the
visible cards (mesh.visible_cards replaced, as tests/test_torch_mesh.py
does): a job through server._run_job writes the one-process job's files
byte for byte, weights.txt, the search results and the decomposition
included, and holds against the benchmark's plain reference; the same
worker processes serve job after job; a rank that raises or dies fails
its job within the bound, and the next job runs on new workers; one
visible card, WITCH_TPU_NO_MESH or a job that builds its backbone starts
none. No JAX here."""

import os
import signal
import sys
import time
import types

import pytest
import torch

from witch_tpu_torch import server
from witch_tpu_torch.parallel import mesh as M

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# a tiny cell of the benchmark's dna1k kind: 30 backbone rows of 300
# columns and their tree, 6 fragments of 15-60% of a row
TINY = {"name": "tiny", "molecule": "dna",
        "backbone": {"sequences": 30, "columns": 300, "seed": 5},
        "witch": {"mode": "witch-ng", "alignment_size": 10,
                  "num_hmms": 10}}
SEED = 2 ** 31 + 20
BOUND_S = 60.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The tiny cell's backbone, tree and fragments, and the files of the
    one-process job on them (WITCH_TPU_NO_MESH=1)."""
    from benchmark import datagen
    d = tmp_path_factory.mktemp("ranks")
    bb_dir, names, codes = datagen.ensure_backbone(TINY, str(d / "data"))
    frags = datagen.make_fragments(codes, SEED, 1, 6, 0.15, 0.6)[0]
    qnames = ["Q%03d" % i for i in range(len(frags))]
    q = d / "queries.fasta"
    q.write_text("".join(">%s\n%s\n" % x for x in zip(qnames, frags)))
    argv = ["-b", os.path.join(bb_dir, "backbone.aln.fasta.gz"),
            "-e", os.path.join(bb_dir, "backbone.tre"), "-q", str(q),
            "-o", "aligned.fasta", "-A", "10", "-k", "10",
            "--save-weight", "1", "-t", "1"]
    ns = types.SimpleNamespace(dir=d, argv=argv, names=names, codes=codes,
                               tree=os.path.join(bb_dir, "backbone.tre"),
                               qnames=qnames, frags=frags)
    os.environ["WITCH_TPU_NO_MESH"] = "1"
    try:
        server._run_job(argv + ["-d", str(d / "single")], "cpu")
    finally:
        del os.environ["WITCH_TPU_NO_MESH"]
    yield ns
    server._RANKS.close()


@pytest.fixture
def cards(monkeypatch):
    """cards(n): n CPU entries as the visible cards."""
    monkeypatch.delenv("WITCH_TPU_NO_MESH", raising=False)
    monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)

    def visible(n):
        monkeypatch.setattr(M, "visible_cards",
                            lambda: [torch.device("cpu")] * n)
    return visible


def outputs(outdir):
    """{relative path: bytes} of a job's outputs: the FASTA files,
    weights.txt and everything under tree_decomp (the decomposition and
    the search results)."""
    out = {}
    for dp, _, fns in os.walk(outdir):
        for fn in fns:
            rel = os.path.relpath(os.path.join(dp, fn), outdir)
            if rel.endswith(".fasta") or rel == "weights.txt" \
                    or rel.startswith("tree_decomp"):
                with open(os.path.join(dp, fn), "rb") as f:
                    out[rel] = f.read()
    return out


def job(data, tag):
    outdir = data.dir / tag
    server._run_job(data.argv + ["-d", str(outdir)], "cpu")
    return outdir


def lines(outdir, name="runtime_breakdown.txt"):
    with open(os.path.join(outdir, name)) as f:
        return f.read().splitlines()


def reference_check(data, outdir):
    """benchmark/check.py's comparison of the job's outputs with the plain
    reference: (correct, checks)."""
    from benchmark.check import Checker
    cell = types.SimpleNamespace(
        config=TINY, tree=data.tree, bb_names=data.names, bb_codes=data.codes,
        hmmdir=None, workdir=str(data.dir), device="cpu",
        traffic={"check_candidates_per_job": 6, "check_decided": 2})
    checker = Checker(cell, SEED)
    checker.collect(0, types.SimpleNamespace(ok=True, n=len(data.frags)),
                    str(outdir), data.qnames, data.frags)
    return checker.verify()


def ranks_job(n, data):
    """A job as n ranks, twice: every output file of the one-process job,
    byte for byte; rank 0's breakdown holds the dispatch, rank-wall and
    gather lines, the other ranks' their own files; the second job runs
    on the same workers. Returns the second job's directory."""
    single = outputs(data.dir / "single")
    assert "weights.txt" in single
    assert any("hmmsearch.results." in k for k in single)
    first = job(data, "ranks%d" % n)
    pids = server._RANKS.pids()
    assert len(pids) == n - 1
    assert outputs(first) == single
    own = lines(first)
    assert own[0].startswith("Time to dispatch job to %d shard ranks (s):"
                             % n)
    walls = [ln for ln in own if ln.startswith("  shards: rank walls")]
    assert len(walls) == 1
    lo, hi = (float(x) for x in walls[0].split(":")[-1].split(".."))
    assert 0 < lo <= hi
    assert any(ln.startswith("Time to gather shard rows") for ln in own)
    assert own[-1].startswith("Total runtime")
    for r in range(1, n):
        theirs = lines(first, "runtime_breakdown.rank%d.txt" % r)
        assert theirs[-1].startswith("Total runtime")
        assert not any("dispatch" in ln for ln in theirs)
    again = job(data, "ranks%d_again" % n)
    assert server._RANKS.pids() == pids
    assert outputs(again) == single
    return again


def test_two_ranks_write_the_one_process_files(data, cards):
    """Two ranks (ranks_job), and the benchmark's check of their outputs
    against the plain reference comes out correct."""
    cards(2)
    correct, checks = reference_check(data, ranks_job(2, data))
    assert correct, checks


def test_failed_rank_fails_its_job_and_the_next_runs(data, cards):
    """Rank 1 raises (its job names a query file that is not there): the
    job fails within the bound with rank 1's traceback, and the next job
    runs on a new worker, to the one-process files. Then rank 1's
    process is killed once the job is handed out: that job fails within
    the bound too, and the workers are discarded."""
    cards(2)
    if server._RANKS.cards != ["cpu"] * 2:
        job(data, "before")
    for how in ("raises", "dies"):
        (pid,) = server._RANKS.pids()
        conn = server._RANKS.conns[0]
        send = conn.send

        def spoil(msg, how=how, send=send, pid=pid):
            if msg is None or msg[0] == "ensemble":
                return send(msg)
            job_id, argv, *rest = msg
            if how == "raises":
                argv = [str(data.dir / "missing.fasta")
                        if a.endswith("queries.fasta") else a for a in argv]
            send((job_id, argv, *rest))
            if how == "dies":
                os.kill(pid, signal.SIGKILL)

        conn.send = spoil
        t0 = time.time()
        with pytest.raises(RuntimeError) as err:
            job(data, "failed_%s" % how)
        assert time.time() - t0 < BOUND_S
        text = str(err.value)
        assert "shard rank 1" in text
        assert server._RANKS.pids() == []       # discarded
        if how == "raises":
            assert "query sequences missing" in text
            after = job(data, "after_%s" % how)
            assert server._RANKS.pids() not in ([], [pid])
            assert outputs(after) == outputs(data.dir / "single")
        else:
            assert "died" in text


def test_four_ranks_write_the_one_process_files(data, cards):
    """Four ranks (ranks_job)."""
    cards(4)
    ranks_job(4, data)


@pytest.mark.parametrize("case", ["one card", "WITCH_TPU_NO_MESH"])
def test_no_worker_on_one_card_or_without_the_mesh(case, data, cards,
                                                   monkeypatch):
    """One visible card, or WITCH_TPU_NO_MESH with four: the job runs in
    this process alone, with no worker and no process group, to the same
    files."""
    import torch.distributed as td
    server._RANKS.close()
    if case == "one card":
        cards(1)
    else:
        cards(4)
        monkeypatch.setenv("WITCH_TPU_NO_MESH", "1")
    jobs = server._RANKS.jobs
    outdir = job(data, "alone_%s" % case.replace(" ", "_"))
    assert server._RANKS.pids() == [] and server._RANKS.jobs == jobs
    assert not (td.is_available() and td.is_initialized())
    assert not os.path.exists(os.path.join(outdir,
                                           "runtime_breakdown.rank1.txt"))
    assert not any("shard" in ln for ln in lines(outdir))
    assert outputs(outdir) == outputs(data.dir / "single")


def test_job_without_backbone_runs_in_one_process(data, cards,
                                                  monkeypatch):
    """A scenario-A job (-i, no -b) with two cards visible: its backbone
    job runs once, in this process, which scores on the mesh; no worker
    starts, and the files are those of the job with WITCH_TPU_NO_MESH."""
    import numpy as np

    from witch_tpu_torch.config import Configs
    rng = np.random.default_rng(5)
    letters = np.array(list("ACGT"))
    base = letters[rng.integers(0, 4, 100)]
    records = []
    for i in range(24):
        s = base.copy()
        mut = rng.random(100) < 0.08
        s[mut] = letters[rng.integers(0, 4, mut.sum())]
        records.append(("f%d" % i, "".join(s)))
    for i in range(6):
        a = rng.integers(0, 40)
        records.append(("q%d" % i, records[i][1][a:a + 45]))
    inp = data.dir / "scenario_a.fasta"
    inp.write_text("".join(">%s\n%s\n" % r for r in records))
    argv = ["-i", str(inp), "-o", "aligned.fasta", "-t", "1"]
    server._RANKS.close()
    cards(2)
    jobs = server._RANKS.jobs
    mesh = data.dir / "scenario_a_mesh"
    server._run_job(argv + ["-d", str(mesh)], "cpu")
    assert server._RANKS.pids() == [] and server._RANKS.jobs == jobs
    assert Configs.scoring_cards == ["cpu"] * 2
    assert not os.path.exists(mesh / "runtime_breakdown.rank1.txt")
    assert sum(ln.startswith("Time for backbone job")
               for ln in lines(mesh)) == 1
    monkeypatch.setenv("WITCH_TPU_NO_MESH", "1")
    single = data.dir / "scenario_a_single"
    server._run_job(argv + ["-d", str(single)], "cpu")
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert (mesh / f).read_bytes() == (single / f).read_bytes(), f


@pytest.mark.parametrize("job, shard, parts", [
    (None, None, 1),                      # one process
    (None, "1/4", 4),                     # file-staged shards: any may share
    ((0, 4, 1), None, 1),                 # a rank alone on its card
    ((2, 4, 2), None, 2),                 # two ranks on one card
])
def test_scratch_cap_shared_by_the_ranks_on_the_card(job, shard, parts,
                                                     monkeypatch):
    """ops/plan.py:scratch_cap: half of what PyTorch can still hand out on
    the card, divided among the shards on that card, not all shards."""
    from witch_tpu_torch.ops.plan import scratch_cap
    from witch_tpu_torch.parallel import dist
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (6 << 30, 0))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 3 << 30)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1 << 30)
    if shard:
        monkeypatch.setenv("WITCH_TPU_SHARD", shard)
    else:
        monkeypatch.delenv("WITCH_TPU_SHARD", raising=False)
    avail = (6 << 30) + (3 << 30) - (1 << 30)
    if job is None:
        assert scratch_cap("cuda:0") == avail // (2 * parts)
    else:
        with dist.sharded(dist.ShardJob(*job)):
            assert scratch_cap("cuda:0") == avail // (2 * parts)
