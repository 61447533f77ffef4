"""The port's resident server (witch_tpu_torch/server.py) on the CPU: a
`serve --device cpu` subprocess answers an amino job (the golden's
backbone, its first 12 queries) with the bytes of an in-process run and
a bench job with bench_tier's keys, reports a failed job with its
traceback and records its device. The CLI routes only to a live server
on a card (a stand-in here), never to a CPU server, and never starts
one. Server and test run one intra-op thread each: the CPU runs
are many small PyTorch calls, which slow down sharply when test workers
share the cores."""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from test_torch_bench import write_cut_assets

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")
# a job's time limit, and how stale the server's heartbeat may grow
# before a submit gives up on it
WAIT = dict(timeout_s=900, dead_server_s=60)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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


def _amino(outdir, queries):
    return ["-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
            "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
            "-q", queries, "-d", str(outdir), "-o", "aligned.fasta",
            "--molecule", "amino"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A CPU server on its own jobs directory, stopped at the end."""
    from witch_tpu_torch.server import server_alive
    jobs = tmp_path_factory.mktemp("daemon") / "jobs"
    env = dict(os.environ, WITCH_TPU_DAEMON_DIR=str(jobs),
               OMP_NUM_THREADS="1")
    log = open(str(jobs) + ".log", "wb")
    p = subprocess.Popen(
        [sys.executable, "-m", "witch_tpu_torch", "serve", "-d", str(jobs),
         "--max-idle", "1200", "--device", "cpu"],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        t0 = time.time()
        while not server_alive(str(jobs)):
            assert p.poll() is None, open(str(jobs) + ".log").read()
            assert time.time() - t0 < 120, "server did not start"
            time.sleep(0.2)
        yield str(jobs)
    finally:
        p.kill()
        p.wait()
        log.close()


def test_amino_job_equals_in_process_run(daemon, queries, tmp_path):
    from witch_tpu_torch.cli import init_parser
    from witch_tpu_torch.config import build_configs
    from witch_tpu_torch.pipeline import main_alignment_process
    from witch_tpu_torch.server import submit
    res = submit(daemon, _amino(tmp_path / "d", queries), **WAIT)
    assert res["ok"], res["error"]
    assert res["output"] == str(tmp_path / "d" / "aligned.fasta")
    assert not any(res["launches"].values())      # plain versions only
    build_configs(init_parser(), _amino(tmp_path / "p", queries))
    main_alignment_process(device="cpu")
    for f in ("aligned.fasta", "aligned.masked.fasta"):
        assert _read(tmp_path / "d" / f) == _read(tmp_path / "p" / f), f


def test_bench_job(daemon, tmp_path):
    from witch_tpu_torch.server import submit
    path = write_cut_assets(str(tmp_path / "cut.npz"))
    res = submit(daemon, [], **WAIT,
                 extra={"kind": "bench", "assets": path, "reps": 1})
    assert res["ok"], res["error"]
    assert set(res["output"]) == {"dt", "padded_cells", "total_pairs",
                                  "true_cells", "backend", "warm_s"}
    assert res["output"]["total_pairs"] == 3 * 4
    assert res["output"]["backend"] == "cpu"


def test_failed_job_reports_its_traceback(daemon, tmp_path):
    from witch_tpu_torch.server import submit
    res = submit(daemon, _amino(tmp_path / "o", str(
        tmp_path / "missing.fasta")), **WAIT)
    assert res["ok"] is False
    assert res["device"] == "cpu"
    assert "Traceback" in res["error"]
    assert "query sequences missing" in res["error"]


@contextlib.contextmanager
def card_server(jobs, done_device="cuda"):
    """A stand-in for a server on a card, which these tests cannot start:
    its server.alive records "cuda", and it answers each job with a
    failed record from `done_device`, in the form serve writes."""
    from witch_tpu_torch.server import _claim, _write_alive
    os.makedirs(jobs, exist_ok=True)
    _write_alive(os.path.join(jobs, "server.alive"), "cuda")
    stop = threading.Event()

    def answer():
        while not stop.is_set():
            name = _claim(jobs)
            if name is None:
                stop.wait(0.1)
                continue
            with open(os.path.join(jobs, name + ".done"), "w") as f:
                json.dump({"ok": False, "output": None, "error": "card job",
                           "seconds": 0.0, "launches": {},
                           "device": done_device}, f)

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join()


def _n_jobs(jobs):
    return len([f for f in os.listdir(jobs) if f.endswith(".job")])


def test_cli_routes_only_to_a_live_daemon(tmp_path, monkeypatch):
    """witch_runner submits to the live server on a card of
    WITCH_TPU_DAEMON_DIR (a job the server fails: the CLI exits 1), and
    raises when the record says the job ran elsewhere; under
    WITCH_TPU_NO_DAEMON=1 it runs in this process (and, without a card,
    raises); with no live server it starts none."""
    from witch_tpu_torch import witch_runner
    argv = _amino(tmp_path / "r", str(tmp_path / "missing.fasta"))
    monkeypatch.delenv("WITCH_TPU_NO_DAEMON", raising=False)
    card = str(tmp_path / "card")
    monkeypatch.setenv("WITCH_TPU_DAEMON_DIR", card)
    with card_server(card):
        with pytest.raises(SystemExit) as e:
            witch_runner(argv)
        assert e.value.code == 1
        assert _n_jobs(card) == 1
    odd = str(tmp_path / "odd")
    monkeypatch.setenv("WITCH_TPU_DAEMON_DIR", odd)
    with card_server(odd, done_device="cpu"):
        with pytest.raises(RuntimeError, match="not on CUDA"):
            witch_runner(argv)
    if torch.cuda.is_available():
        return
    monkeypatch.setenv("WITCH_TPU_DAEMON_DIR", card)
    monkeypatch.setenv("WITCH_TPU_NO_DAEMON", "1")
    with card_server(card):
        with pytest.raises(RuntimeError, match="CUDA"):
            witch_runner(argv)
        assert _n_jobs(card) == 1
    monkeypatch.delenv("WITCH_TPU_NO_DAEMON")
    idle = tmp_path / "no_daemon"
    monkeypatch.setenv("WITCH_TPU_DAEMON_DIR", str(idle))
    with pytest.raises(RuntimeError, match="CUDA"):
        witch_runner(argv)
    assert not idle.exists() or not os.listdir(idle)


def test_cli_does_not_use_a_cpu_server(daemon, tmp_path, monkeypatch):
    """A live `serve --device cpu` on the CLI's daemon directory takes no
    CLI run: the run stays in this process (without a card, it raises),
    and the server's directory gets no job."""
    from witch_tpu_torch import witch_runner
    from witch_tpu_torch.server import server_device
    assert server_device(daemon) == "cpu"
    monkeypatch.setenv("WITCH_TPU_DAEMON_DIR", daemon)
    monkeypatch.delenv("WITCH_TPU_NO_DAEMON", raising=False)
    n = _n_jobs(daemon)
    argv = _amino(tmp_path / "r", str(tmp_path / "missing.fasta"))
    if torch.cuda.is_available():
        with pytest.raises(FileNotFoundError, match="query sequences"):
            witch_runner(argv)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            witch_runner(argv)
    assert _n_jobs(daemon) == n
