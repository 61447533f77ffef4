"""Resident serving mode: one long-lived process runs many alignment
jobs on its device (scoring over every visible card), keeping what a
fresh process would set up again from one job to the next: the CUDA
context, the loaded kernel library (_build.lib), the native engine's
extensions and the device bank cache (device.py:bank_to_torch).
Counterpart of witch_tpu/server.py, with the same file protocol:

    jobs/<name>.job      JSON: {"argv": ["-b", ..., "-d", ...]}, or
                         {"kind": "bench", "assets": path, "reps": n}
    jobs/<name>.running  written when picked up
    jobs/<name>.done     JSON: {"ok": bool, "output": path|dict|None,
                                "error": str|None, "seconds": float,
                                "launches": {kernel: count},
                                "device": str, "cards": [str]|None}
    jobs/server.alive    JSON: {"pid": int, "device": str,
                                "cards": [str]}; its mtime is a heartbeat

On a host with several cards a server started without a card index
runs each job that gives its backbone alignment (-b) as query shards,
one rank a card (parallel/dist.py), unless WITCH_TPU_NO_MESH is set in
the server's or the job's environment (a job that builds its backbone
runs in the server's process and scores on the data mesh,
parallel/mesh.py): rank 0 is the server's own process, on the first card, and
ranks 1..N-1 are resident worker processes, one pinned to each other
card, started at the first such job and kept for later ones with their
CUDA context, kernel library, native engine and bank cache (_Ranks).
Each rank takes 1/N of the host's cores (-t, unless the job gives it)
and gates and aligns its own block of the queries; rank 0 gathers the
rows, weights and scores, merges, and writes the outputs of the
one-card job, byte for byte. A rank that raises or dies fails the job
(its traceback in "error"), and the next job starts new workers.
"cards" lists the ranks' cards in rank order (null when the job stopped
before its scoring was set up), and in server.alive the cards its jobs
run on by default; "device" is rank 0's card. Rank 0's stage lines go
to the job's runtime_breakdown.txt, rank i's to
runtime_breakdown.rank<i>.txt.

Usage:
    python -m witch_tpu_torch serve -d JOBS_DIR [--max-idle S] [--device D]
    python -m witch_tpu_torch submit -d JOBS_DIR -- ARGS

The CLI (witch_runner) submits its run to a daemon only when a live one
on a CUDA device already watches default_jobs_dir(); it never starts
one. Left out of the reference: starting a daemon (ensure_daemon), the
device prewarm and keep-alive and the accelerator probe (they kept a
remote TPU session alive), and the hot-reload of modules between jobs.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback

# submitter variables that stay the submitter's own
_LOCAL_ENV = ("WITCH_TPU_IN_SERVER", "WITCH_TPU_DAEMON_DIR")
# rank 0 waits for the other ranks' rows at most this long, plus twice
# its own pipeline's seconds, past reaching the gather
GATHER_GRACE_S = 60.0
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = ("import sys; sys.path.insert(0, %r); from witch_tpu_torch.server "
           "import _rank_worker; sys.exit(_rank_worker(sys.argv[1:]))")


def _run_job(argv, device, cwd=None, env=None):
    """One CLI job in this process; the environment and working
    directory are the job's for its duration. Where the caller's device
    names no card index, two or more cards are visible, WITCH_TPU_NO_MESH
    is unset and this process is no shard itself (where a run would form
    the data mesh), a job that gives its backbone alignment (-b) runs as
    one query shard a card (_Ranks). A job that builds its backbone
    (scenarios A and B) stays in this process, so that the backbone job
    runs once, with every core, and scoring forms the mesh."""
    from .cli import init_parser
    from .config import Configs, build_configs
    from .parallel.dist import process_shard
    from .parallel.mesh import scoring_mesh
    from .pipeline import main_alignment_process
    here = os.getcwd()
    saved = {}
    for k, v in (env or {}).items():
        if k not in _LOCAL_ENV:
            saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
    try:
        if cwd:
            os.chdir(cwd)
        build_configs(init_parser(), argv)
        cards = scoring_mesh(device, process_shard()[1])
        if cards and Configs.backbone_path \
                and os.path.exists(Configs.backbone_path):
            # the workers' environment is the server's, without the job's
            base = dict(os.environ)
            for k, v in saved.items():
                if v is None:
                    base.pop(k, None)
                else:
                    base[k] = v
            return _RANKS.run([str(c) for c in cards], argv, os.getcwd(),
                              env, base)
        return main_alignment_process(device)
    finally:
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Ranks:
    """The resident query-shard ranks of this process's jobs (the module
    docstring). Rank i > 0 is a worker process (_rank_worker) pinned to
    card i and joined to this one by a socket pair; it runs each job's
    pipeline on its block and sends its rows, weights and scores, or its
    traceback, to rank 0. A job that fails after it was handed out
    discards the workers (they may still be busy with it); the next job
    starts new ones."""

    def __init__(self):
        self.cards = None       # the ranks' cards, rank order
        self.procs = []         # worker processes, ranks 1..N-1
        self.conns = []
        self.jobs = 0
        self.lost = 0           # workers discarded since the last start
        self.busy = False       # a job is out on the workers
        self._atexit = False

    def run(self, cards, argv, cwd, env, base_env):
        """The job as len(cards) ranks; returns rank 0's output path."""
        import torch

        from .cli import init_parser
        from .config import Configs, build_configs
        from .parallel import dist
        from .pipeline import main_alignment_process
        n = len(cards)
        self.jobs += 1
        job_id, job_argv = self.jobs, list(argv)
        got = {}                # rank: (payload, extra, wall) from workers
        t0 = [0.0]
        senders = []

        def dispatch():
            self.busy = True
            msg = (job_id, job_argv, cwd, env, job.have_dir)
            for c in self.conns:
                c.send(msg)

        def send_ensemble(blob):
            # beside rank 0's own run: a worker that is still starting
            # reads it when it gets there
            msg = ("ensemble", job_id, blob)
            senders.extend(threading.Thread(target=_send, args=(c, msg),
                                            daemon=True)
                           for c in self.conns)
            for t in senders:
                t.start()

        def gather(payload, extra):
            wall = time.perf_counter() - t0[0]
            self._receive(job_id, got, time.monotonic() + GATHER_GRACE_S
                          + 2 * wall)
            for t in senders:
                t.join()
            self.busy = False
            job.walls = [wall] + [got[r][2] for r in range(1, n)]
            return [(payload, extra)] + [got[r][:2] for r in range(1, n)]

        job = dist.ShardJob(
            0, n, cards.count(cards[0]), start=lambda: self._start(
                cards, base_env), dispatch=dispatch,
            check=lambda: self._receive(job_id, got, None), gather=gather,
            send_ensemble=send_ensemble)
        argv, cores = dist.rank_cores(argv, n)
        threads = torch.get_num_threads()
        torch.set_num_threads(cores or threads)
        try:
            with dist.sharded(job):
                build_configs(init_parser(), argv)
                t0[0] = time.perf_counter()
                out = main_alignment_process(cards[0])
        except BaseException:
            if self.busy:
                self.discard()
            raise
        finally:
            torch.set_num_threads(threads)
        Configs.scoring_cards = list(cards)
        return out

    def _start(self, cards, base_env) -> dict:
        """Workers for ranks 1..N-1 of `cards`, the running ones where
        they all live; the counters of span `shards`."""
        if self.cards == cards and all(p.poll() is None for p in self.procs):
            return {"workers_started": 0, "workers_replaced": 0}
        self.discard()
        if cards[0].startswith("cuda"):
            # built once here, so that the workers only load them
            from . import _build
            from .native import _domaindef, _oa  # noqa: F401
            _build.lib()
        from multiprocessing.connection import Connection
        if not self._atexit:
            atexit.register(self.close)
            self._atexit = True
        from .parallel.dist import pin_card
        for i in range(1, len(cards)):
            env = dict(base_env)
            env.pop("WITCH_TPU_SHARD", None)
            device = cards[i]
            if device.startswith("cuda"):
                pin_card(env, int(device.split(":")[1]))
                device = "cuda:0"
            a, b = socket.socketpair()
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER % _ROOT, str(b.fileno()),
                 str(i), str(len(cards)), str(cards.count(cards[i])),
                 device], env=env, pass_fds=(b.fileno(),),
                stdin=subprocess.DEVNULL))
            b.close()
            self.conns.append(Connection(a.detach()))
        self.cards = list(cards)
        replaced, self.lost = min(self.lost, len(cards) - 1), 0
        return {"workers_started": len(cards) - 1,
                "workers_replaced": replaced}

    def _receive(self, job_id, got, deadline):
        """Read what the workers sent for job job_id into `got`: at once
        (deadline None), or until every rank's rows are in. Raises when a
        rank failed, died or, past the deadline, sent nothing."""
        from multiprocessing.connection import wait
        while True:
            pending = {c: r for r, c in enumerate(self.conns, 1)
                       if r not in got}
            if not pending:
                return
            for c in wait(list(pending), 0 if deadline is None else 1.0):
                r = pending[c]
                try:
                    kind, jid, *rest = c.recv()
                except (EOFError, OSError):
                    p = self.procs[r - 1]
                    try:
                        p.wait(timeout=5)
                    except subprocess.TimeoutExpired:
                        pass
                    raise RuntimeError(
                        "shard rank %d (pid %d, %s) died (exit code %s)"
                        % (r, p.pid, self.cards[r], p.poll())) from None
                if jid != job_id:
                    continue        # the end of an earlier, failed job
                if kind == "error":
                    raise RuntimeError("shard rank %d (%s) failed:\n%s"
                                       % (r, self.cards[r], rest[0]))
                got[r] = tuple(rest)
            if deadline is None:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "shard ranks %s sent no rows within %.0f s past rank 0's "
                    "gather" % (sorted(pending.values()), GATHER_GRACE_S))

    def discard(self):
        """Kill the workers (the next job starts new ones)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for c in self.conns:
            c.close()
        self.lost += len(self.procs)
        self.procs, self.conns, self.cards = [], [], None
        self.busy = False

    def close(self):
        """Stop the workers: each ends after its job, or is killed after
        10 s."""
        for c in self.conns:
            try:
                c.send(None)
            except OSError:
                pass
        t_end = time.monotonic() + 10.0
        for p in self.procs:
            try:
                p.wait(timeout=max(0.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.discard()
        self.lost = 0

    def pids(self):
        return [p.pid for p in self.procs]


_RANKS = _Ranks()


def _send(conn, msg):
    """conn.send(msg) from a side thread: a rank that died meanwhile is
    reported by _Ranks._receive."""
    try:
        conn.send(msg)
    except OSError:
        pass


def _rank_worker(args) -> int:
    """A resident rank's process (_Ranks): FD RANK N SHARING DEVICE. It
    takes its card and warms the kernel library and native engine, then
    runs each job it is sent until rank 0 sends None or goes away."""
    from multiprocessing.connection import Connection

    import torch

    from .parallel import dist
    conn = Connection(int(args[0]))
    rank, n, sharing = int(args[1]), int(args[2]), int(args[3])
    device = dist.bootstrap(rank, n, args[4], sharing=sharing)
    if device.startswith("cuda"):
        from . import _build
        _build.lib()
        torch.zeros(1, device=device)       # the CUDA context, now
    from .native import _domaindef, _oa  # noqa: F401 - the native engine
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return 0
        if msg is None:
            return 0
        job_id, argv, cwd, env, have_dir = msg
        sent = []

        def gather(payload, extra):
            conn.send(("rows", job_id, payload, extra,
                       time.perf_counter() - t0))
            sent.append(True)

        def recv_ensemble():
            msg = conn.recv()
            if not (msg and msg[0] == "ensemble" and msg[1] == job_id):
                raise RuntimeError("shard rank %d: job %d's ensemble did not "
                                   "come (%r)" % (rank, job_id, msg and msg[0]))
            return msg[2]

        argv, cores = dist.rank_cores(argv, n)
        if cores:
            torch.set_num_threads(cores)
        try:
            with dist.sharded(dist.ShardJob(
                    rank, n, sharing, gather=gather, have_dir=have_dir,
                    recv_ensemble=recv_ensemble)):
                t0 = time.perf_counter()
                _run_job(argv, device, cwd, env)
        except (Exception, SystemExit):
            tb = traceback.format_exc()
            if not sent:
                conn.send(("error", job_id, tb))
            else:
                sys.stderr.write("shard rank %d, after its rows:\n%s"
                                 % (rank, tb))


def _run_bench_job(spec, device):
    """`{"kind": "bench"}` job: the bench tier on this process's device."""
    from .benchlib import bench_tier
    return bench_tier(spec["assets"], reps=int(spec.get("reps", 3)),
                      device=device)


def _claim(jobs_dir):
    """The first unclaimed job's name, claimed with an O_EXCL marker (safe
    with several servers on one directory), or None."""
    for fn in sorted(os.listdir(jobs_dir)):
        if not fn.endswith(".job"):
            continue
        base = fn[:-4]
        if os.path.exists(os.path.join(jobs_dir, base + ".done")):
            continue
        try:
            fd = os.open(os.path.join(jobs_dir, base + ".running"),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.close(fd)
        return base
    return None


def _write_alive(alive, device, cards=None):
    with open(alive, "w") as f:
        json.dump({"pid": os.getpid(), "device": str(device),
                   "cards": cards or [str(device)]}, f)


def _heartbeat(alive, device, cards, stop):
    while not stop.wait(5.0):
        try:
            os.utime(alive)
        except OSError:
            _write_alive(alive, device, cards)


def serve(jobs_dir: str, poll_s: float = 0.5, max_idle_s: float = 0.0,
          device=None) -> None:
    """Run the jobs that appear in jobs_dir, one at a time, until no job
    came for max_idle_s seconds (0: forever). The device is resolved once
    (CUDA unless the caller passes another); each job gets the caller's
    own `device`, so that without a card index it runs as one rank a
    card (_Ranks); the workers stop with the server."""
    from . import _build
    from .config import Configs
    from .device import resolve_device
    from .parallel.dist import process_shard
    from .parallel.mesh import scoring_mesh
    requested = device
    device = resolve_device(device)
    cards = [str(d) for d in (scoring_mesh(requested, process_shard()[1])
                              or [device])]
    os.environ["WITCH_TPU_IN_SERVER"] = "1"
    os.makedirs(jobs_dir, exist_ok=True)
    alive = os.path.join(jobs_dir, "server.alive")
    _write_alive(alive, device, cards)
    stop = threading.Event()
    # the heartbeat beats during long jobs too (submitters take a stale
    # mtime for a dead server)
    threading.Thread(target=_heartbeat, args=(alive, device, cards, stop),
                     daemon=True).start()
    print("witch_tpu_torch server: watching %s on %s (scoring on %s)"
          % (jobs_dir, device, ", ".join(cards)), flush=True)
    last_work = time.time()
    try:
        while True:
            name = _claim(jobs_dir)
            if name is None:
                if max_idle_s and time.time() - last_work > max_idle_s:
                    print("witch_tpu_torch server: idle limit reached, "
                          "exiting", flush=True)
                    return
                time.sleep(poll_s)
                continue
            t0 = time.time()
            result = {"ok": False, "output": None, "error": None,
                      "device": str(device), "cards": None}
            _build.reset_launches()
            Configs.scoring_cards = None
            try:
                with open(os.path.join(jobs_dir, name + ".job")) as f:
                    spec = json.load(f)
                if spec.get("kind") == "bench":
                    print("witch_tpu_torch server: bench job %s" % name,
                          flush=True)
                    result["output"] = _run_bench_job(spec, device)
                    Configs.scoring_cards = [str(device)]
                else:
                    print("witch_tpu_torch server: job %s %s"
                          % (name, spec["argv"]), flush=True)
                    result["output"] = _run_job(spec["argv"], requested,
                                                spec.get("cwd"),
                                                spec.get("env"))
                result["ok"] = True
            except SystemExit as e:
                result["error"] = "exit: %s\n%s" % (e, traceback.format_exc())
            except Exception:
                result["error"] = traceback.format_exc()
            result["seconds"] = time.time() - t0
            result["launches"] = dict(_build.LAUNCHES)
            result["cards"] = Configs.scoring_cards
            tmp = os.path.join(jobs_dir, name + ".done.tmp")
            with open(tmp, "w") as f:
                json.dump(result, f)
            os.replace(tmp, os.path.join(jobs_dir, name + ".done"))
            print("witch_tpu_torch server: job %s %s in %.2fs"
                  % (name, "ok" if result["ok"] else "FAILED",
                     result["seconds"]), flush=True)
            last_work = time.time()
    finally:
        stop.set()
        _RANKS.close()
        try:
            os.remove(alive)
        except OSError:
            pass


def submit(jobs_dir: str, argv, timeout_s: float = 0.0,
           poll_s: float = 0.5, cwd: str = None,
           dead_server_s: float = 0.0, extra: dict = None):
    """Enqueue a job and wait for its .done marker; returns the result
    dict. Raises TimeoutError after timeout_s, or RuntimeError when the
    server's heartbeat is stale for dead_server_s while waiting (the job
    is then withdrawn). `extra` merges fields into the job spec (e.g.
    {"kind": "bench", "assets": path}). The submitter's WITCH_TPU_*
    variables go with the job."""
    os.makedirs(jobs_dir, exist_ok=True)
    name = "job-%d-%d" % (os.getpid(), int(time.time() * 1000))
    spec = {"argv": list(argv), "cwd": cwd}
    env = {k: v for k, v in os.environ.items()
           if k.startswith("WITCH_TPU_") and k not in _LOCAL_ENV}
    if env:
        spec["env"] = env
    spec.update(extra or {})
    tmp = os.path.join(jobs_dir, name + ".job.tmp")
    with open(tmp, "w") as f:
        json.dump(spec, f)
    os.replace(tmp, os.path.join(jobs_dir, name + ".job"))
    done = os.path.join(jobs_dir, name + ".done")
    alive = os.path.join(jobs_dir, "server.alive")
    t0 = time.time()
    while not os.path.exists(done):
        if timeout_s and time.time() - t0 > timeout_s:
            raise TimeoutError("job %s not finished in %.0fs"
                               % (name, timeout_s))
        if dead_server_s:
            try:
                stale = time.time() - os.path.getmtime(alive)
            except OSError:
                stale = time.time() - t0
            if stale > dead_server_s:
                for suffix in (".job", ".running"):
                    try:
                        os.unlink(os.path.join(jobs_dir, name + suffix))
                    except OSError:
                        pass
                raise RuntimeError(
                    "server heartbeat stale for %.0fs; job %s withdrawn"
                    % (stale, name))
        time.sleep(poll_s)
    with open(done) as f:
        return json.load(f)


def server_alive(jobs_dir: str, fresh_s: float = 30.0) -> bool:
    try:
        return (time.time()
                - os.path.getmtime(os.path.join(jobs_dir, "server.alive"))
                < fresh_s)
    except OSError:
        return False


def default_jobs_dir() -> str:
    return os.environ.get(
        "WITCH_TPU_DAEMON_DIR",
        os.path.join(os.path.expanduser("~"), ".witch_tpu_torch", "daemon"))


def server_device(jobs_dir: str):
    """The device of the server watching jobs_dir, as its server.alive
    records it, or None."""
    try:
        with open(os.path.join(jobs_dir, "server.alive")) as f:
            return json.load(f).get("device")
    except (OSError, ValueError, AttributeError):
        return None


def on_cuda(device) -> bool:
    return str(device).split(":")[0] == "cuda"


def run_via_daemon(argv, cwd=None):
    """Submit this CLI run to the live server watching default_jobs_dir()
    and wait; None when no live server on a CUDA device watches it (the
    caller runs in process) or the server died during the job."""
    jobs_dir = default_jobs_dir()
    if not server_alive(jobs_dir) or not on_cuda(server_device(jobs_dir)):
        return None
    try:
        return submit(jobs_dir, argv, cwd=cwd or os.getcwd(),
                      dead_server_s=180.0)
    except (RuntimeError, OSError) as e:
        sys.stderr.write("WARNING: resident daemon unavailable (%s); "
                         "running in-process\n" % e)
        return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("serve", "submit"):
        print(__doc__)
        return 2
    mode, rest = argv[0], argv[1:]
    jobs_dir, max_idle, device = None, 0.0, None
    i = 0
    while i < len(rest):
        if rest[i] in ("-d", "--jobs-dir"):
            jobs_dir = rest[i + 1]
            i += 2
        elif rest[i] == "--max-idle":
            max_idle = float(rest[i + 1])
            i += 2
        elif rest[i] == "--device":
            device = rest[i + 1]
            i += 2
        elif rest[i] == "--":
            i += 1
            break
        else:
            break
    if jobs_dir is None:
        print("need -d JOBS_DIR")
        return 2
    if mode == "serve":
        serve(jobs_dir, max_idle_s=max_idle, device=device)
        return 0
    result = submit(jobs_dir, rest[i:], cwd=os.getcwd())
    print(json.dumps(result))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
