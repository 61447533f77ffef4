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
scores each job over every visible card (the data mesh,
parallel/mesh.py), unless WITCH_TPU_NO_MESH is set in the server's or
the job's environment; "cards" lists the cards a job scored on (null
when it stopped before scoring was set up), and in server.alive the
cards its jobs score on by default. "device" is the primary card, where
everything after scoring runs.

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

import json
import os
import sys
import threading
import time
import traceback

# submitter variables that stay the submitter's own
_LOCAL_ENV = ("WITCH_TPU_IN_SERVER", "WITCH_TPU_DAEMON_DIR")


def _run_job(argv, device, cwd=None, env=None):
    """One CLI job in this process; the environment and working
    directory are the job's for its duration."""
    from .cli import init_parser
    from .config import build_configs
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
        return main_alignment_process(device)
    finally:
        os.chdir(here)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
    own `device`, so that without a card index its scoring forms the
    data mesh."""
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
