"""Run one WITCH job as N query shards, one process each, joined by a
torch.distributed gloo group on this host.

    python3 witch_tpu_torch/tools/run_distributed.py [-n N] [--device cuda|cpu]
        [--compare FILE] [--timeout S] -- <witch_tpu_torch flags>

The parent picks a free local port and starts N children at once. Child i
starts through the ranks' bootstrap (parallel/dist.py:bootstrap, which
the server's resident ranks use too): it joins the group (gloo,
tcp://127.0.0.1:PORT, rank i of N), takes the card i mod the visible
cards with --device cuda (it sees only that card, so every thread of it
launches there; named by its index, so that a rank forms no data mesh:
parallel/mesh.py) and counts the ranks on its card; it takes 1/N of the
host's cores (-t, and as many PyTorch CPU threads, unless the flags give
-t), then runs pipeline.main_alignment_process in process on the given
flags. Each child gates and aligns its own block of queries; rank 0
gathers every rank's rows, weights and scores and merges
(parallel/dist.py). All ranks write into the one outdir.

Each child prints one JSON line: its rank, wall seconds (the pipeline
call), whether it merged, its card (CUDA_VISIBLE_DEVICES:index), its
seconds in the gather, its own kernel launches (the change in
_build.LAUNCHES over the run) and its own runtime_breakdown.txt lines
(rank 0's file is the job's, rank i's runtime_breakdown.rank<i>.txt).
The parent relays them,
checks that exactly one rank merged and, with --compare FILE, that the
merged aligned.masked.fasta equals FILE byte for byte, then prints one
JSON line of its own and exits nonzero if a rank failed or a check did.

gloo and not NCCL: the gathered payload is host strings, and NCCL does
not run two ranks on one card. --device cuda (the default) raises in a
child without CUDA; --device cpu runs the kernels' plain versions (the
tests).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def child(rank: int, n: int, port: int, device: str, argv) -> int:
    import torch
    import torch.distributed as dist

    from witch_tpu_torch.parallel.dist import bootstrap, rank_cores
    # the rank's one card, by index (a rank scores on it alone), and the
    # group
    device = bootstrap(rank, n, device,
                       init_method="tcp://127.0.0.1:%d" % port)
    try:
        import witch_tpu_torch.pipeline as pl
        from witch_tpu_torch import _build
        from witch_tpu_torch.cli import init_parser
        from witch_tpu_torch.config import Configs, build_configs

        argv, cores = rank_cores(argv, n)
        if cores:
            torch.set_num_threads(cores)
        gather = pl.gather_rows
        t_gather = []

        def timed_gather(*a):
            t0 = time.time()
            try:
                return gather(*a)
            finally:
                t_gather.append(time.time() - t0)

        pl.gather_rows = timed_gather
        # this rank's own runtime_breakdown lines, for its JSON line
        own = []
        write = Configs.runtime

        def runtime(msg):
            own.append(msg)
            write(msg)

        Configs.runtime = runtime
        build_configs(init_parser(), argv)
        before = dict(_build.LAUNCHES)
        t0 = time.time()
        out = pl.main_alignment_process(device=device)
        wall = time.time() - t0
        print(json.dumps({
            "rank": rank, "wall_s": wall, "merged": out is not None,
            "card": (os.environ.get("CUDA_VISIBLE_DEVICES", "")
                     + ":%d" % torch.cuda.current_device()
                     if device != "cpu" else None),
            "gather_s": t_gather[0] if t_gather else None,
            "launches": {k: v - before[k]
                         for k, v in _build.LAUNCHES.items()},
            "breakdown": own}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def card_env(rank: int, device: str) -> dict:
    """The child's environment: with --device cuda and several visible
    cards, only its own card (rank mod the visible cards)."""
    env = dict(os.environ)
    env.pop("WITCH_TPU_SHARD", None)    # the group gives the shard
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")   # every rank on this host
    if device == "cuda":
        import torch

        from witch_tpu_torch.parallel.dist import pin_card
        visible = env.get("CUDA_VISIBLE_DEVICES")
        n = len(visible.split(",")) if visible else torch.cuda.device_count()
        if n > 1:
            pin_card(env, rank % n)
    return env


def masked_path(argv) -> str:
    """The merged aligned.masked.fasta of a job's flags (the pipeline's
    naming of the masked output)."""
    def flag(names, default):
        for k, x in enumerate(argv[:-1]):
            if x in names:
                return argv[k + 1]
        return default
    outdir = flag(("-d", "--outdir"), "witch_output")
    out = flag(("-o", "--output-path"), "aligned.fasta")
    suffix = out.split(".")[-1]
    name = (out[:-len(suffix)] + "masked." + suffix
            if suffix in ("fa", "fasta") else out + ".masked.fasta")
    return os.path.join(outdir, name)


def _wait(procs, timeout: float, t0: float):
    """None when every rank exits 0; else the failed ranks or the
    timeout. A failed rank ends the others (they would wait in the
    gather)."""
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                return bad
            if time.time() - t0 > timeout:
                return "timeout after %.0f s" % timeout
            time.sleep(0.2)
        return [i for i, p in enumerate(procs) if p.returncode != 0] or None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def run(n: int, device: str, argv, timeout: float, compare=None):
    """Start the N ranks, wait for all, relay their JSON lines; returns
    (the ranks' results, the parent's summary). Raises SystemExit when a
    rank fails or a check does."""
    port = free_port()
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="witch_ranks_") as logs:
        procs, files = [], []
        for i in range(n):
            f = open(os.path.join(logs, "rank%d.log" % i), "w+")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child",
                 str(i), str(n), str(port), "--device", device, "--"]
                + list(argv), env=card_env(i, device), stdout=f,
                stderr=subprocess.STDOUT))
        failed = _wait(procs, timeout, t0)
        texts = []
        for f in files:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if failed is not None:
        for i, t in enumerate(texts):
            sys.stderr.write("--- rank %d (rc %s) ---\n%s\n"
                             % (i, procs[i].returncode, t[-4000:]))
        raise SystemExit("run_distributed: rank(s) %s failed" % (failed,))
    results = []
    for i, t in enumerate(texts):
        line = [ln for ln in t.splitlines() if ln.startswith('{"rank"')]
        if not line:
            raise SystemExit("run_distributed: rank %d printed no result:\n%s"
                             % (i, t[-4000:]))
        results.append(json.loads(line[-1]))
        print(line[-1], flush=True)
    merged = [r["rank"] for r in results if r["merged"]]
    summary = {"ranks": n, "device": device, "merged_ranks": merged,
               "wall_s": time.time() - t0, "identical": None}
    if compare is not None:
        with open(masked_path(argv), "rb") as a, open(compare, "rb") as b:
            summary["identical"] = a.read() == b.read()
    print(json.dumps(summary), flush=True)
    if len(merged) != 1:
        raise SystemExit("run_distributed: ranks %s merged, want exactly one"
                         % merged)
    if summary["identical"] is False:
        raise SystemExit("run_distributed: %s differs from %s"
                         % (masked_path(argv), compare))
    return results, summary


def main(args=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-n", type=int, default=2, help="ranks (default 2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--compare", help="a masked FASTA the merged "
                    "aligned.masked.fasta must equal byte for byte")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="seconds before every rank is killed")
    ap.add_argument("--child", nargs=3, type=int, help=argparse.SUPPRESS,
                    metavar=("RANK", "N", "PORT"))
    ap.add_argument("witch", nargs=argparse.REMAINDER,
                    help="-- then the witch_tpu_torch flags of the job")
    a = ap.parse_args(args)
    argv = a.witch[1:] if a.witch[:1] == ["--"] else a.witch
    if a.child:
        return child(a.child[0], a.child[1], a.child[2], a.device, argv)
    run(a.n, a.device, argv, a.timeout, a.compare)
    return 0


if __name__ == "__main__":
    sys.exit(main())
