"""Query sharding over processes, the counterpart of
witch_tpu/parallel/dist.py:165-274.

Every process scores the whole grid on its card; the host stages (the
reporting gate, the per-query alignment) are independent per query, so
each process gates and aligns only its owned contiguous block of the
query list. The aligned rows are then gathered to one process, which runs
the transitive merge and writes the outputs; the rows arrive in shard
order, which is query order, so the merged files are the unsharded run's.

Two ways to gather:
  - a torch.distributed process group (tools/run_distributed.py starts
    one, gloo over TCP on the host): all_gather_object of each shard's
    packed rows, rank 0 merges. gloo and not NCCL: the payload is host
    strings, and NCCL does not run two ranks on one card;
  - without a group (WITCH_TPU_SHARD="i/n"): each shard stages its rows
    under outdir/shards, and the shard that finds every file present and
    wins the merge claim merges. The shards may run one after another or
    at once: each file is written under a temporary name and renamed into
    place, and the claim is an exclusive create, so exactly one shard
    merges. The staging directory belongs to one run: a later sharded run
    into the same outdir needs it gone (the merger's clean-up removes it
    unless --keeptemp).

  - through a resident rank pool (server.py): rank 0, the server's own
    process, and one worker process on each other card; each worker
    sends its rows over its own connection to rank 0, which merges. A
    rank that raises or dies fails the job at rank 0 instead of leaving
    the others in a collective.
Each shard's `extra` (its owned rows' weights and scores, where it
computed them) travels with its rows, so the merging process writes
weights.txt and the search results as the unsharded run does.

bootstrap() makes a process a rank: its card, its share of the host's
cores and, for tools/run_distributed.py, the gloo group. A process that
is a rank (the pool's and the tool's) carries a ShardJob: its shard, the
shards, how many ranks share its card (ops/plan.py:scratch_cap divides
the card's scratch among them) and, on the pool's rank 0, the hooks that
hand the job to the other ranks and gather their rows.

The device-mesh half of the reference's module (data_mesh, make_mesh,
sharded_score_bank, WITCH_TPU_NO_MESH) is parallel/mesh.py: it splits one
process's scoring over every visible card. A shard forms no mesh: each
rank keeps one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import os
import pickle
from typing import Any, Callable, List, Optional, Tuple

import numpy as np

SHARD_ENV = "WITCH_TPU_SHARD"


@dataclasses.dataclass
class ShardJob:
    """This process's place in a query-sharded job (the module
    docstring). `sharing`: the ranks on this process's card. On a rank
    pool's rank 0, `start` starts or replaces the workers (returns the
    counters of span `shards`), `dispatch` hands them the job, `check`
    raises when one has failed, and `gather(payload, extra)` returns
    every rank's (payload, extra) in rank order; on a worker, `gather`
    sends its own and returns None. `walls`: each rank's pipeline
    seconds up to the gather, once rank 0 has gathered. `have_dir`: on
    the pool's ranks, whether the job reuses a decomposition directory,
    as rank 0 found it before handing the job out (the ranks take its
    word, so rank 0 may write the decomposition while they run). A job
    that builds its ensemble builds it on the pool's rank 0, which hands
    it to the others (`send_ensemble`, bytes); each of them waits for
    it (`recv_ensemble`)."""
    rank: int
    n: int
    sharing: int = 1
    start: Optional[Callable[[], dict]] = None
    dispatch: Optional[Callable[[], None]] = None
    check: Optional[Callable[[], None]] = None
    gather: Optional[Callable[[bytes, Any], Any]] = None
    walls: Optional[List[float]] = None
    have_dir: Optional[bool] = None
    send_ensemble: Optional[Callable[[bytes], None]] = None
    recv_ensemble: Optional[Callable[[], bytes]] = None


_JOB: Optional[ShardJob] = None


@contextlib.contextmanager
def sharded(job: ShardJob):
    """Run the block as `job`'s rank (the pool's ranks, one job at a
    time)."""
    global _JOB
    prev, _JOB = _JOB, job
    try:
        yield job
    finally:
        _JOB = prev


def shard_job() -> Optional[ShardJob]:
    """The ShardJob of this process, or None."""
    return _JOB


def process_shard() -> Tuple[int, int]:
    """(shard, n_shards) of this process: WITCH_TPU_SHARD="i/n" when set
    (raises on a bad spec), else its ShardJob's, else the initialised
    torch.distributed group's (rank, world size), else (0, 1)."""
    spec = os.environ.get(SHARD_ENV)
    if spec:
        try:
            i, n = (int(x) for x in spec.split("/"))
        except ValueError:
            raise ValueError("bad %s %r: want i/n" % (SHARD_ENV, spec)) \
                from None
        if not 0 <= i < n:
            raise ValueError("bad %s %r: want 0 <= i < n" % (SHARD_ENV, spec))
        return i, n
    if _JOB is not None:
        return _JOB.rank, _JOB.n
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def card_sharers() -> int:
    """How many shards share this process's card: its ShardJob's count;
    else every shard of the job (shards staged through files may run at
    once on one card)."""
    return _JOB.sharing if _JOB is not None else process_shard()[1]


def pin_card(env: dict, k: int) -> dict:
    """`env` for a process that is to see only the k-th of the cards this
    one sees (as its cuda:0)."""
    visible = env.get("CUDA_VISIBLE_DEVICES")
    env["CUDA_VISIBLE_DEVICES"] = visible.split(",")[k] if visible else str(k)
    return env


def check_ranks():
    """On a rank pool's rank 0, raise when another rank has failed (so a
    job stops at its next stage, not at the gather); else nothing."""
    if _JOB is not None and _JOB.check is not None:
        _JOB.check()


def rank_cores(argv, n: int):
    """(argv, cores): a rank's share of the host's cores, 1/n of them,
    added to its flags as -t, for as many PyTorch CPU threads; cores is
    None where the flags already give -t (they stay as they are)."""
    if {"-t", "--num-cpus"} & set(argv):
        return list(argv), None
    cores = max(1, (os.cpu_count() or 1) // n)
    return list(argv) + ["-t", str(cores)], cores


def card_id(device) -> str:
    """The physical card behind a device of this process (its UUID where
    PyTorch gives one), or "cpu"."""
    import torch
    d = torch.device(device)
    if d.type != "cuda":
        return d.type
    idx = d.index if d.index is not None else torch.cuda.current_device()
    uuid = getattr(torch.cuda.get_device_properties(idx), "uuid", None)
    return str(uuid) if uuid is not None else "%s:%d" % (
        os.environ.get("CUDA_VISIBLE_DEVICES", ""), idx)


def bootstrap(rank: int, n: int, device, sharing: Optional[int] = None,
              init_method: Optional[str] = None) -> str:
    """Make this process rank `rank` of an n-rank job and return its
    device. With device "cuda" (or "cuda:i") it pins the card (rank mod
    the visible cards, or i) and names it by index, so that the rank
    forms no data mesh; "cpu" runs the plain versions. With init_method
    it joins the gloo group (tcp://127.0.0.1:PORT) and, unless `sharing`
    is given, counts the ranks on its card through it. The rank's cores
    come with each job's flags (rank_cores)."""
    import torch
    if str(device).startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("rank %d: --device cuda, and CUDA is not "
                               "available" % rank)
        d = torch.device(device)
        torch.cuda.set_device(d.index if d.index is not None
                              else rank % torch.cuda.device_count())
        device = "cuda:%d" % torch.cuda.current_device()
    if init_method:
        import torch.distributed as td
        td.init_process_group("gloo", init_method=init_method, rank=rank,
                              world_size=n)
        if sharing is None:
            ids = [None] * n
            td.all_gather_object(ids, card_id(device))
            sharing = ids.count(card_id(device))
    global _JOB
    _JOB = ShardJob(rank, n, sharing or 1)
    return device


def shard_indices(Q: int, shard: int, n_shards: int) -> np.ndarray:
    """Owned query indices: contiguous balanced blocks of ceil(Q / n)."""
    per = -(-Q // n_shards)
    lo = min(Q, shard * per)
    return np.arange(lo, min(Q, lo + per))


@contextlib.contextmanager
def replaced(path: str):
    """Yield a temporary name beside `path` and rename it onto `path` when
    the block ends without error: a process that reads `path` meanwhile
    (a sibling shard in the same outdir) sees the old file or the new
    one, never a partial one."""
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _group_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gather_rows(rows, ignored, shard: int, n_shards: int, outdir: str,
                extra=None):
    """Every shard's (rows, ignored) in shard order on the one merging
    process, and each shard's `extra` (any picklable) in a list:
    (rows, ignored, extras); None on the others. Through the rank pool's
    connections on its ranks; with a process group of more than one
    rank, an all-gather and rank 0 merges; otherwise the file-staged
    gather under `outdir` (the module docstring)."""
    payload = _pack_rows(rows, ignored)
    if _JOB is not None and _JOB.gather is not None:
        got = _JOB.gather(payload, extra)
        if got is None:
            return None
        return _concat(p for p, _ in got) + ([e for _, e in got],)
    if _group_size() > 1:
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (shard, payload, extra))
        if dist.get_rank() != 0:
            return None
        got.sort(key=lambda sp: sp[0])
        if [s for s, _, _ in got] != list(range(n_shards)):
            raise RuntimeError("gathered shards %s, want 0..%d"
                               % ([s for s, _, _ in got], n_shards - 1))
        return _concat(p for _, p, _ in got) + ([e for _, _, e in got],)
    # a shard's extra lands before its rows, so the merger, which sees
    # every rows file, sees every extra
    os.makedirs(outdir, exist_ok=True)
    with replaced(_extra_path(outdir, shard, n_shards)) as tmp, \
            gzip.open(tmp, "wb") as f:
        pickle.dump(extra, f)
    got = _gather_files(payload, shard, n_shards, outdir)
    if got is None:
        return None
    extras = []
    for k in range(n_shards):
        with gzip.open(_extra_path(outdir, k, n_shards), "rb") as f:
            extras.append(pickle.load(f))
    return got + (extras,)


def _extra_path(outdir: str, shard: int, n_shards: int) -> str:
    return os.path.join(outdir, "extra_shard_%d_of_%d.pkl.gz"
                        % (shard, n_shards))


def _gather_files(payload: bytes, shard: int, n_shards: int, outdir: str):
    os.makedirs(outdir, exist_ok=True)

    def path(k):
        return os.path.join(outdir, "rows_shard_%d_of_%d.bin.gz"
                            % (k, n_shards))

    with replaced(path(shard)) as tmp, gzip.open(tmp, "wb") as f:
        f.write(payload)
    # the shard whose file lands last sees every file; when two see them
    # all, the exclusive create picks one
    if not all(os.path.exists(path(k)) for k in range(n_shards)):
        return None
    try:
        fd = os.open(os.path.join(outdir, "merge_of_%d.claim" % n_shards),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return None
    os.close(fd)
    payloads = []
    for k in range(n_shards):
        with gzip.open(path(k), "rb") as f:
            payloads.append(f.read())
    return _concat(payloads)


def _concat(payloads):
    rows_all, ignored_all = [], []
    for p in payloads:
        r, i = _unpack_rows(p)
        rows_all.extend(r)
        ignored_all.extend(i)
    return rows_all, ignored_all


def _pack_rows(rows, ignored) -> bytes:
    out = ["%d\t%d" % (len(rows), len(ignored))]
    for name, row in rows:
        out.append("%s\t%s" % (name, row))
    out.extend(ignored)
    return "\n".join(out).encode("utf-8")


def _unpack_rows(payload: bytes):
    lines = payload.decode("utf-8").split("\n")
    nr, ni = (int(x) for x in lines[0].split("\t"))
    rows = []
    for line in lines[1:1 + nr]:
        name, _, row = line.rpartition("\t")
        rows.append((name, row))
    return rows, lines[1 + nr:1 + nr + ni]
