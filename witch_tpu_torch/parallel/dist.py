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

The device-mesh half of the reference's module (data_mesh, make_mesh,
sharded_score_bank, WITCH_TPU_NO_MESH) is parallel/mesh.py: it splits one
process's scoring over every visible card. A shard forms no mesh: each
rank of tools/run_distributed.py keeps one card.
"""

from __future__ import annotations

import contextlib
import gzip
import os
from typing import List, Optional, Tuple

import numpy as np

SHARD_ENV = "WITCH_TPU_SHARD"


def process_shard() -> Tuple[int, int]:
    """(shard, n_shards) of this process: WITCH_TPU_SHARD="i/n" when set
    (raises on a bad spec), else the initialised torch.distributed group's
    (rank, world size), else (0, 1)."""
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
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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


def gather_rows(rows, ignored, shard: int, n_shards: int, outdir: str
                ) -> Optional[Tuple[List[Tuple[str, str]], List[str]]]:
    """Every shard's (rows, ignored) in shard order on the one merging
    process; None on the others. With a process group of more than one
    rank, an all-gather and rank 0 merges; otherwise the file-staged
    gather under `outdir` (the module docstring)."""
    payload = _pack_rows(rows, ignored)
    if _group_size() > 1:
        import torch.distributed as dist
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (shard, payload))
        if dist.get_rank() != 0:
            return None
        got.sort(key=lambda sp: sp[0])
        if [s for s, _ in got] != list(range(n_shards)):
            raise RuntimeError("gathered shards %s, want 0..%d"
                               % ([s for s, _ in got], n_shards - 1))
        return _concat(p for _, p in got)
    return _gather_files(payload, shard, n_shards, outdir)


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
