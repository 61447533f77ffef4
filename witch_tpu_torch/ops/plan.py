"""Launch plans of the warp-per-instance kernels that store rows in
device scratch (csrc/null2.cu, csrc/oa.cu): instances (envelopes or
alignment pairs) grouped by model into CTAs, longest first, and cut into
launches by the scratch their rows need. Pure functions of lengths and
models, so the CPU tests hold them."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Plan:
    """Launches of a kernel over n instances (envelopes or pairs).

    cta_env: int32 [n_cta * wp], the instance of each warp slot of each
    CTA (-1: empty); one model per CTA, its instances longest first.
    cta0: first CTA of each launch, and n_cta at the end.
    roff: int64 [n], each instance's first scratch row in its launch.
    n_rows: scratch rows of each launch (the sum of its instances'
    lengths).
    """
    cta_env: np.ndarray
    cta0: List[int]
    roff: np.ndarray
    n_rows: List[int]

    @property
    def launches(self) -> int:
        return len(self.n_rows)


def plan_launches(lds, models, wp: int, row_bytes: int,
                  budget: int) -> Plan:
    """Group instances into CTAs and launches: a pure function of the
    instance lengths and models, the instances per CTA (wp), the scratch
    bytes of one stored row and the scratch budget of a launch.

    Each model's instances are sorted longest first (ties in input order)
    and cut into CTAs of wp; the CTAs run longest first, so the warps of a
    CTA share a model and end together, and the longest start first. A
    launch takes CTAs in that order while its instances' rows fit the
    budget (always at least one CTA); each instance's rows start at the
    prefix sum of the lengths before it in its launch."""
    lds = np.asarray(lds, np.int64)
    models = np.asarray(models, np.int64)
    n = len(lds)
    order = np.lexsort((np.arange(n), -lds, models))
    m = models[order]
    start = np.flatnonzero(np.r_[True, m[1:] != m[:-1]]) if n else \
        np.zeros(0, np.int64)
    run_of = np.cumsum(np.r_[False, m[1:] != m[:-1]]) if n else order
    rank = np.arange(n) - start[run_of]              # place in its model
    per_run = -(-np.diff(np.r_[start, n]) // wp)     # CTAs per model
    cta = np.r_[0, np.cumsum(per_run)][run_of] + rank // wp
    n_cta = int(per_run.sum()) if n else 0
    first = np.zeros(n_cta, np.int64)
    first[cta[rank % wp == 0]] = lds[order[rank % wp == 0]]
    cta_order = np.argsort(-first, kind="stable")    # longest CTAs first
    pos = np.empty(n_cta, np.int64)
    pos[cta_order] = np.arange(n_cta)
    slot = pos[cta] * wp + rank % wp
    cta_env = np.full(n_cta * wp, -1, np.int32)
    cta_env[slot] = order
    cta_rows = np.zeros(n_cta, np.int64)
    np.add.at(cta_rows, pos[cta], lds[order])
    cta0, n_rows = [], []
    rows = 0
    for t, need in enumerate(cta_rows.tolist()):
        if not cta0 or (rows + need) * row_bytes > budget:
            if cta0:
                n_rows.append(rows)
            cta0.append(t)
            rows = 0
        rows += need
    if cta0:
        n_rows.append(rows)
    cta0.append(n_cta)
    # rows of each instance: the prefix sum in slot order, less its
    # launch's first
    placed = cta_env[cta_env >= 0].astype(np.int64)
    ends = np.cumsum(lds[placed])
    launch_of = np.searchsorted(np.asarray(cta0[1:]),
                                np.flatnonzero(cta_env >= 0) // wp,
                                side="right")
    base = np.r_[0, np.cumsum(n_rows)][launch_of]
    roff = np.zeros(n, np.int64)
    roff[placed] = ends - lds[placed] - base
    return Plan(cta_env, cta0, roff, n_rows)


def scratch_cap(dev) -> int:
    """Half the memory PyTorch can still hand out on the card (free on
    the device plus its cached, unused blocks), shared out among the
    query shards on this card (parallel/dist.py:card_sharers): the most
    scratch one launch may hold. Shards on one card may measure its free
    memory at the same moment, so n of them together stay within half
    of it; a shard alone on its card keeps the whole half. Only the
    grouping of launches depends on this, not what an instance
    computes."""
    import torch

    from ..parallel.dist import card_sharers
    free, _ = torch.cuda.mem_get_info(dev)
    avail = free + torch.cuda.memory_reserved(dev) \
        - torch.cuda.memory_allocated(dev)
    return avail // (2 * card_sharers())
