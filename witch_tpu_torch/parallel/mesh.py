"""Scoring over every visible card of one process: the data mesh, the
counterpart of witch_tpu/parallel/dist.py:31-162.

The queries are data-parallel over a 1-D list of cards (the 'data' axis),
the bank is replicated on each (it is small: K + 8 floats a model
state), and every Forward pair is computed exactly as on one card: the
kernel runs each query at its own length, and its layout
(ops/forward.py:fwd_layout) depends on the bank width alone, so which card
scores a query, and beside which others, changes none of its bits. The
sharded path is therefore bit-identical to the single-card path, and the
downstream reported-score semantics (the reporting gate, null2, top-k
weighting in pipeline.compute_scores / weighting.calculate_weights)
apply unchanged to the gathered [Q, H] matrix. Scoring needs no
collectives: each card's slice of the scores comes back to the host and
is scattered to its rows. Everything after scoring (the gate, flank, OA,
the pair-HMM embedding, the tree counts) stays on the primary card, as
in the JAX package.

The JAX package's _local_bits, _sharded_xla_step and _sharded_pallas_step
have no counterpart: they are the XLA and the Pallas halves of one
function, which csrc/forward.cu computes (ops/forward.py).

The pipeline forms the mesh (scoring_mesh) when the caller's device names
no card index, more than one card is visible, the process is one shard (a
rank of a sharded run keeps its own card: parallel/dist.py) and
WITCH_TPU_NO_MESH is unset. visible_cards is the one place that lists the
cards; the tests replace it with eight CPU entries (the JAX package's
tests score on eight virtual CPU devices), on which each slice runs the
plain version.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..ops.forward import forward_collect, forward_launch

NO_MESH_ENV = "WITCH_TPU_NO_MESH"


def visible_cards() -> List[torch.device]:
    """Every visible CUDA card, with its index; none without CUDA."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def data_mesh(n_devices: Optional[int] = None
              ) -> Optional[List[torch.device]]:
    """The 1-D mesh over every (or the first n) visible card; None when
    fewer than two are visible (the single-card path stays untouched)."""
    devs = visible_cards()
    if n_devices is not None:
        devs = devs[:n_devices]
    return devs if len(devs) > 1 else None


def make_mesh(n_devices: Optional[int] = None,
              model_parallel: Optional[int] = None) -> np.ndarray:
    """The visible cards factored into a (data, model) grid, an object
    array of torch.device (kept for experiments with bank sharding, as in
    the JAX package; scoring uses data_mesh)."""
    devs = visible_cards()
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if model_parallel is None:
        model_parallel = 1
        for m in range(int(np.sqrt(n)), 0, -1):
            if n % m == 0:
                model_parallel = m
                break
    if model_parallel < 1 or n % model_parallel:
        raise ValueError("%d devices do not factor by model_parallel %d"
                         % (n, model_parallel))
    grid = np.empty(n, object)
    grid[:] = devs
    return grid.reshape(n // model_parallel, model_parallel)


def scoring_mesh(device, n_shards: int) -> Optional[List[torch.device]]:
    """The cards a pipeline run scores over, or None for its one device.
    `device` is the caller's own argument, before resolve_device: a mesh
    forms when it is None or names the mesh's device type without an
    index ("cuda"), the process is one of n_shards == 1, WITCH_TPU_NO_MESH
    is unset and data_mesh finds two cards or more."""
    if os.environ.get(NO_MESH_ENV) or n_shards > 1:
        return None
    cards = data_mesh()
    if cards is None:
        return None
    if device is not None:
        d = torch.device(device)
        if d.index is not None or d.type != cards[0].type:
            return None
    return cards


def deal(qlens: np.ndarray, n: int) -> List[np.ndarray]:
    """Each card's query indices (ascending): the queries sorted by length,
    longest first, dealt in a snake (cards 0..n-1, then n-1..0), so that
    each card holds a near-equal share of the residues (within one query's
    length) and the same mix of lengths."""
    order = np.argsort(-np.asarray(qlens, np.int64), kind="stable")
    k = np.arange(len(order)) % (2 * n)
    card = np.where(k < n, k, 2 * n - 1 - k)
    return [np.sort(order[card == i]) for i in range(n)]


def sharded_forward_bits(banks_by_card, codes: np.ndarray,
                         qlens: np.ndarray):
    """[Q, H] pre-score bits of one bank over the mesh, the counterpart of
    witch_tpu/parallel/dist.py:sharded_score_bank; banks_by_card[i] is the
    bank on card i. Every card's slice is copied and launched (each inside
    its card's context) before any is waited on; then each card's scores
    come back and are scattered to their rows. Returns (bits, each card's
    kernel ms). A card whose launch fails raises: its slice goes nowhere
    else."""
    codes = np.asarray(codes)
    qlens = np.asarray(qlens)
    parts = deal(qlens, len(banks_by_card))
    pending = []
    for bt, idx in zip(banks_by_card, parts):
        width = max(1, int(qlens[idx].max())) if len(idx) else 1
        pending.append(forward_launch(bt, codes[idx, :width], qlens[idx]))
    out = np.empty((len(qlens), banks_by_card[0].H), np.float64)
    ms = []
    for p, idx in zip(pending, parts):
        out[idx] = forward_collect(p)
        ms.append(p.kernel_ms())
    return out, ms
