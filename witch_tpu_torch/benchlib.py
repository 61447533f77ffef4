"""The bench tier: the full bench grid of bench_assets.npz (141 models in
two banks x 500 queries) through the Forward scoring kernel, timed on one
device, and the JSON line of the repository's bench.py built from it.

Counterpart of witch_tpu/benchlib.py:tpu_tier and of bench.py's emit
(the line's keys and the reference's 4-core CPU hmmsearch baseline).
load_bench_assets is the one reader of the asset file in the port
(tools/forward_bench.py and chip_smoke.py use it too).
"""

from __future__ import annotations

import time

import numpy as np

# the reference WITCH's all-vs-all `hmmsearch --max` on the bench grid:
# 236.2 CPU-seconds on 4 cores (bench.py:29), in query-model pairs/s
BASELINE_PAIRS_PER_S = 70500 / (236.2 / 4)
BANK_FIELDS = ("em_odds", "t_mm", "t_mi", "t_md", "t_im", "t_ii",
               "t_dm", "t_dd", "bm", "M", "nseq", "hmm_indices")
NATIVE_ROWS = ("t_mm", "t_mi", "t_md", "t_im", "t_ii", "t_dm", "t_dd", "bm")


def load_bench_assets(path):
    """(banks [hmm/bank.py:ProfileBank], the npz) of an asset file
    written by scripts/make_bench_assets.py: per bank i the fields
    bank{i}_{field}, and codes [Q, L], lens [Q], true_states."""
    from .hmm.bank import ProfileBank
    z = np.load(path)
    banks = [ProfileBank(**{f: z["bank%d_%s" % (i, f)] for f in BANK_FIELDS},
                         multihit=bool(z["bank%d_multihit" % i]))
             for i in range(int(z["n_banks"]))]
    return banks, z


def native_args_from_bank(bank, h):
    """The native engine's f64 arguments (msc and the 8 transition rows,
    logs) of bank row h, from its odds (log recovers the profile)."""
    M = int(bank.M[h])
    with np.errstate(divide="ignore"):
        return [np.ascontiguousarray(np.log(np.asarray(
            x[h, :M + 1], np.float64))) for x in
            [bank.em_odds] + [getattr(bank, a) for a in NATIVE_ROWS]]


def _sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def bench_tier(assets_path: str, reps: int = 3, device=None) -> dict:
    """Time the full-grid Forward scoring (every bank, every query) on
    `device` (CUDA unless the caller passes another): one warm call, then
    `reps` timed calls, the device synchronised before each clock read.

    Returns {"dt": seconds per full grid, "padded_cells": cells at the
    kernels' padded shapes, "total_pairs": Q * H, "true_cells": the
    queries' residues x the models' states, "backend": the device type
    ("cuda"), "warm_s": seconds of the warm call}."""
    import torch

    from .device import bank_to_torch, resolve_device
    from .ops.forward import forward_nats
    device = resolve_device(device)
    banks, z = load_bench_assets(assets_path)
    codes, lens = z["codes"], z["lens"]
    c = torch.from_numpy(np.ascontiguousarray(codes, np.int32)).to(device)
    ln = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(device)
    bts = [bank_to_torch(b, device) for b in banks]
    Q = len(lens)

    def run():
        for bt in bts:
            forward_nats(bt, c, ln)

    t0 = time.time()
    run()
    _sync(device)
    warm_s = time.time() - t0
    _sync(device)
    t0 = time.time()
    for _ in range(reps):
        run()
    _sync(device)
    dt = (time.time() - t0) / reps
    return {
        "dt": dt,
        "padded_cells": sum(Q * codes.shape[1] * bt.Mp * bt.H for bt in bts),
        "total_pairs": Q * sum(bt.H for bt in bts),
        "true_cells": int(lens.sum()) * int(z["true_states"]),
        "backend": device.type,
        "warm_s": warm_s,
    }


def domaindef_pairs_per_s(assets_path: str, n_queries: int = 100,
                          threads: int = 4) -> float:
    """The native engine's domain definition (regions, trace ensembles,
    exact null2, f64 Forward) of the first model against the first
    n_queries queries on `threads` threads, in pairs/s (bench.py:41-67)."""
    from .native import _domaindef
    banks, z = load_bench_assets(assets_path)
    codes, lens = z["codes"], z["lens"]
    clist = [np.ascontiguousarray(codes[i, :lens[i]], np.int32)
             for i in range(min(len(lens), n_queries))]
    args = native_args_from_bank(banks[0], 0)
    t0 = time.time()
    _domaindef.evaluate_targets(*args, clist, 42, 200, 1, threads)
    return len(clist) / (time.time() - t0)


def bench_line(tier: dict, domaindef_rate=None) -> dict:
    """bench.py's JSON line (its keys, bench.py:70-80) from a bench_tier
    result and the native domain-definition rate."""
    dt = tier["dt"]
    pairs_per_s = tier["total_pairs"] / dt
    line = {
        "metric": "forward_scoring_pairs_per_s",
        "value": pairs_per_s,
        "unit": "query-HMM pairs/s (141-HMM eHMM x 500 queries, 1 card)",
        "vs_baseline": pairs_per_s / BASELINE_PAIRS_PER_S,
        "gcups_true": tier["true_cells"] / dt / 1e9,
        "gcups_padded": tier["padded_cells"] / dt / 1e9,
        "seconds_per_full_grid": dt,
        "backend": tier["backend"],
    }
    if domaindef_rate is not None:
        line["domaindef_pairs_per_s_4t"] = domaindef_rate
    return line
