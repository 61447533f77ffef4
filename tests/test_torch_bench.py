"""The port's bench tier (witch_tpu_torch/benchlib.py, tools/bench.py) on
the CPU at a cut grid: the counts it reports come from the asset file,
its JSON line has the keys of the repository's bench.py, and the tool
refuses to run without a card. Times on the CPU are not checked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from witch_tpu_torch.benchlib import (BANK_FIELDS, bench_line, bench_tier,
                                      domaindef_pairs_per_s,
                                      load_bench_assets)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ASSETS = os.path.join(ROOT, "bench_assets.npz")
# bench.py's JSON line (bench.py:70-80, domaindef_pairs_per_s_4t :66)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "gcups_true",
              "gcups_padded", "seconds_per_full_grid", "backend",
              "domaindef_pairs_per_s_4t"}


def write_cut_assets(path, n_models=3, n_queries=4):
    """bench_assets.npz cut to the first n_models of its first bank and
    its first n_queries queries, in the same format."""
    banks, z = load_bench_assets(ASSETS)
    b = banks[0]
    blob = {"n_banks": np.int32(1), "bank0_multihit": np.bool_(b.multihit)}
    for f in BANK_FIELDS:
        blob["bank0_" + f] = np.asarray(getattr(b, f))[:n_models]
    lens = z["lens"][:n_queries]
    blob["codes"] = z["codes"][:n_queries, :int(lens.max())]
    blob["lens"] = lens
    blob["true_states"] = np.int64(int(np.asarray(b.M)[:n_models].sum()))
    np.savez_compressed(path, **blob)
    return path


def test_assets_load():
    banks, z = load_bench_assets(ASSETS)
    assert sum(b.H for b in banks) == 141 and len(z["lens"]) == 500
    assert int(z["true_states"]) == int(sum(np.asarray(b.M).sum()
                                            for b in banks))


def test_bench_tier_counts_on_a_cut_grid(tmp_path):
    path = write_cut_assets(str(tmp_path / "cut.npz"))
    z = np.load(path)
    out = bench_tier(path, reps=1, device="cpu")
    assert set(out) == {"dt", "padded_cells", "total_pairs", "true_cells",
                        "backend", "warm_s"}
    Q, H = len(z["lens"]), len(z["bank0_M"])
    assert out["total_pairs"] == Q * H
    assert out["true_cells"] == int(z["lens"].sum()) * int(z["true_states"])
    assert out["padded_cells"] >= out["true_cells"]
    assert out["backend"] == "cpu" and out["dt"] > 0


def test_bench_line_has_bench_py_keys(tmp_path):
    path = write_cut_assets(str(tmp_path / "cut.npz"))
    tier = bench_tier(path, reps=1, device="cpu")
    line = bench_line(tier, domaindef_pairs_per_s(path, n_queries=4,
                                                  threads=1))
    assert set(line) == BENCH_KEYS
    assert line["value"] == pytest.approx(tier["total_pairs"] / tier["dt"])
    assert line["seconds_per_full_grid"] == tier["dt"]
    assert line["domaindef_pairs_per_s_4t"] > 0


def test_bench_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, os.path.join(
        ROOT, "witch_tpu_torch", "tools", "bench.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CUDA" in r.stderr
    assert "{" not in r.stdout
