"""A tiny cell run end to end on the CPU (device="cpu": the kernels' plain
versions): the whole control flow, the last line, the comparison with the
reference, the faults it has to catch, the -p results-file guard and the
isolation of what runs from JAX and the JAX package."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
TINY = {"sequences": 40, "columns": 600, "seed": 5}
# jobs of 8 fragments, each job building its ensemble (d1000's kind)
TINY_D8 = {"fragments_per_job": 8, "fraction": [0.15, 0.6],
           "warm_fragments": 4, "max_jobs": 100,
           "reuse_decomposition": False, "argv": [],
           "check_candidates_per_job": 2, "check_decided": 2}


def tiny_spec(root, traffic):
    """A spec and root holding a tiny configuration of dna1k's kind under
    a committed traffic mix, or d8 (TINY_D8); a short window on the CPU
    holds a job or two, so two decided fragments are enough. The cell
    lists the stage metrics, and no device metric, which a CPU run cannot
    read."""
    with open(os.path.join(BENCH, "configs", "dna1k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", backbone=dict(cfg["backbone"], **TINY))
    os.makedirs(os.path.join(root, "cfg"), exist_ok=True)
    with open(os.path.join(root, "cfg", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    mix = TINY_D8
    if traffic != "d8":
        with open(os.path.join(BENCH, "traffic", traffic + ".json")) as f:
            mix = dict(json.load(f), check_decided=2)
    tdir = os.path.join(root, "benchmark", "traffic")
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(tdir, traffic + ".json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"] = [{"name": "tiny", "file": "cfg/tiny.json"}]
    wl = {"name": "tiny." + traffic, "config": "tiny", "traffic": traffic,
          "chips": 1}
    spec["workloads"] = [wl]
    for m in spec["per_layer"]:
        m["workloads"] = [] if m["source"] == "device_trace" \
            else [wl["name"]]
    return spec, wl


DRIVER = """
import json, sys
sys.path.insert(0, %(root)r)
from benchmark import run as R
spec = json.loads(%(spec)r)
wl = spec["workloads"][0]
res = R.run(spec, wl, spec["configs"][0], %(seed)d, %(seconds)r, %(trace)d,
            device="cpu", root=%(tmp)r)
bad = sorted({m.split(".")[0] for m in sys.modules}
             & {"jax", "jaxlib", "flax", "witch_tpu"})
print("FORBIDDEN", json.dumps(bad))
"""


def dry_run(tmp_path, traffic, seed, seconds=3.0, trace=0):
    spec, _ = tiny_spec(str(tmp_path), traffic)
    code = DRIVER % dict(root=ROOT, spec=json.dumps(spec), seed=seed,
                         seconds=seconds, trace=trace, tmp=str(tmp_path))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    out = r.stdout.strip().splitlines()
    assert out[-1].startswith("FORBIDDEN")
    return json.loads(out[-2]), json.loads(out[-1].split(" ", 1)[1]), \
        r.stderr


def test_dry_run_d8_prints_a_well_formed_correct_line(tmp_path):
    res, forbidden, err = dry_run(tmp_path, "d8", 2 ** 31 + 77)
    assert forbidden == []
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 8 and res["failed"] == 0
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    assert res["metrics"]["queries_per_s"]["unit"] == "queries/s"
    assert res["metrics"]["queries_per_s"]["value"] > 0
    assert res["device"]["platform"] == "cpu"
    assert res["checks"]["decided_short"]["value"] == 0
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert "check %s:" % name in err
    assert res["correct"], res["checks"]
    # nothing of the run is left in TMPDIR
    assert not glob.glob(str(tmp_path / "witch-bench-*"))


def test_dry_run_p20_traced_reuses_the_decomposition(tmp_path):
    """Every -p job is checked for a search-results file before it starts
    (the run would stop); the traced run prints the stage metrics and no
    device number."""
    res, forbidden, err = dry_run(tmp_path, "p20", 991, seconds=4.0,
                                  trace=1)
    assert forbidden == []
    m = res["metrics"]
    assert {"ensemble_ms_per_query", "bank_ms_per_query",
            "align_ms_per_query", "merge_ms_per_query",
            "other_ms_per_query"} <= set(m)
    assert not {"device_idle_pct", "forward_roofline",
                "forward_kernel_ms_per_query"} & set(m)
    assert "busy_s" not in res["device"]
    assert res["correct"], res["checks"]


def test_p_job_refuses_a_results_file(tmp_path):
    from benchmark import run as R
    spec, wl = tiny_spec(str(tmp_path), "p20")
    cell = R.Cell(str(tmp_path), wl, spec["configs"][0], 3, "cpu",
                  str(tmp_path))
    cell.hmmdir = str(tmp_path / "decomp")
    os.makedirs(os.path.join(cell.hmmdir, "A_0_0"))
    with open(os.path.join(cell.hmmdir, "A_0_0",
                           "hmmsearch.results.A_0_0.fragment_chunk_0"),
              "w") as f:
        f.write("{}")
    with pytest.raises(SystemExit, match="search-results"):
        cell.run_job(1, ["ACGT" * 10], ["Q1"])
    assert "--keep-decomposition" in cell.argv("q.fa", "out")
    i = cell.argv("q.fa", "out").index("--keep-decomposition")
    assert cell.argv("q.fa", "out")[i + 1] == "0"


FAULT_DRIVER = """
import json, sys
sys.path.insert(0, %(root)r)
import numpy as np
from witch_tpu_torch import aligner, pipeline
fault = %(fault)r
if fault == "row":
    # an answer altered where it is produced: each row's first placed
    # residue becomes another base
    orig = aligner.align_query_row
    nxt = {"A": "C", "C": "G", "G": "T", "T": "A"}
    def altered(seq, L, per_hmm):
        row = orig(seq, L, per_hmm)
        for i, ch in enumerate(row):
            if ch in nxt:
                return row[:i] + nxt[ch] + row[i + 1:]
        return row
    aligner.align_query_row = altered
elif fault == "half":
    # half of each job's fragments left out
    orig = pipeline._encode_queries
    def half(path, alphabet):
        names, seqs, codes, renamed = orig(path, alphabet)
        n = max(1, len(names) // 2)
        return names[:n], seqs[:n], codes[:n], renamed
    pipeline._encode_queries = half
from benchmark import run as R
spec = json.loads(%(spec)r)
wl = spec["workloads"][0]
res = R.run(spec, wl, spec["configs"][0], 424242, 2.0, 0, device="cpu",
            root=%(tmp)r)
"""


@pytest.mark.parametrize("fault", ["row", "half"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    spec, _ = tiny_spec(str(tmp_path), "d8")
    code = FAULT_DRIVER % dict(root=ROOT, spec=json.dumps(spec),
                               fault=fault, tmp=str(tmp_path))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is False
    key = "row_mismatch" if fault == "row" else "missing"
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_jax_or_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py")) + \
        [os.path.join(BENCH, "compare.py"), os.path.join(BENCH, "control.py")]
    for path in files:
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "witch_tpu",
                                     "witch_tpu_torch"}
        assert not bad, (path, bad)


def test_nothing_in_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "witch_tpu"}
        assert not bad, (path, bad)


def test_a_listed_metric_that_reads_nothing_prints_no_result(tmp_path):
    """A per-layer metric that the cell lists and that finds nothing to
    read (here a kernel, on a CPU run; elsewhere a renamed stage line or
    kernel) leaves the run without a result line."""
    spec, wl = tiny_spec(str(tmp_path), "d8")
    for m in spec["per_layer"]:
        if m["name"] == "forward_kernel_ms_per_query":
            m["workloads"] = [wl["name"]]
    code = DRIVER % dict(root=ROOT, spec=json.dumps(spec), seed=6061,
                         seconds=1.0, trace=1, tmp=str(tmp_path))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-4000:]
    assert not any(l.startswith("{") for l in r.stdout.splitlines())
    assert "forward_kernel_ms_per_query found nothing to read" in r.stderr


def test_fragments_ignored_wrongly_are_not_correct(tmp_path):
    """A program that places nothing (every fragment in the ignored list,
    no weights) is caught even where the weights would not be compared."""
    from benchmark import compare
    from benchmark.reference import hmmbuild
    from benchmark.reference.witch import Reference
    from benchmark import datagen
    names, codes, tree = datagen.make_backbone(40, 600, 5)
    models = hmmbuild.ensemble(names, codes, tree, 10)
    frags = datagen.make_fragments(codes, 12, 1, 2, 0.15, 0.6)[0]
    samples = [(0, "Q%d" % i, f, None, None, {}) for i, f in enumerate(frags)]
    nums = compare.sample_numbers(Reference(models, "cpu"), samples, 10,
                                  codes.shape[1], scores_persisted=False,
                                  decided=2)
    assert nums["row_mismatch"] == 2


class _Undecided:
    """A reference that leaves every fragment's weights undecided, as
    HMMER's stochastic trace ensemble does to multi-domain regions."""

    idx = [0]

    def __init__(self):
        self.calls = []

    def weights(self, codes, num_hmms):
        import numpy as np
        self.calls.append(len(codes))
        q = len(codes)
        return ([None] * q, None, np.full((q, 1), np.nan),
                np.zeros((q, 1), bool))

    def columns(self, pairs):
        return []


def test_a_run_whose_samples_are_all_undecided_is_not_correct():
    """The candidates are taken until the cell's number of decided
    fragments is reached; where they run out first the run has compared
    too few weights and is not correct."""
    from benchmark import compare
    ref = _Undecided()
    samples = [(0, "Q%d" % i, "ACGT", None, None, {}) for i in range(5)]
    nums = compare.sample_numbers(ref, samples, 10, 600,
                                  scores_persisted=True, decided=3)
    assert ref.calls == [3, 2]
    assert nums.pop("taken") == 5 and nums["decided_short"] == 3
    checks = {k: {"value": float(v), "limit": compare.LIMITS[k]}
              for k, v in nums.items()}
    assert checks["weight_gap"]["value"] == 0.0      # nothing compared
    assert not compare.passes(checks)
