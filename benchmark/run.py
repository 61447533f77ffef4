"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is a configuration (a backbone alignment and tree, configs/) under
a traffic mix (traffic/): WITCH jobs run back to back in this process,
each through the job path that `python -m witch_tpu_torch serve` runs
(witch_tpu_torch.server._run_job), as one closed-loop client that
submits its next batch of fragments once the last one is placed.

Set-up (setup_s: process start to window start): the imports, the
kernels and the native engine from their caches under build/, the
configuration's backbone and tree (made once into build/benchmark_data/),
the run's fragments from --seed, for a cell that reuses a decomposition
(-p) the decomposition built by the port, and one small warm job of the
cell's own kind. Then jobs start while the window is open; the last one
runs to its end. queries_per_s is the fragments of the window's jobs
over the time from the window's start to the last job's end.

With --trace 1 the card's activity over the window is recorded
(torch.profiler, CUDA activity only) and the per-layer metrics are
printed instead of the end-to-end ones.

After the window the outputs of a seeded sample of each job's fragments
are compared with the plain reference (check.py); the numbers compared
and their limits are printed last on standard error and under "checks"
in the result, the last line of standard output.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's kernel caches stay inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, "build", "benchmark_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "witch_tpu")


def process_start_epoch() -> float:
    """When this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = float(fields[19])
        with open("/proc/stat") as f:
            btime = next(float(l.split()[1]) for l in f
                         if l.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_PROCESS = process_start_epoch()


def say(*a):
    print(*a, file=sys.stderr, flush=True)


class Job:
    def __init__(self, k, n, t0, t1, lines, ok, host):
        self.k, self.n, self.ok = k, n, ok
        self.t0, self.t1 = t0, t1          # epoch seconds
        self.wall_s = t1 - t0
        self.lines = lines
        self.host = host                   # host_load over the job


def host_load(t0, t1, wall_s):
    """This process's CPU seconds between two os.times() readings, and
    how many cores that is over the wall time. The host's per-core speed
    moves with its other tenants' load: the same work then takes more
    CPU seconds."""
    cpu = (t1.user + t1.system) - (t0.user + t0.system)
    return cpu, cpu / wall_s if wall_s > 0 else 0.0


def load_text(load):
    return "process %.2f CPU s, %.2f cores" % load


class RunData:
    """What the per-layer metrics read (readers.py)."""

    def __init__(self, jobs, n_fragments):
        self.jobs = jobs
        self.n_fragments = n_fragments
        self.kernels = None
        self.busy_s = None
        self.window_s = None
        self.forward_work = None


def load_spec(root):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        return json.load(f)


def cell_of(spec, name):
    for w in spec["workloads"]:
        if w["name"] == name:
            cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
            return w, cfg
    raise SystemExit("unknown workload %r (BENCHMARK.json lists %s)"
                     % (name, ", ".join(w["name"] for w in spec["workloads"])))


def read_json(path):
    with open(path) as f:
        return json.load(f)


def model_lengths(hmmdir):
    """M (LENG) of every hmmbuild.model.* under a decomposition directory."""
    out = []
    for d in sorted(os.listdir(hmmdir)):
        sub = os.path.join(hmmdir, d)
        if not (d.startswith("A_0_") and os.path.isdir(sub)):
            continue
        for fn in os.listdir(sub):
            if fn.startswith("hmmbuild.model."):
                with open(os.path.join(sub, fn)) as f:
                    for line in f:
                        if line.startswith("LENG"):
                            out.append(int(line.split()[1]))
                            break
    return out


def results_files(hmmdir):
    if not os.path.isdir(hmmdir):
        return []
    return [os.path.join(dp, fn) for dp, _, fns in os.walk(hmmdir)
            for fn in fns if fn.startswith("hmmsearch.results.")]


class Cell:
    """One cell's data, job arguments and job loop."""

    def __init__(self, root, workload, config_entry, seed, device, workdir):
        from . import datagen
        self.root = root
        self.name = workload["name"]
        self.config = read_json(os.path.join(root, config_entry["file"]))
        self.traffic = read_json(os.path.join(
            root, "benchmark", "traffic", workload["traffic"] + ".json"))
        self.seed = seed
        self.device = device
        self.workdir = workdir
        tr = self.traffic
        self.bb_dir, self.bb_names, self.bb_codes = datagen.ensure_backbone(
            self.config, os.path.join(root, "build", "benchmark_data"))
        self.backbone = os.path.join(self.bb_dir, "backbone.aln.fasta.gz")
        self.tree = os.path.join(self.bb_dir, "backbone.tre")
        per = tr["fragments_per_job"]
        warm = tr["warm_fragments"]
        frags = datagen.make_fragments(
            self.bb_codes, seed, tr["max_jobs"], per, tr["fraction"][0],
            tr["fraction"][1])
        warm_frags = datagen.make_fragments(
            self.bb_codes, [seed, 1], 1, warm, tr["fraction"][0],
            tr["fraction"][1])[0]
        self.window_frags = frags
        self.warm_frags = warm_frags
        self.hmmdir = None
        self.models = None

    # ---- set-up ----
    def build_decomposition(self):
        """-p cells: the decomposition built by the port, once, in set-up."""
        from witch_tpu_torch.core.alignment import PackedAlignment
        from witch_tpu_torch.ensemble import build_ensemble, write_decomposition
        w = self.config["witch"]
        backbone = PackedAlignment.from_fasta(self.backbone,
                                              molecule=self.config["molecule"])
        # as many build threads as the CLI's default (-t: every core)
        ens = build_ensemble(backbone, self.tree, w["alignment_size"], None,
                             self.config["molecule"],
                             n_workers=os.cpu_count() or 1)
        self.hmmdir = os.path.join(self.workdir, "decomposition")
        write_decomposition(ens, self.hmmdir)
        self.models = model_lengths(self.hmmdir)

    def argv(self, qpath, outdir):
        w = self.config["witch"]
        a = ["-b", self.backbone, "-e", self.tree, "-q", qpath, "-d", outdir,
             "-o", "aligned.fasta", "-m", w["mode"],
             "-A", str(w["alignment_size"]), "-k", str(w["num_hmms"]),
             "--save-weight", "1"]
        if self.traffic["reuse_decomposition"]:
            a += ["-p", self.hmmdir, "--keep-decomposition", "0"]
        return a + list(self.traffic.get("argv", []))

    # ---- one job ----
    def run_job(self, k, frags, names):
        from witch_tpu_torch import _build
        from witch_tpu_torch.config import Configs
        from witch_tpu_torch.server import _run_job
        outdir = os.path.join(self.workdir, "job%04d" % k)
        os.makedirs(outdir)
        qpath = os.path.join(outdir, "queries.fasta")
        with open(qpath, "w") as f:
            for n, s in zip(names, frags):
                f.write(">%s\n%s\n" % (n, s))
        if self.hmmdir is not None and results_files(self.hmmdir):
            # a results file there would be reused as this job's scores
            raise SystemExit("the -p directory %s holds a search-results "
                             "file before job %d" % (self.hmmdir, k))
        _build.reset_launches()
        Configs.scoring_cards = None
        ok = True
        h0 = os.times()
        t0 = time.time()
        try:
            _run_job(self.argv(qpath, outdir), self.device)
        except (Exception, SystemExit):  # noqa: BLE001 - a failed job counts
            ok = False
            say("job %d raised:\n%s" % (k, traceback.format_exc()[-4000:]))
        t1 = time.time()
        host = host_load(h0, os.times(), t1 - t0)
        from .stages import parse_lines
        rt = os.path.join(outdir, "runtime_breakdown.txt")
        lines = parse_lines(open(rt).read()) if os.path.exists(rt) else []
        return Job(k, len(frags), t0, t1, lines, ok, host), outdir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = ap.parse_args(argv)
    spec = load_spec(ROOT)
    workload, cfg = cell_of(spec, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(workload["chips"]):
        say("no CUDA card, or fewer than the %d the cell asks for: "
            "nothing measured" % workload["chips"])
        return 3
    result = run(spec, workload, cfg, args.seed, args.seconds, args.trace,
                 device=None, root=ROOT)
    return 0 if result is not None else 1


def run(spec, workload, cfg, seed, seconds, trace, device=None, root=ROOT):
    """One run of a cell; prints the result line and returns it (None when
    no result may be printed). device=None scores on the card, as
    `serve` does; device="cpu" runs the kernels' plain versions (the
    CPU dry run of the tests)."""
    from . import check as check_mod
    say("host: %d cores" % (os.cpu_count() or 0))
    workdir = tempfile.mkdtemp(prefix="witch-bench-")
    try:
        return _run(spec, workload, cfg, seed, seconds, trace, device, root,
                    workdir, check_mod)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(spec, workload, cfg, seed, seconds, trace, device, root, workdir,
         check_mod):
    import torch
    from witch_tpu_torch import _build  # noqa: F401 - set-up: the imports
    from witch_tpu_torch import server  # noqa: F401
    on_card = device is None or str(device).startswith("cuda")
    if on_card:
        _build.lib()
    from witch_tpu_torch.native import _domaindef, _oa  # noqa: F401
    cell = Cell(root, workload, cfg, seed, device, workdir)
    if cell.traffic["reuse_decomposition"]:
        cell.build_decomposition()
    checker = check_mod.Checker(cell, seed)
    # warm job: the cell's own kind, a few dozen fragments
    names = ["W%04d" % i for i in range(len(cell.warm_frags))]
    job, outdir = cell.run_job(0, cell.warm_frags, names)
    if not job.ok:
        say("the warm job failed: nothing measured")
        return None
    if cell.models is None:
        cell.models = model_lengths(os.path.join(outdir, "tree_decomp",
                                                 "root"))
    shutil.rmtree(outdir, ignore_errors=True)
    if on_card:
        torch.cuda.synchronize()

    tracer = None
    if trace:
        from .trace import Tracer
        tracer = Tracer(os.path.join(workdir, "trace.json"), on_card)
    if tracer:
        tracer.start()      # the profiler's own start-up stays outside
    h_win = os.times()
    t_win = time.time()
    setup_s = t_win - T_PROCESS
    from .stages import short_name
    jobs, frag_lens = [], []
    k = 0
    while time.time() - t_win < seconds:
        if k >= len(cell.window_frags):
            raise SystemExit(
                "ran out of fragments after %d jobs: traffic %s's max_jobs "
                "is too small for this program" % (k, workload["traffic"]))
        frags = cell.window_frags[k]
        names = ["J%03dQ%05d" % (k, i) for i in range(len(frags))]
        job, outdir = cell.run_job(k + 1, frags, names)
        checker.collect(k, job, outdir, names, frags)
        say("job %d: %d fragments in %.3f s (%s): %s" % (
            k, job.n, job.wall_s, load_text(job.host), ", ".join(
                "%s %.3f" % (short_name(label), s) for label, s in job.lines
                if not label.startswith("Total"))))
        shutil.rmtree(outdir, ignore_errors=True)
        jobs.append(job)
        frag_lens.extend(len(s) for s in frags)
        k += 1
    t_end = time.time()
    win_load = host_load(h_win, os.times(), t_end - t_win)
    if tracer:
        tracer.stop()
    n_frag = sum(j.n for j in jobs)
    window_s = t_end - t_win
    mem_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    data = RunData(jobs, n_frag)
    from .roofline import forward_work
    data.forward_work = forward_work(frag_lens, cell.models)
    breakdown = None
    if tracer:
        from . import trace as trace_mod
        from .stages import OVERLAPPED_SPEC, OVERLAPPED_WRITER, intervals
        overl = set(OVERLAPPED_SPEC)
        if not cell.traffic["reuse_decomposition"]:
            overl |= OVERLAPPED_WRITER
        events = tracer.events(t_win * 1e6)
        jobs_us = [(j.t0 * 1e6, j.t1 * 1e6,
                    [(s * 1e6, e * 1e6, n) for s, e, n in
                     intervals(j.lines, j.t1)], overl) for j in jobs]
        files = trace_mod.kernel_files(os.path.join(
            root, "witch_tpu_torch", "csrc"))
        busy_s, win_s, by_kernel, breakdown = trace_mod.reduce(
            events, t_win * 1e6, t_end * 1e6, jobs_us, files)
        if on_card:
            data.kernels, data.busy_s = by_kernel, busy_s
            data.window_s = win_s

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if workload["name"] not in m.get("workloads",
                                             [workload["name"]]):
                continue
            mod = importlib.import_module("benchmark.metrics." + m["name"])
            v = mod.read(data)
            if v is None:
                # a renamed stage line or kernel must not drop a yardstick
                say("per-layer metric %s found nothing to read in %s, "
                    "which lists it: no result" % (m["name"],
                                                   workload["name"]))
                return None
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics["queries_per_s"] = {
            "value": n_frag / window_s if window_s > 0 else 0.0,
            "unit": "queries/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    failed = checker.missing
    device_info = device_summary(on_card, workload, mem_peak)
    if tracer and on_card:
        device_info["busy_s"] = data.busy_s
        device_info["window_s"] = data.window_s
    say("window: %d jobs, %d fragments in %.3f s; set-up %.3f s; device "
        "peak %d bytes; host over the window: %s" % (
            len(jobs), n_frag, window_s, setup_s, mem_peak,
            load_text(win_load)))

    # the comparison with the plain reference, once the program is done
    correct, checks = checker.verify()
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        say("modules that may not load in this process: %s" % loaded)
        return None
    for name, c in checks.items():
        say("check %s: %r (limit %r)" % (name, c["value"], c["limit"]))
    result = {"correct": bool(correct), "attempted": n_frag,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return result


def device_summary(on_card, workload, mem_peak):
    import torch
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(workload["chips"]), "memory_peak_bytes": mem_peak}
    try:
        import subprocess
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(r.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    info["host_cores"] = os.cpu_count()
    return info


if __name__ == "__main__":
    __package__ = "benchmark"
    import benchmark  # noqa: F401 - the package the relative imports need
    sys.exit(main())
