"""Readers of the program's spans (witch_tpu_torch/spans.py) over a traced
window, and a traced run of a cell that records them.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

It runs the cell as `run.py --trace 1` does, with the program's span
recording on over the traced window (from the profiler's start to its
stop), and prints on standard error the five span metrics below, each
span name's count, wall and thread CPU seconds and the totals of its
counters, the device's idle time by the span open on each job's main
thread (with the side threads' spans open beside it), and the clock
check: how many intervals of the forward, null2 and OA kernels lie
outside the span that launched them on the epoch clock, and by how much
at worst. Its last line on standard output is the readings as JSON.

A span here is the program's export (spans.record(False)): a dict with
id, parent, job, name, tid, start_us, end_us (epoch microseconds),
cpu_us (its thread's CPU time) and counters. Each reader returns None
where it finds nothing to read, never 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the threads a job starts beside its main thread, by their span
SIDE = ("writer", "spec_oa", "gate.null2", "gate.f64")
# the spans that launch each kernel checked against the device trace
LAUNCHERS = {"fwd_kernel": ("scoring.forward",),
             "null2_kernel": ("gate.null2",),
             "oa_warp_kernel": ("spec_oa", "align"),
             "oa_trace_kernel": ("spec_oa", "align"),
             "oa_kernel": ("spec_oa", "align")}


class Tree:
    """The spans by id and each span's children."""

    def __init__(self, spans):
        self.spans = list(spans)
        self.by_id = {s["id"]: s for s in self.spans}
        self.kids = {}
        for s in self.spans:
            if s["parent"] is not None:
                self.kids.setdefault(s["parent"], []).append(s)

    def parent(self, s):
        return self.by_id.get(s["parent"])

    def subtree(self, root):
        out, todo = [], [root]
        while todo:
            s = todo.pop()
            out.append(s)
            todo.extend(self.kids.get(s["id"], ()))
        return out

    def named(self, name):
        return [s for s in self.spans if s["name"] == name]

    def topmost_on_thread(self, s, root):
        """True when no span between s and root (root included) is on
        s's thread."""
        a = s
        while a is not root:
            a = self.parent(a)
            if a["tid"] == s["tid"]:
                return False
        return True

    def fragments(self):
        """Fragments of the jobs in the list, or None without a job."""
        jobs = self.named("job")
        n = sum(j["counters"].get("fragments", 0) for j in jobs)
        return n if jobs and n else None


def _wall(s):
    return s["end_us"] - s["start_us"]


def covered_us(intervals, lo, hi):
    """Microseconds of [lo, hi] that the (start, end) intervals cover."""
    iv = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                if b > lo and a < hi)
    total, end = 0.0, lo
    for a, b in iv:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def host_cores(spans, name):
    """Thread CPU time over wall time of the spans called `name`: for
    each, the CPU of its subtree (on each thread, the subtree's topmost
    spans on that thread, so that no nested span counts twice), summed
    over the spans, over the sum of their walls. None where a span has
    no CPU time (opened before recording started)."""
    tree = Tree(spans)
    cpu = wall = 0.0
    roots = tree.named(name)
    for root in roots:
        wall += _wall(root)
        for s in tree.subtree(root):
            if tree.topmost_on_thread(s, root):
                if s["cpu_us"] is None:
                    return None
                cpu += s["cpu_us"]
    return cpu / wall if roots and wall > 0 else None


def writer_ms_per_query(spans):
    """The decomposition writer's time less its wait for the banks, in ms
    a fragment."""
    tree = Tree(spans)
    writers = tree.named("writer")
    frags = tree.fragments()
    if not writers or frags is None:
        return None
    us = sum(_wall(w) - sum(_wall(c) for c in tree.kids.get(w["id"], ())
                            if c["name"] == "writer.wait")
             for w in writers)
    return us / 1e3 / frags


def pipeline_self_ms_per_query(spans):
    """Each job's wall that none of its direct children on the job's own
    thread covers, in ms a fragment."""
    tree = Tree(spans)
    frags = tree.fragments()
    if frags is None:
        return None
    us = 0.0
    for j in tree.named("job"):
        kids = [(c["start_us"], c["end_us"])
                for c in tree.kids.get(j["id"], ()) if c["tid"] == j["tid"]]
        us += _wall(j) - covered_us(kids, j["start_us"], j["end_us"])
    return us / 1e3 / frags


METRICS = {
    "overlay_host_cores": lambda sp: host_cores(sp, "scoring.overlay"),
    "gate_host_cores": lambda sp: host_cores(sp, "scoring.gate"),
    "ensemble_host_cores": lambda sp: host_cores(sp, "ensemble"),
    "writer_ms_per_query": writer_ms_per_query,
    "pipeline_self_ms_per_query": pipeline_self_ms_per_query,
}


def by_name(spans):
    """[(name, count, wall s, thread CPU s, {counter: total})] of every
    span name, by wall (a nested span's time is also its parent's; a span
    without CPU time adds none). The counters (pairs, models, launches,
    kernel_ms, ...) are summed over the name's spans."""
    out = {}
    for s in spans:
        n, w, c, tot = out.get(s["name"], (0, 0.0, 0.0, {}))
        for k, v in s["counters"].items():
            tot[k] = tot.get(k, 0) + v
        out[s["name"]] = (n + 1, w + _wall(s) / 1e6,
                          c + (s["cpu_us"] or 0.0) / 1e6, tot)
    return sorted(((k,) + v for k, v in out.items()), key=lambda r: -r[2])


def _innermost(spans, t):
    """The name of the latest-started span open at t, or None."""
    best = None
    for s in spans:
        if s["start_us"] <= t < s["end_us"] and (
                best is None or s["start_us"] >= best["start_us"]):
            best = s
    return best["name"] if best is not None else None


def idle_by_span(spans, events, lo, hi):
    """Device idle seconds in [lo, hi] (epoch us) by what each job's main
    thread was in (its innermost open span) and the side threads' spans
    open beside it ("scoring.overlay | spec_oa, writer"); idle time
    outside every job is "outside jobs". `events`: [(name, start_us,
    end_us)] of the device's operations. Sorted, largest first."""
    from .trace import union
    busy = union(events, lo, hi)
    gaps, prev = [], lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    tree = Tree(spans)
    jobs = []
    for j in tree.named("job"):
        sub = tree.subtree(j)
        main = [s for s in sub if s["tid"] == j["tid"]]
        side = {}
        for s in sub:
            p = tree.parent(s)
            if s["name"] in SIDE and s["tid"] != j["tid"] and p is not None \
                    and p["tid"] == j["tid"]:
                side.setdefault(s["tid"], []).extend(
                    x for x in tree.subtree(s) if x["tid"] == s["tid"])
        jobs.append((j, main, list(side.values())))
    out = {}
    for a, b in gaps:
        rest = [(a, b)]
        for j, main, side in jobs:
            ja, jb = max(a, j["start_us"]), min(b, j["end_us"])
            if ja >= jb:
                continue
            cuts = sorted({ja, jb} | {t for s in main + sum(side, [])
                                      for t in (s["start_us"], s["end_us"])
                                      if ja < t < jb})
            for x, y in zip(cuts, cuts[1:]):
                m = (x + y) / 2
                names = sorted({n for n in (_innermost(th, m) for th in side)
                                if n})
                key = _innermost(main, m) + (
                    " | " + ", ".join(names) if names else "")
                out[key] = out.get(key, 0.0) + (y - x) / 1e6
            rest = [(p, q) for p0, q0 in rest
                    for p, q in ((p0, min(q0, ja)), (max(p0, jb), q0))
                    if q > p]
        for p, q in rest:
            out["outside jobs"] = out.get("outside jobs", 0.0) + (q - p) / 1e6
    return sorted(out.items(), key=lambda kv: -kv[1])


def clock_check(spans, events, lo, hi):
    """Device intervals of the kernels in LAUNCHERS (inside [lo, hi])
    against the spans that launch them: (checked, outside, the worst
    distance in us by which one lies outside every such span, the least
    distance in us from one inside to its span's nearer edge)."""
    from .trace import kernel_base
    named = {}
    for x in spans:
        named.setdefault(x["name"], []).append(x)
    n = outside = 0
    worst = 0.0
    tightest = None
    for name, s, e in events:
        names = LAUNCHERS.get(kernel_base(name))
        if names is None or e <= lo or s >= hi:
            continue
        n += 1
        cands = [x for nm in names for x in named.get(nm, ())]
        inside = [x for x in cands if x["start_us"] <= s and e <= x["end_us"]]
        if inside:
            m = max(min(s - x["start_us"], x["end_us"] - e) for x in inside)
            tightest = m if tightest is None else min(tightest, m)
            continue
        outside += 1
        off = min((max(x["start_us"] - s, e - x["end_us"]) for x in cands),
                  default=float("inf"))
        worst = max(worst, off)
    return n, outside, worst, tightest


# ---- runs --------------------------------------------------------------

def say(*a):
    print(*a, file=sys.stderr, flush=True)


def trace_run(spec, workload, cfg, seed, seconds, device=None, root=ROOT):
    """run.py's traced run of the cell with the program's span recording
    on over the traced window; prints the readings and returns them (None
    when the run gave no result). It stands in for a hook in run.py's own
    traced block (record around the window, RunData.spans) and goes in the
    change that adds that hook: two traced paths are not to live side by
    side."""
    from witch_tpu_torch import spans as program_spans
    from . import run as run_mod
    from . import trace as trace_mod
    got = {}
    Tracer = trace_mod.Tracer

    class SpanTracer(Tracer):
        def start(self):
            super().start()
            got["lo"] = time.time() * 1e6
            program_spans.record(True)

        def stop(self):
            got["spans"] = program_spans.record(False)
            got["hi"] = time.time() * 1e6
            super().stop()

        def events(self, t0_epoch_us):
            got["events"] = super().events(t0_epoch_us)
            return got["events"]

    trace_mod.Tracer = SpanTracer
    try:
        result = run_mod.run(spec, workload, cfg, seed, seconds, 1,
                             device=device, root=root)
    finally:
        trace_mod.Tracer = Tracer
    if result is None or "spans" not in got:
        return None
    sp, ev = got["spans"], got.get("events", [])
    lo, hi = got["lo"], got["hi"]
    out = {"spans": len(sp), "metrics": {}}
    for name, fn in METRICS.items():
        v = fn(sp)
        out["metrics"][name] = v
        say("span metric %s: %r" % (name, v))
    out["by_name"] = by_name(sp)
    say("spans by name: count, wall s, thread CPU s, counter totals")
    for name, n, w, c, tot in out["by_name"]:
        say("  %-20s %6d %10.3f %10.3f  %s" % (name, n, w, c, " ".join(
            "%s=%g" % kv for kv in sorted(tot.items()))))
    out["idle_by_span"] = idle_by_span(sp, ev, lo, hi)
    say("device idle by span (s), %d spans:" % len(sp))
    for k, v in out["idle_by_span"][:20]:
        say("  %10.3f  %s" % (v, k))
    n, outside, worst, tightest = clock_check(sp, ev, lo, hi)
    out["clock_check"] = {"intervals": n, "outside": outside,
                          "worst_offset_us": worst,
                          "least_margin_us": tightest}
    say("clock check: %d kernel intervals, %d outside their launching span, "
        "worst offset %.3f us; least margin inside %r us"
        % (n, outside, worst, tightest))
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from . import run as run_mod
    spec = run_mod.load_spec(ROOT)
    workload, cfg = run_mod.cell_of(spec, args.workload)
    import torch
    if not torch.cuda.is_available():
        say("no CUDA card: nothing measured")
        return 3
    return 0 if trace_run(spec, workload, cfg, args.seed,
                          args.seconds) is not None else 1


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    __package__ = "benchmark"
    import benchmark  # noqa: F401 - the package the relative imports need
    sys.exit(main())
