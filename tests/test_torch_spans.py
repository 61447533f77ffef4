"""The port's spans (witch_tpu_torch/spans.py): the recorder on its own;
a job of the amino golden's size on the CPU, whose runtime_breakdown.txt
lines come from its stage spans and whose spans form one tree, with the
pool workers and side threads under the span that started them; and the
benchmark's span readers (benchmark/spans.py) on hand-made spans."""

import os
import re
import sys
import threading
import time

import pytest
import torch

from witch_tpu_torch import _build, spans
from witch_tpu_torch.cli import init_parser
from witch_tpu_torch.config import build_configs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLD = os.path.join(HERE, "golden")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import spans as readers  # noqa: E402

# the amino golden's runtime_breakdown.txt labels, numbers as '#', in
# order (the parent's lines, and forward's kernel ms)
LABELS = [
    "Time to obtain eHMM ensemble",
    "  scoring: bank build/quantize/upload",
    "  scoring: device Forward Mp=# H=# (kernel # ms)",
    "  scoring: device Forward Mp=# H=# (kernel # ms)",
    "  scoring: device gate # pairs (# env on device, # multidomain host, "
    "# margin + # boundary re-evals) prep #s null# #s (kernel # ms, # "
    "launches) multi host #s wait #s total",
    "  scoring: exact-f# print overlay #/# pairs (band cover #)",
    "Time for all-vs-all Forward scoring",
    "Time to persist hmmsearch results",
    "Time to obtain weights",
    "  align: # pairs speculative device OA join (# selection-drift host "
    "aligns) wait #s; speculative thread # pairs device posterior+OA #s "
    "(kernel # ms, # launches; # below-guard native re-aligns) #s",
    "  align: merge DP for # queries",
    "Time for per-query alignment",
    "Time to merge all outputs",
    "Total runtime",
]
# the span each line is written from, in the same order
LINE_SPANS = ["ensemble", "scoring.bank", "scoring.forward",
              "scoring.forward", "scoring.gate", "scoring.overlay",
              "scoring", "persist", "weights", "align.join",
              "align.merge_dp", "align", "merge", "job"]
_LINE = re.compile(r"^(.*?)\s*\(s\):\s*([-+0-9.eE]+)\s*$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's runs (many small calls)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _span(name, sid, parent, tid, start, end, cpu, job=1, **counters):
    return {"id": sid, "name": name, "parent": parent, "tid": tid,
            "job": job, "start_us": float(start), "end_us": float(end),
            "cpu_us": float(cpu), "counters": counters}


# ---- the recorder ----------------------------------------------------

def test_spans_nest_by_thread_and_take_parents_across_threads():
    assert spans.record(False) == []        # nothing kept while off
    spans.record(True)
    t_on = time.time() * 1e6
    with spans.span("job", fragments=3) as job:
        with spans.span("stage") as stage:
            inner = []

            def work():
                with spans.span("side", parent=stage) as s:
                    with spans.span("side.part"):
                        inner.append(s)

            th = threading.Thread(target=work)
            th.start()
            th.join(timeout=30)
            assert not th.is_alive()
        other = spans.span("second")
        with other:
            pass
    kept = spans.record(False)
    t_off = time.time() * 1e6
    by = {s["name"]: s for s in kept}
    assert [s["name"] for s in kept] == ["side.part", "side", "stage",
                                        "second", "job"]
    assert by["stage"]["parent"] == by["job"]["id"]
    assert by["side"]["parent"] == by["stage"]["id"]
    assert by["side.part"]["parent"] == by["side"]["id"]
    assert by["side"]["tid"] != by["stage"]["tid"]
    assert by["side.part"]["tid"] == by["side"]["tid"]
    assert {s["job"] for s in kept} == {job.job}
    assert by["job"]["counters"] == {"fragments": 3}
    for s in kept:
        assert t_on - 1e3 <= s["start_us"] <= s["end_us"] <= t_off + 1e3
        assert s["cpu_us"] >= 0.0
    assert [c.name for c in job.children] == ["stage", "second"]
    assert job.child("stage") is stage and job.child("none") is None
    assert stage.child_seconds("side") == inner[0].seconds > 0.0
    assert spans.current() is None
    # a span with no parent starts a new job
    with spans.span("job") as job2:
        pass
    assert job2.job != job.job and spans.record(False) == []
    # one opened before recording started is kept without CPU time
    with spans.span("straddle"):
        spans.record(True)
    kept = spans.record(False)
    assert [(s["name"], s["cpu_us"]) for s in kept] == [("straddle", None)]


def test_span_records_a_kernel_counters_deltas():
    n0, ms0 = _build.LAUNCHES["oa"], _build.KERNEL_MS["oa"]
    try:
        with spans.span("spec_oa", kernels="oa", pairs=5) as sp:
            _build.LAUNCHES["oa"] += 2
            _build.KERNEL_MS["oa"] += 1.5
    finally:
        _build.LAUNCHES["oa"], _build.KERNEL_MS["oa"] = n0, ms0
    assert sp.counters == {"pairs": 5, "launches": 2, "kernel_ms": 1.5}
    assert set(_build.KERNEL_MS) == set(_build.LAUNCHES)


# ---- a job on the CPU ------------------------------------------------

def _job(outdir):
    from witch_tpu_torch.pipeline import main_alignment_process
    build_configs(init_parser(), [
        "-b", os.path.join(GOLD, "ref_amino.backbone.fasta"),
        "-e", os.path.join(GOLD, "ref_amino.backbone.tre"),
        "-q", os.path.join(GOLD, "ref_amino.queries.fasta"),
        "-d", str(outdir), "-o", "aligned.fasta", "--molecule", "amino"])
    main_alignment_process(device="cpu")
    out = []
    with open(outdir / "runtime_breakdown.txt") as f:
        for line in f:
            m = _LINE.match(line.rstrip("\n"))
            assert m, line
            out.append((m.group(1), float(m.group(2))))
    return out


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The amino golden's job with recording on: (its lines, its spans,
    its aligned.fasta)."""
    spans.record(True)
    try:
        out = tmp_path_factory.mktemp("rec")
        lines = _job(out)
    finally:
        kept = spans.record(False)
    return lines, kept, (out / "aligned.fasta").read_bytes()


def test_untraced_job_keeps_no_spans_and_its_labels(tmp_path, recorded):
    lines = _job(tmp_path)
    assert spans.record(False) == []
    assert [re.sub(r"\d+(\.\d+)?", "#", lab) for lab, _ in lines] == LABELS
    assert (tmp_path / "aligned.fasta").read_bytes() == recorded[2]


def test_each_line_is_its_stage_span(recorded):
    lines, kept, _ = recorded
    assert len(lines) == len(LINE_SPANS)
    seen = {}
    for (label, secs), name in zip(lines, LINE_SPANS):
        k = seen[name] = seen.get(name, -1) + 1
        sp = [s for s in kept if s["name"] == name][k]
        assert abs(secs - (sp["end_us"] - sp["start_us"]) / 1e6) < 1e-6, \
            (label, secs, sp)


def test_spans_form_one_tree_with_workers_under_their_submitter(recorded):
    _, kept, _ = recorded
    by_id = {s["id"]: s for s in kept}
    roots = [s for s in kept if s["parent"] is None]
    assert [r["name"] for r in roots] == ["job"]
    assert roots[0]["counters"]["fragments"] == 30
    for s in kept:
        assert s["end_us"] >= s["start_us"]
        assert s["job"] == roots[0]["job"]
        assert s["parent"] is None or s["parent"] in by_id
    # name: the name of the span that submits it
    submitted = {"ensemble.model": "ensemble", "gate.flank": "gate.prep",
                 "gate.null2": "scoring.gate", "gate.f64": "scoring.gate",
                 "multidomain.model": "gate.multidomain",
                 "f64.model": "gate.f64", "overlay.model":
                 "scoring.overlay", "spec_oa": "scoring", "writer": "job"}
    for name, parent in submitted.items():
        got = [s for s in kept if s["name"] == name]
        assert got, name
        for s in got:
            p = by_id[s["parent"]]
            assert p["name"] == parent and p["tid"] != s["tid"], (name, p)
    for name in ("gate.multidomain", "gate.f64"):
        side = [s for s in kept if s["name"] == name]
        assert len(side) == 1 and by_id[side[0]["parent"]]["name"] == \
            "scoring.gate", name
    null2 = [s for s in kept if s["name"] == "gate.null2"][0]
    assert null2["counters"]["launches"] == 0      # plain version
    assert null2["counters"]["envelopes"] > 0
    fwd = [s for s in kept if s["name"] == "scoring.forward"]
    assert [f["counters"]["kernel_ms"] for f in fwd] == [0.0, 0.0]


# ---- the benchmark's readers -----------------------------------------

def _hand_made():
    """Two jobs' worth of spans: job 1 on thread 1 (4 fragments), its
    overlay with two worker threads, a writer, a speculative thread."""
    return [
        _span("job", 1, None, 1, 0, 10000, 3000, fragments=4),
        _span("ensemble", 2, 1, 1, 1000, 3000, 500),
        _span("scoring", 3, 1, 1, 2000, 5000, 100),  # overlaps ensemble
        _span("scoring.overlay", 4, 3, 1, 3000, 4000, 100),
        _span("overlay.model", 5, 4, 2, 3000, 3900, 800),
        _span("overlay.inner", 6, 5, 2, 3100, 3800, 500),   # nested: once
        _span("overlay.model", 7, 4, 3, 3000, 3500, 400),
        _span("spec_oa", 8, 3, 4, 3000, 9000, 2000),       # not overlay's
        _span("writer", 9, 1, 5, 1000, 8000, 4000),        # another thread
        _span("writer.wait", 10, 9, 5, 1000, 2000, 0),
        _span("job", 11, None, 6, 20000, 22000, 1000, job=2, fragments=4),
        _span("scoring.overlay", 12, 11, 6, 20000, 21000, 900, job=2),
    ]


def test_readers_on_hand_made_spans():
    sp = _hand_made()
    # overlay: (100 + 800 + 400 + 900) us CPU over (1000 + 1000) us walls
    assert readers.host_cores(sp, "scoring.overlay") == \
        pytest.approx(2200 / 2000)
    m = readers.METRICS
    assert m["overlay_host_cores"](sp) == pytest.approx(1.1)
    assert m["ensemble_host_cores"](sp) == pytest.approx(0.25)
    assert m["gate_host_cores"](sp) is None
    # writer: 7000 us less its 1000 us wait, over 8 fragments
    assert m["writer_ms_per_query"](sp) == pytest.approx(6.0 / 8)
    # job 1: 10000 us less [1000, 5000] (its own thread's children, the
    # two overlapping); job 2: 2000 less 1000; over 8 fragments
    assert m["pipeline_self_ms_per_query"](sp) == pytest.approx(7.0 / 8)
    top = readers.by_name(sp)[:2]
    assert [r[:2] for r in top] == [("job", 2), ("writer", 1)]
    assert [r[2:4] for r in top] == [pytest.approx((12e-3, 4e-3)),
                                     pytest.approx((7e-3, 4e-3))]
    # counters summed over a name's spans
    assert [r[4] for r in top] == [{"fragments": 8}, {}]
    assert readers.host_cores(sp[:3] + [dict(sp[3], cpu_us=None)],
                              "scoring.overlay") is None
    for name, fn in m.items():
        assert fn([]) is None, name
        assert fn(sp[2:10]) is None or name.endswith("host_cores"), name


def test_host_cores_counts_a_side_thread_and_its_workers_once():
    # the gate on thread 1; its f64 side thread (2) runs one worker span
    # on itself and two on threads 3 and 4, each worker span with a
    # nested span on its own thread
    sp = [_span("scoring.gate", 1, None, 1, 0, 1000, 100),
          _span("gate.f64", 2, 1, 2, 0, 900, 50),
          _span("f64.model", 3, 2, 2, 0, 300, 40),
          _span("f64.inner", 4, 3, 2, 0, 200, 30),
          _span("f64.model", 5, 2, 3, 0, 800, 700),
          _span("f64.inner", 6, 5, 3, 0, 700, 600),
          _span("f64.model", 7, 2, 4, 0, 800, 600)]
    # 100 + 50 + 700 + 600 us of CPU over 1000 us
    assert readers.host_cores(sp, "scoring.gate") == pytest.approx(1.45)
    rows = {r[0]: r for r in readers.by_name(sp)}
    assert rows["f64.model"][1:4] == pytest.approx((3, 1.9e-3, 1.34e-3))


def test_idle_by_span_and_clock_check():
    sp = _hand_made()
    kernel = "void oa_warp_kernel<8, false>(float const*)"
    events = [(kernel, 3200.0, 3400.0), ("fwd_kernel", 2500.0, 2600.0),
              ("Memcpy DtoH", 9500.0, 9600.0)]
    idle = dict(readers.idle_by_span(sp, events, 0.0, 12000.0))
    # spec_oa's thread runs beside scoring.overlay from 3000 to 4000, less
    # the kernel's 200 us
    assert idle["scoring.overlay | spec_oa, writer"] == pytest.approx(8e-4)
    assert idle["outside jobs"] == pytest.approx(2e-3)
    assert idle["ensemble | writer.wait"] == pytest.approx(1e-3)
    assert idle["job"] == pytest.approx((1000 + 500 + 400) / 1e6)
    assert sum(idle.values()) == pytest.approx((12000 - 400) / 1e6)
    n, outside, worst, least = readers.clock_check(sp, events, 0.0, 12000.0)
    # the OA kernel lies inside spec_oa; fwd_kernel has no scoring.forward
    assert (n, outside) == (2, 1) and worst == float("inf")
    sp.append(_span("scoring.forward", 13, 3, 1, 2550, 2700, 10))
    n, outside, worst, least = readers.clock_check(sp, events, 0.0, 12000.0)
    assert (n, outside, worst, least) == (2, 1, 50.0, 200.0)
