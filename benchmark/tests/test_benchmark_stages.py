"""The stage-line parser and the stage metrics on recorded lines, the
forward roofline's count on a hand-counted case, and the trace's
reduction on a made-up timeline."""

import math

import pytest

from benchmark import readers, roofline, stages, trace
from benchmark.metrics import (device_idle_pct, forward_roofline,
                               gate_ms_per_query, other_ms_per_query)

# a dna1k scenario-D job's runtime_breakdown.txt, as the program writes it
D_LINES = """\
Time to obtain eHMM ensemble (s): 7.300968
  scoring: bank build/quantize/upload (s): 0.923697
  scoring: device Forward Mp=1440 H=283 (s): 0.401000
  scoring: device Forward Mp=1568 H=2 (s): 0.031000
  scoring: device gate 14000 pairs (13000 env on device, 900 multidomain host, 3 margin + 2 boundary re-evals) prep 2.10s null2 1.50s (kernel 183.8 ms, 3 launches) multi host 5.00s wait 0.20s total (s): 10.174560
  scoring: exact-f32 print overlay 2000/2100 pairs (band cover 0.40) (s): 12.217765
Time for all-vs-all Forward scoring (s): 23.900000
Time to persist hmmsearch results (s): 0.500000
Time to obtain weights (s): 0.300000
  align: 3000 pairs speculative device OA join (2 selection-drift host aligns) wait 0.00s; speculative thread 3000 pairs device posterior+OA 0.40s (kernel 29.40 ms, 2 launches; 0 below-guard native re-aligns) 0.45s (s): 0.300000
  align: merge DP for 1000 queries (s): 0.900000
Time for per-query alignment (s): 1.278831
Time to merge all outputs (s): 0.128403
Total runtime (s): 34.000000
"""


class Run:
    def __init__(self, jobs, n, kernels=None, busy=None, window=None,
                 work=None):
        self.jobs, self.n_fragments = jobs, n
        self.kernels, self.busy_s, self.window_s = kernels, busy, window
        self.forward_work = work


class Job:
    def __init__(self, text, wall):
        self.lines = stages.parse_lines(text)
        self.wall_s = wall


def test_parse_lines():
    lines = stages.parse_lines(D_LINES)
    assert len(lines) == 14
    assert lines[0] == ("Time to obtain eHMM ensemble", 7.300968)
    assert lines[-1] == ("Total runtime", 34.0)
    assert stages.short_name(lines[4][0]) == "gate"


def test_stage_metrics_read_their_lines():
    run = Run([Job(D_LINES, 34.5), Job(D_LINES, 35.5)], 2000)
    assert readers.stage_ms_per_query(run, "gate") == \
        pytest.approx(1e3 * 2 * 10.17456 / 2000)
    assert gate_ms_per_query.read(run) == pytest.approx(10.17456)
    # a cell whose jobs print no such line reads nothing, never 0
    no_gate = Run([Job(D_LINES.replace("device gate 14000", "xx"), 34.5)],
                  1000)
    assert readers.stage_ms_per_query(no_gate, "gate") is None
    read = 7.300968 + 0.923697 + 10.17456 + 12.217765 + 1.278831 + 0.128403
    assert other_ms_per_query.read(run) == pytest.approx(
        1e3 * (70.0 - 2 * read) / 2000)


def test_intervals_follow_the_lines():
    iv = stages.intervals(stages.parse_lines(D_LINES), 100.0)
    names = [n for _, _, n in iv]
    assert names[:3] == ["ensemble", "bank", "forward"]
    assert "overlay" in names and names[-1] == "merge"
    start = iv[0][0]
    assert start == pytest.approx(100.0 - 34.0)
    for a, b in zip(iv, iv[1:]):
        assert a[1] <= b[0] + 1e-9


def test_forward_roofline_hand_counted():
    """Two fragments of 3 and 5 residues, two models of 2 and 4 states:
    8 x 6 = 48 DP cells, 16 operations a cell; bytes: (4 + 8) f32 a state
    of the 6 states, 8 int32 residues, 4 f32 scores."""
    cells, ops, nbytes = roofline.forward_work([3, 5], [2, 4])
    assert cells == 48
    assert ops == 768
    assert nbytes == 4 * 12 * 6 + 4 * 8 + 4 * 4
    t, by = roofline.bound_seconds(ops, nbytes)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    run = Run([], 2, kernels={"fwd_kernel": 2 * t}, work=(cells, ops, nbytes))
    assert forward_roofline.read(run) == pytest.approx(50.0)
    assert forward_roofline.read(Run([], 2, kernels={})) is None


def test_trace_reduce_names_gaps_by_stage():
    lines = stages.parse_lines(D_LINES)
    ivs = [(s * 1e6, e * 1e6, n) for s, e, n in stages.intervals(lines, 40.0)]
    jobs = [(5.5e6, 40e6, ivs, stages.OVERLAPPED_SPEC)]
    events = [("void fwd_kernel<8>(float const*)", 15.0e6, 15.4e6),
              ("null2_kernel", 17.0e6, 17.2e6),
              ("Memcpy HtoD (Pageable -> Device)", 17.1e6, 17.3e6),
              ("null2_kernel", 39.9e6, 40.2e6)]
    busy, win, by_kernel, bd = trace.reduce(
        events, 5e6, 41e6, jobs, {"fwd_kernel": "forward.cu"})
    assert busy == pytest.approx(1.0)
    assert win == pytest.approx(36.0)
    assert by_kernel["fwd_kernel"] == pytest.approx(0.4)
    assert bd["device_ops"][1] == ["fwd_kernel (forward.cu)",
                                   pytest.approx(0.4)]
    idle = dict(bd["idle_gaps"])
    assert len(bd["idle_gaps"]) <= 10
    assert idle["overlay (overlapped)"] > 0
    assert idle["ensemble"] == pytest.approx(7.300968)
    assert "harness between jobs" in idle
    # the ten largest of the idle pieces; all of them add up to the window
    assert sum(idle.values()) + busy <= win + 1e-9
    segs = trace._segments(5e6, 41e6, jobs)
    assert sum(e - s for s, e, _ in segs) == pytest.approx(36e6)
    run = Run([], 1, busy=busy, window=win)
    assert device_idle_pct.read(run) == pytest.approx(100 * (1 - 1.0 / 36))
    assert device_idle_pct.read(Run([], 1)) is None
