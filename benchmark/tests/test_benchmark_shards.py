"""The query-sharding metrics (metrics/shard_dispatch_ms_per_query.py,
metrics/shard_gather_ms_per_query.py) on canned stage lines: rank 0's
lines of a four-rank job; 0 where no job ran as shards; None where a
sharded job lacks the metric's own line, or there is nothing to read."""

import types

import pytest

from benchmark.metrics import (shard_dispatch_ms_per_query,
                               shard_gather_ms_per_query)
from benchmark.stages import parse_lines

# rank 0's runtime_breakdown.txt of a four-rank dna1k job, as the program
# writes it
RANK0 = """\
Time to dispatch job to 4 shard ranks (s): 0.012500
Time to obtain eHMM ensemble (s): 7.400000
  scoring: bank build/quantize/upload (s): 0.600000
Time for all-vs-all Forward scoring (s): 3.500000
Time to obtain weights (s): 0.020000
Time for per-query alignment (s): 0.400000
  shards: rank walls min .. max (s): 11.900000 .. 12.650000
Time to gather shard rows (s): 0.750000
Time to persist hmmsearch results (s): 0.500000
Time to merge all outputs (s): 0.100000
Total runtime (s): 13.300000
"""
# the same job's lines on one card: no shard lines
ONE_CARD = "\n".join(ln for ln in RANK0.splitlines()
                     if "shard" not in ln) + "\n"


def run_of(texts, n_per_job=1000):
    return types.SimpleNamespace(
        jobs=[types.SimpleNamespace(lines=parse_lines(t)) for t in texts],
        n_fragments=n_per_job * len(texts))


@pytest.mark.parametrize("mod, seconds", [
    (shard_dispatch_ms_per_query, 0.0125),
    (shard_gather_ms_per_query, 0.75),
])
def test_reads_rank_zero_lines(mod, seconds):
    """Each metric sums its own line over the jobs, in ms a fragment; the
    rank-walls line (no single number) is read by neither."""
    assert mod.read(run_of([RANK0])) == pytest.approx(1e3 * seconds / 1000)
    assert mod.read(run_of([RANK0, RANK0, RANK0])) == \
        pytest.approx(1e3 * seconds / 1000)
    assert not any(label.startswith("  shards") for label, _ in
                   parse_lines(RANK0))


@pytest.mark.parametrize("mod", [shard_dispatch_ms_per_query,
                                 shard_gather_ms_per_query])
def test_zero_where_no_job_ran_as_shards(mod):
    """A one-card job prints no shard line: it dispatched and gathered
    nothing, so the metric reads 0 (a None would drop the run's whole
    result line); a window of one-card and sharded jobs counts every
    fragment."""
    assert mod.read(run_of([ONE_CARD])) == 0.0
    assert mod.read(run_of([ONE_CARD, ONE_CARD])) == 0.0
    assert mod.read(run_of([ONE_CARD, RANK0], n_per_job=500)) == \
        pytest.approx(mod.read(run_of([RANK0], n_per_job=1000)))


@pytest.mark.parametrize("mod, drop", [
    (shard_dispatch_ms_per_query, "Time to dispatch job"),
    (shard_gather_ms_per_query, "Time to gather shard rows"),
])
def test_none_where_a_sharded_job_lacks_the_line(mod, drop):
    """A sharded job whose own line of the metric is missing (renamed) while
    the other shard line is there, an empty window and a window of no
    fragments read nothing: None, never 0."""
    renamed = "\n".join(ln for ln in RANK0.splitlines()
                        if not ln.startswith(drop)) + "\n"
    assert mod.read(run_of([renamed])) is None
    assert mod.read(run_of([ONE_CARD, renamed])) is None
    assert mod.read(run_of([])) is None
    assert mod.read(run_of([RANK0], n_per_job=0)) is None
