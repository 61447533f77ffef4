"""What the per-layer metrics read: a run's jobs (their stage lines and
walls) and its trace. Each metric under metrics/ is a small reader built
on these; a reader that finds nothing to read returns None, never 0."""

from __future__ import annotations

# the stage lines the per-layer metrics read, by the start of the line
STAGE_LINES = {
    "ensemble": ("Time to obtain eHMM ensemble",),
    "bank": ("  scoring: bank build",),
    "gate": ("  scoring: device gate ",),
    "overlay": ("  scoring: exact-f32 print overlay",),
    "align": ("Time for per-query alignment",),
    "merge": ("Time to merge all outputs",),
}


def _matches(stage, label):
    return any(label.startswith(p) for p in STAGE_LINES[stage])


def stage_seconds(run, stage):
    """Seconds of the stage's lines summed over the window's jobs, or None
    where no job printed one."""
    found = False
    total = 0.0
    for job in run.jobs:
        for label, s in job.lines:
            if _matches(stage, label):
                found = True
                total += s
    return total if found else None


def stage_ms_per_query(run, stage):
    s = stage_seconds(run, stage)
    if s is None or not run.n_fragments:
        return None
    return 1e3 * s / run.n_fragments


def other_ms_per_query(run):
    """The jobs' wall time (the harness's clock) less every stage line
    that a stage metric reads."""
    if not run.jobs or not run.n_fragments:
        return None
    rest = 0.0
    for job in run.jobs:
        read = sum(s for label, s in job.lines
                   if any(_matches(st, label) for st in STAGE_LINES))
        rest += job.wall_s - read
    return 1e3 * rest / run.n_fragments


def kernel_seconds(run, names):
    """Device seconds of the kernels with these base names in the trace,
    or None where the run was not traced or none of them ran."""
    if run.kernels is None:
        return None
    hit = [run.kernels[k] for k in names if k in run.kernels]
    return sum(hit) if hit else None


def kernel_ms_per_query(run, names):
    s = kernel_seconds(run, names)
    if s is None or not run.n_fragments:
        return None
    return 1e3 * s / run.n_fragments


FORWARD_KERNELS = ("fwd_kernel",)
NULL2_KERNELS = ("null2_kernel",)
OA_KERNELS = ("oa_kernel", "oa_warp_kernel", "oa_trace_kernel")
