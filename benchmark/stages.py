"""The program's stage lines (each job's runtime_breakdown.txt, written by
Configs.runtime) and the stage intervals rebuilt from them.

A line is "<label> (s): <seconds>". Lines that start with two spaces
are parts of the next unindented line (the scoring lines before "Time
for all-vs-all Forward scoring", the align lines before "Time for
per-query alignment"); unindented lines are the pipeline's stages, one
after another, and "Total runtime" closes the job.
"""

from __future__ import annotations

import re

_LINE = re.compile(r"^(?P<label>.*?)\s*\(s\):\s*(?P<s>[-+0-9.eE]+|nan|inf)\s*$")

# short names of the stages, by the start of their line (first match wins)
SHORT = (
    ("Time to obtain eHMM ensemble", "ensemble"),
    ("  scoring: bank build", "bank"),
    ("  scoring: device Forward", "forward"),
    ("  scoring: device gate", "gate"),
    ("  scoring: exact-f32 print overlay", "overlay"),
    ("Time for all-vs-all Forward scoring", "scoring"),
    ("Time to persist hmmsearch results", "persist"),
    ("Time to obtain weights", "weights"),
    ("  align: merge DP", "merge DP"),
    ("  align:", "OA"),
    ("Time for per-query alignment", "align"),
    ("Time to merge all outputs", "merge"),
    ("Total runtime", "total"),
)
# stages beside which another thread of the job runs: the speculative OA
# thread from its start after the gate until the align stage joins it,
# and, where the job builds the ensemble and keeps the decomposition, the
# decomposition writer from the bank build to the end of scoring
OVERLAPPED_SPEC = {"overlay", "scoring", "persist", "weights"}
OVERLAPPED_WRITER = {"forward", "gate", "overlay", "scoring"}


def short_name(label: str) -> str:
    for prefix, name in SHORT:
        if label.startswith(prefix):
            return name
    return " ".join(label.split()[:4])


def parse_lines(text: str):
    """[(label, seconds)] of every stage line, in order."""
    out = []
    for line in text.splitlines():
        m = _LINE.match(line)
        if m:
            out.append((m.group("label"), float(m.group("s"))))
    return out


def intervals(lines, t_end):
    """[(start, end, name)] of a job's stages on the clock of t_end (the
    job's end), from its lines in order: the pipeline starts Total
    runtime before t_end; unindented stages follow each other from
    there, and the indented lines before one fill its interval in
    order."""
    total = [s for label, s in lines if label.startswith("Total runtime")]
    if not total:
        return []
    t = t_end - total[-1]
    out = []
    pending = []
    for label, s in lines:
        name = short_name(label)
        if label.startswith("  "):
            pending.append((name, s))
            continue
        if name == "total":
            break
        start, end = t, t + s
        c = start
        for cname, cs in pending:
            out.append((c, min(end, c + cs), cname))
            c += cs
        if c < end:
            out.append((c, end, name))
        pending = []
        t = end
    return out
