"""Spans and counters of a job on the host.

    with span("scoring.gate", pairs=n) as sp:
        ...
    Configs.runtime("... (s): %f" % sp.seconds)

A span holds its name, its start and end (time.perf_counter_ns), the
native id of its thread (read once a thread), its parent span, its job
id, a dict of counters that the caller sets and, while recording, the
CPU time of its thread at both ends (time.thread_time_ns, a system
call; with recording off a span makes none). Its parent is the
innermost span open on the same thread, unless the caller names one: a
pool worker or a side thread starts with no open span, so work handed
to it takes the submitting span as `parent=`. A span without a parent
is the root of a new job; every other span carries its parent's job id.
A closed span is added to its parent's `children`, so a stage's line
can read its parts.

`kernels=` names one of _build's kernel counters ("forward", "null2",
"oa", ...): at close the span's counters get that kernel's launches and
CUDA-event ms since the span opened (_build.LAUNCHES and KERNEL_MS stay
the process totals).

Recording is off unless record(True): spans are then kept as they close,
and record(False) stops and returns them, with their times on the epoch
clock in microseconds (the clock of the device trace's intervals).
"""

from __future__ import annotations

import itertools
import threading
import time

from . import _build

_local = threading.local()
_jobs = itertools.count(1)
_lock = threading.Lock()
_recording = False
_kept: list = []
# (epoch ns - perf_counter ns) at the last record(True)
_epoch_offset_ns = 0


def _stack() -> list:
    """This thread's open spans; the first call also keeps its native id
    (_local.tid)."""
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
        _local.tid = threading.get_native_id()
    return st


def current():
    """The innermost span open on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


class Span:
    """One timed piece of a job; a context manager that yields itself.
    `counters` start its counter dict."""

    __slots__ = ("name", "parent", "job", "tid", "t0", "t1", "c0", "c1",
                 "counters", "children", "_kernel", "_k0")

    def __init__(self, name, parent=None, kernels=None, **counters):
        self.name = name
        self.parent = parent
        self.counters = counters
        self.children = []
        self._kernel = kernels
        self.t0 = self.t1 = 0
        self.c0 = self.c1 = None

    def __enter__(self):
        st = _stack()
        if self.parent is None and st:
            self.parent = st[-1]
        self.job = self.parent.job if self.parent is not None \
            else next(_jobs)
        self.tid = _local.tid
        if self._kernel is not None:
            self._k0 = (_build.LAUNCHES[self._kernel],
                        _build.KERNEL_MS[self._kernel])
        st.append(self)
        if _recording:
            self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.c0 is not None and _recording:
            self.c1 = time.thread_time_ns()
        _local.stack.pop()
        if self._kernel is not None:
            n0, ms0 = self._k0
            self.counters["launches"] = _build.LAUNCHES[self._kernel] - n0
            self.counters["kernel_ms"] = \
                _build.KERNEL_MS[self._kernel] - ms0
        if self.parent is not None:
            self.parent.children.append(self)
        if _recording:
            with _lock:
                if _recording:
                    _kept.append(self)
        return False

    @property
    def seconds(self) -> float:
        """Wall seconds from open to close."""
        return (self.t1 - self.t0) / 1e9

    def child(self, name):
        """The last closed direct child of this name, or None."""
        for c in reversed(self.children):
            if c.name == name:
                return c
        return None

    def child_seconds(self, name) -> float:
        c = self.child(name)
        return c.seconds if c is not None else 0.0

    def export(self) -> dict:
        """The span on the epoch clock, in microseconds; cpu_us is None
        for a span opened before recording started. Ids are id()s: the
        kept spans and their parents are alive together."""
        return {"id": id(self), "name": self.name, "job": self.job,
                "parent": id(self.parent) if self.parent is not None
                else None, "tid": self.tid,
                # int / int rounds once (a float of epoch ns is already
                # off by up to 128 ns)
                "start_us": (self.t0 + _epoch_offset_ns) / 1000,
                "end_us": (self.t1 + _epoch_offset_ns) / 1000,
                "cpu_us": (self.c1 - self.c0) / 1e3
                if self.c1 is not None else None,
                "counters": dict(self.counters)}


span = Span


def record(on: bool):
    """Start keeping closed spans (on=True), or stop and return the spans
    kept since the start, exported (Span.export), in the order they
    closed."""
    global _recording, _kept, _epoch_offset_ns
    with _lock:
        if on:
            _epoch_offset_ns = time.time_ns() - time.perf_counter_ns()
            _kept = []
            _recording = True
            return None
        _recording = False
        kept, _kept = _kept, []
    return [s.export() for s in kept]
