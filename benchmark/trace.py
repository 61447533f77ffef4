"""The device trace of a `--trace 1` run: torch.profiler with CUDA activity
only, over the measured window, reduced to device intervals, the busy
time, the kernels by device time and the idle gaps by the stage the
host was in."""

from __future__ import annotations

import glob
import json
import os
import re

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """Records the card's activity between start() and stop(); the
    trace is written to `path` and read back as intervals on the host's
    epoch clock (microseconds)."""

    def __init__(self, path, on_card=True):
        self.path = path
        self.on_card = on_card
        self.prof = None

    def start(self):
        import torch
        act = torch.profiler.ProfilerActivity
        # without a card (the CPU dry run) the trace holds no device work
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if self.on_card else act.CPU])
        self.prof.start()

    def stop(self):
        import torch
        if self.on_card:
            torch.cuda.synchronize()
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def events(self, t0_epoch_us):
        """[(name, start_us, end_us)] of every device operation, on the
        epoch clock. Kineto's timestamps are microseconds after the
        trace's baseTimeNanoseconds where the file gives one, else
        epoch microseconds; a trace with neither is placed so that its
        first operation starts at t0_epoch_us."""
        with open(self.path) as f:
            tr = json.load(f)
        evs = [e for e in tr.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
        if not evs:
            return []
        base = tr.get("baseTimeNanoseconds")
        first = min(float(e["ts"]) for e in evs)
        if base is not None and first < 1e14:
            off = float(base) / 1e3
        elif first > 1e14:
            off = 0.0
        else:
            off = t0_epoch_us - first
        return [(e.get("name", "?"), float(e["ts"]) + off,
                 float(e["ts"]) + off + float(e.get("dur", 0.0)))
                for e in evs]


def kernel_base(name: str) -> str:
    """`void oa_warp_kernel<8, true>(float const*, ...)` -> oa_warp_kernel."""
    n = re.sub(r"^(void|static|__global__)\s+", "", name.strip())
    n = n.replace("(anonymous namespace)::", "")
    n = re.split(r"[<(\s]", n, 1)[0]
    return n.split("::")[-1] or name


def kernel_files(csrc_dir):
    """{kernel name: source file} from the __global__ functions of the
    program's CUDA sources."""
    out = {}
    for path in sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))):
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r"__global__\s+(?:void\s+)?(?:__launch_bounds__"
                             r"\s*\([^)]*\)\s*)?(\w+)\s*\(", text):
            out.setdefault(m.group(1), os.path.basename(path))
    return out


def union(intervals, lo, hi):
    """Sorted, merged [(s, e)] of the intervals clipped to [lo, hi]."""
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                if e > lo and s < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, lo, hi, jobs, files):
    """busy_s, window_s, the kernels' device seconds by base name, and the
    breakdown: the 10 device operations that took most time, and the idle
    time by what the host was doing, the 10 largest: each idle gap is cut
    at the stage boundaries it spans, and its pieces are summed by stage
    over the window's jobs. `jobs`: [(start_us, end_us, [(s_us, e_us,
    stage)], overlapped stage names)]."""
    busy = union(events, lo, hi)
    busy_s = sum(e - s for s, e in busy) / 1e6
    by_kernel = {}
    for name, s, e in events:
        if e <= lo or s >= hi:
            continue
        k = kernel_base(name)
        by_kernel[k] = by_kernel.get(k, 0.0) + (min(e, hi) - max(s, lo)) / 1e6
    idle = {}
    prev = lo
    segs = _segments(lo, hi, jobs)
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            for a, b, name in segs:
                ov = min(b, s) - max(a, prev)
                if ov > 0:
                    idle[name] = idle.get(name, 0.0) + ov / 1e6
        prev = max(prev, e)
    ops = sorted(by_kernel.items(), key=lambda x: -x[1])[:10]
    breakdown = {
        "device_ops": [["%s (%s)" % (k, files[k]) if k in files else k, v]
                       for k, v in ops],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda x: -x[1])[:10],
    }
    return busy_s, (hi - lo) / 1e6, by_kernel, breakdown


def _segments(lo, hi, jobs):
    """[(start, end, what the host was doing)] covering [lo, hi]: each
    job's stages (a stage beside which another thread of the job runs is
    marked overlapped), the job's untimed parts, and the harness between
    jobs."""
    out = []
    t = lo
    for js, je, ivs, overlapped in jobs:
        if js > t:
            out.append((t, js, "harness between jobs"))
        c = js
        for s, e, name in ivs:
            if s > c:
                out.append((c, s, "job start (arguments, backbone read)"
                            if c == js else "untimed"))
            out.append((max(s, c), e, "%s (overlapped)" % name
                        if name in overlapped else name))
            c = max(c, e)
        if je > c:
            out.append((c, je, "untimed"))
        t = max(t, je)
    if hi > t:
        out.append((t, hi, "harness between jobs"))
    return out
