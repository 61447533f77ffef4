"""The thread-block cluster meeting on the card (csrc/cluster.cu): what
one meeting of a pair's C CTAs costs, the barrier alone and with a DSMEM
exchange of one record, at one cluster and at as many as the card holds
at once. The OA and flank cluster kernels (csrc/oa.cu, csrc/flank.cu)
cross such a meeting once to three times a DP row. A measurement, not a
kernel of any path: it needs a CUDA device and raises without one."""

from __future__ import annotations

from typing import Dict, List, Sequence


def max_active(C: int) -> int:
    """Clusters of C CTAs of 256 threads (the probe's shape) the card
    holds at once (cudaOccupancyMaxActiveClusters)."""
    from .. import _build
    n = _build.lib().witch_cluster_probe_active(C)
    if n < 0:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed: %d" % -n)
    return n


def barrier_probe(Cs: Sequence[int] = (2, 4, 8), reps: int = 20000
                  ) -> List[Dict]:
    """For each cluster size C: ns per meeting (CUDA events over one
    launch of `reps` meetings, divided by reps) and SM cycles per meeting
    (clock64 in the kernel), for the barrier alone and the record
    exchange, at one cluster and at every co-resident cluster."""
    import torch

    from .. import _build
    if not torch.cuda.is_available():
        raise RuntimeError("the cluster probe needs a CUDA device")
    lib = _build.lib()
    dev = torch.device("cuda")
    stream = _build.stream_ptr(dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    out = []
    for C in Cs:
        act = max_active(C)
        row = dict(C=C, max_active_clusters=act)
        for mode, name in ((0, "barrier"), (1, "exchange")):
            for n, tag in ((1, "one"), (max(1, act), "all")):
                cyc = torch.zeros(n, dtype=torch.int64, device=dev)
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                _build.check(lib.witch_cluster_probe(
                    C, 16, mode, n, sink.data_ptr(), cyc.data_ptr(), stream),
                    "cluster_probe", count=False)          # warm-up
                ev[0].record()
                _build.check(lib.witch_cluster_probe(
                    C, reps, mode, n, sink.data_ptr(), cyc.data_ptr(),
                    stream), "cluster_probe", count=False)
                ev[1].record()
                ev[1].synchronize()
                row["%s_%s_ns" % (name, tag)] = \
                    ev[0].elapsed_time(ev[1]) * 1e6 / reps
                row["%s_%s_cycles" % (name, tag)] = float(
                    cyc.double().mean())
        out.append(row)
    return out
