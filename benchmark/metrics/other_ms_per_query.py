"""other_ms_per_query: the jobs' wall time that no stage line read by a
stage metric covers (arguments, backbone read, weights, the walk, the
speculative join's wait, writes), in ms a fragment."""

from ..readers import other_ms_per_query


def read(run):
    return other_ms_per_query(run)
