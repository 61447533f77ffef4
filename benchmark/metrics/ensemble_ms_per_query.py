"""ensemble_ms_per_query: the 'ensemble' stage lines of the window's jobs, in ms a
fragment (readers.STAGE_LINES names the lines)."""

from ..readers import stage_ms_per_query


def read(run):
    return stage_ms_per_query(run, "ensemble")
