"""shard_gather_ms_per_query: rank 0's 'Time to gather shard rows' lines
of the window's jobs (its wait for the slowest rank, then the transfer of
every rank's rows, weights and scores), in ms a fragment: the ranks'
imbalance. 0 where no job ran as query shards (one card, or the data
mesh: nothing was gathered, and run.py prints no result where a listed
metric reads None); None where a sharded job printed its dispatch line
and not this one (a renamed line), or where there is no job."""

PREFIX = "Time to gather shard rows"
# the line beside it that every sharded job of a rank pool prints
OTHER = "Time to dispatch job to "


def read(run):
    lines = [(label, s) for job in run.jobs for label, s in job.lines]
    if not lines or not run.n_fragments:
        return None
    s = [s for label, s in lines if label.startswith(PREFIX)]
    if not s and any(label.startswith(OTHER) for label, _ in lines):
        return None
    return 1e3 * sum(s) / run.n_fragments
