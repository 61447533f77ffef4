"""shard_dispatch_ms_per_query: rank 0's 'Time to dispatch job to N shard
ranks' lines of the window's jobs (starting or replacing the resident
ranks where it must, and handing them the job), in ms a fragment. 0 where
no job ran as query shards (one card, or the data mesh: nothing was
dispatched, and run.py prints no result where a listed metric reads
None); None where a sharded job printed its gather line and not this
one (a renamed line), or where there is no job."""

PREFIX = "Time to dispatch job to "
# the line beside it that every sharded job prints
OTHER = "Time to gather shard rows"


def read(run):
    lines = [(label, s) for job in run.jobs for label, s in job.lines]
    if not lines or not run.n_fragments:
        return None
    s = [s for label, s in lines if label.startswith(PREFIX)]
    if not s and any(label.startswith(OTHER) for label, _ in lines):
        return None
    return 1e3 * sum(s) / run.n_fragments
