"""Query sharding over processes (parallel/dist.py): each process gates
and aligns its own block of queries, and one process gathers the rows
and merges them."""
