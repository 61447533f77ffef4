"""Work over several cards and processes: the data mesh (parallel/mesh.py)
scores one process's queries over every visible card; query sharding
(parallel/dist.py) gives each process its own block of queries to gate
and align, and one process gathers the rows and merges them."""
