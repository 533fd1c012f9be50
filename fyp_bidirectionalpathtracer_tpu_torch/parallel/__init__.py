# Import submodules explicitly (parallel.sharding).
