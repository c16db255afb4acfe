"""Tools around the port: the seeded flagship workload and the slice
profiler (run on a CUDA card)."""
