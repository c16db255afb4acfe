"""Tools around the port: the seeded flagship workload, the profilers, the
A/B runner and the convergence demo (run on a CUDA card)."""
