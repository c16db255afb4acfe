"""Tools around the port: the seeded flagship workload, the kernel-2 spread
sweep, the step and data-parallel parity checks and the convergence demo
(run on a CUDA card), and the reader of a served process's pauses in its
``serve --profile`` trace."""
