"""train.kernels_per_step: kernels launched on the device a step, over the traced steps."""


def read(r):
    return r.trace.n_kernels / r.trace.units if r.trace is not None and r.trace.units else None
