"""gru_fwd_roofline.convert: the GRU recurrence's share (%) of its roofline over the traced passes (kernel 2, or its bf16 mode)."""

from benchmark.core import readers


def read(r):
    return readers.roofline(r, "gru_fwd")
