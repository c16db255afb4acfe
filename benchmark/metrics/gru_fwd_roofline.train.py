"""gru_fwd_roofline.train: the GRU recurrence's share (%) of its roofline over the traced steps (kernel 2)."""

from benchmark.core import readers


def read(r):
    return readers.roofline(r, "gru_fwd")
