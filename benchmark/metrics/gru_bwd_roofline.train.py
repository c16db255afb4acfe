"""gru_bwd_roofline.train: the GRU backward pass's share (%) of its roofline over the traced steps (kernel 3)."""

from benchmark.core import readers


def read(r):
    return readers.roofline(r, "gru_bwd")
