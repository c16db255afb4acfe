"""mfu.train: the window's optimizer steps as a share (%) of the card's float32 peak."""

from benchmark.core import readers


def read(r):
    return readers.mfu(r)
