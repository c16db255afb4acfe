"""idle_share.train: share (%) of the traced training iterations in which no operation ran on the device."""

from benchmark.core import readers


def read(r):
    return readers.idle_share(r)
