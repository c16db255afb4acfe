"""idle_share.convert: share (%) of the traced conversion passes in which no operation ran on the device."""

from benchmark.core import readers


def read(r):
    return readers.idle_share(r)
