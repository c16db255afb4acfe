"""idle_share.serve: share (%) of the traced stretch of open-loop serving in which no operation ran on the device."""

from benchmark.core import readers


def read(r):
    return readers.idle_share(r)
