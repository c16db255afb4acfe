"""pack_idle_share.convert: share (%) of the traced conversion passes in which the device was idle while the host was inside the port's ``convert.pack`` span: building a dispatch's host arrays (int16 rint and clip, mu-law, stats rows, the uint8 wire)."""

from benchmark.core import spans


def read(r):
    return spans.idle_in(r.trace, ("convert.pack",))
