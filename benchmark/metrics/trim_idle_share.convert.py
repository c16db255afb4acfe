"""trim_idle_share.convert: share (%) of the traced conversion passes in which the device was idle while the host was inside the port's ``convert.trim`` span: trimming every utterance of a call before its first dispatch."""

from benchmark.core import spans


def read(r):
    return spans.idle_in(r.trace, ("convert.trim",))
