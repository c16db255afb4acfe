"""readback_idle_share.convert: share (%) of the traced conversion passes in which the device was idle while the host was inside the port's ``convert.readback`` span: reading a dispatch back (the copies to the host and cutting rows to true lengths)."""

from benchmark.core import spans


def read(r):
    return spans.idle_in(r.trace, ("convert.readback",))
