"""launch_idle_share.convert: share (%) of the traced conversion passes in which the device was idle while the host was inside the port's ``convert.launch`` span: launching a dispatch (H2D copies, the frontend's and the model's operators, kernel launches)."""

from benchmark.core import spans


def read(r):
    return spans.idle_in(r.trace, ("convert.launch",))
