"""What the per-layer metrics' readers share (each reader is a file of
its own in ``metrics/``, found by the metric's name). A reader takes the
run's ``Readings`` (run.py) and returns a number, or None where it finds
nothing to read; the metric is then left out of the result."""

from __future__ import annotations


def idle_share(r) -> float | None:
    """Share (%) of the traced stretch with no operation on the device."""
    t = r.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(r) -> float | None:
    """The window's share (%) of the card's peak: the least time of its
    units of work at the peaks of their stated dtypes over its wall time."""
    per_unit = r.cell.flop_s()
    if per_unit is None or not r.window.get("elapsed"):
        return None
    return 100.0 * per_unit * r.window["units"] / r.window["elapsed"]


def roofline(r, kernel: str) -> float | None:
    """A kernel's share (%) of its roofline over the traced stretch: the
    least time of its work in the stretch's units over the device time of
    the functions that carry it (None where none ran)."""
    t = r.trace
    if t is None:
        return None
    dev = t.kernel_s(kernel)
    if dev <= 0:
        return None
    return 100.0 * r.cell.least_s(kernel) * t.units / dev
