"""The device's idle time put down to the program's own spans.

The port records its spans (``zerospeech_tts_tpu_torch/tracing.py``) as
host ranges of ``torch.profiler``, so ``Trace.host`` holds them beside the
operators, on the device trace's clock. ``idle_in`` reads only what
``Trace`` keeps: its idle gaps and its host ranges.
"""

from __future__ import annotations


def _union(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> int:
    """Total length of the intersection of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in(trace, names) -> float | None:
    """Share (%) of the traced stretch in which the device was idle while
    the host was inside a span named in ``names``: the idle gaps
    (``trace.gaps``) intersected with the union of those spans' host
    intervals (``trace.host``), over ``trace.window_s``. None without a
    trace, where the device was never busy (a CPU run), or where the trace
    holds no such span."""
    if trace is None or trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    names = set(names)
    spans = [(max(a, trace.t0), min(b, trace.t1)) for a, b, name in trace.host if name in names]
    if not spans:
        return None
    idle_ns = _overlap(_union(spans), [list(g) for g in trace.gaps])
    return 100.0 * idle_ns * 1e-9 / trace.window_s
