"""The device trace of a traced stretch of work, read from
``torch.profiler``'s own events.

``busy_s`` is the union of the intervals in which an operation (a kernel,
a copy or a fill) ran on the device, ``window_s`` the traced stretch
itself, from the start to the end of the benchmark's ``bench.traced``
span. Each idle gap of the device is named by what the host was doing in
its middle: the innermost host range (an operator of the program, or a
span of the benchmark's) that holds it.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

from benchmark.core.counts import KERNEL_SYMBOLS


def _events(prof):
    """(start_ns, end_ns, name, on the device) of every event the
    profiler kept, from its own event list (what ``key_averages`` sums);
    device-side user annotations (a host range's name) left out."""
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and e.device_type != torch.autograd.DeviceType.CPU:
            continue
        tr = e.time_range
        yield int(tr.start * 1000), int(tr.end * 1000), e.name, e.device_type != torch.autograd.DeviceType.CPU


class Trace:
    """What one traced stretch of work showed; ``units`` is the number of
    units of the cell's work (passes, steps, requests) it held."""

    def __init__(self, prof, units: int):
        self.units = units
        dev, host = [], []
        window = None
        for start, end, name, on_device in _events(prof):
            if on_device:
                dev.append((start, end, name, not name.startswith(("Memcpy", "Memset"))))
            elif name == "bench.traced":
                window = (start, end)
            else:
                host.append((start, end, name))
        if window is None:
            raise RuntimeError("the trace holds no bench.traced span")
        self.t0, self.t1 = window
        self.window_s = (self.t1 - self.t0) * 1e-9
        dev = sorted(d for d in dev if d[1] > self.t0 and d[0] < self.t1)
        self.n_kernels = sum(1 for d in dev if d[3])
        self.op_s: dict[str, float] = defaultdict(float)
        for start, end, name, _ in dev:
            self.op_s[name] += (end - start) * 1e-9
        self.busy, self.gaps = self._union(dev)
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-9
        self.host = sorted(host)

    def _union(self, dev):
        busy, gaps = [], []
        cur = None
        for start, end, _, _ in dev:
            start, end = max(start, self.t0), min(end, self.t1)
            if cur and start <= cur[1]:
                cur[1] = max(cur[1], end)
                continue
            if cur:
                busy.append(tuple(cur))
            cur = [start, end]
        if cur:
            busy.append(tuple(cur))
        edge = self.t0
        for a, b in busy:
            if a > edge:
                gaps.append((edge, a))
            edge = b
        if self.t1 > edge:
            gaps.append((edge, self.t1))
        return busy, gaps

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of the functions that carry ``kernel``
        (counts.KERNEL_SYMBOLS)."""
        pat = re.compile(r"\b(" + "|".join(KERNEL_SYMBOLS[kernel]) + r")\b")
        return sum(s for name, s in self.op_s.items() if pat.search(name))

    def idle_gaps(self, top: int = 10) -> list:
        """[[what the host was doing, idle seconds]] of the longest idle
        time, summed by name."""
        starts = [h[0] for h in self.host]
        spans = [h for h in self.host if h[2].startswith("bench.")]  # long: looked at whole
        by = defaultdict(float)
        for a, b in self.gaps:
            mid = (a + b) // 2
            best = None
            i = bisect.bisect_right(starts, mid)
            for start, end, name in spans + self.host[max(0, i - 256) : i]:
                if end >= mid and (best is None or end - start < best[0]):
                    best = (end - start, name)
            by[best[1] if best else "host, outside any range"] += (b - a) * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops], "idle_gaps": self.idle_gaps()}


def traced(fn, units_of) -> Trace:
    """Run ``fn()`` under the profiler (host and device), the stretch
    closed by a synchronize; ``units_of(result)`` counts its units of work."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with torch.profiler.record_function("bench.traced"):
            res = fn()
            sync()
    return Trace(prof, units_of(res))
