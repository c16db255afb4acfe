"""Spans of the port: named host ranges on ``torch.profiler``'s own clock.

``span(name)`` records a range only while a ``torch.profiler`` profile
runs (``--profile DIR``, or a benchmark's traced stretch); the profiler
keeps it beside the operators and kernels it records, so every span
shares the device trace's clock. With no profile running it returns one
shared no-op context and records nothing.

The cyclic garbage collector's passes are spans too: a ``gc.callbacks``
hook opens ``python.gc`` at a collection's start and closes it at its stop,
on the thread that collects, when a profile runs at the start.

A profile records the thread that started it; the spans of other threads
(the service's dispatch thread) show where the profile records every
thread, as ``serve --profile DIR`` does.
"""

from __future__ import annotations

import contextlib
import gc
import threading

import torch.autograd.profiler as _profiler

NULL = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``name`` while a profile runs, and
    the shared no-op ``NULL`` otherwise."""
    return _profiler.record_function(name) if _profiler._is_profiler_enabled else NULL


_open = threading.local()  # the open python.gc range of each thread


def _gc_span(phase: str, info: dict) -> None:
    if phase == "start":
        if _profiler._is_profiler_enabled:
            rf = _profiler.record_function("python.gc")
            rf.__enter__()
            _open.rf = rf
    else:
        rf = getattr(_open, "rf", None)
        if rf is not None:
            _open.rf = None
            rf.__exit__(None, None, None)


_gc_span.zs_tracing = True
# one hook, however often this module is loaded
gc.callbacks[:] = [cb for cb in gc.callbacks if not getattr(cb, "zs_tracing", False)]
gc.callbacks.append(_gc_span)
