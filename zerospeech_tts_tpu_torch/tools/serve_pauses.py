"""Where a served process paused, read from a profile of ``serve``.

``serve --profile DIR`` writes ``DIR/serve.pt.trace.json``, a Chrome trace
of every thread from warm to shutdown. This reads its spans (tracing.py):
the cyclic collector's passes (``python.gc``, which hold the interpreter
lock, so every thread stops with them) and the service's worker
(``serve.window``, a micro-batch window; ``serve.dispatch``, a Converter
call). Each pass of at least ``--over-ms`` is put down to what the worker
was doing meanwhile: a dispatch, a window, or neither (the worker between
batches). Dispatches of at least ``--over-ms`` are listed with the
collector's time inside them.

    python -m zerospeech_tts_tpu_torch.tools.serve_pauses DIR/serve.pt.trace.json [--over-ms 100]

prints one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import json

import numpy as np

NAMES = ("python.gc", "serve.window", "serve.dispatch")


def load(path) -> dict[str, list[tuple[float, float]]]:
    """{span name: [(start_us, end_us)]} of the trace's host ranges of ``NAMES``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {n: [] for n in NAMES}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in out:
            out[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return {n: sorted(v) for n, v in out.items()}


def union(iv) -> list[tuple[float, float]]:
    """The sorted, disjoint union of the intervals ``iv``."""
    out: list[list[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(a: float, b: float, u) -> float:
    """The length of [a, b] inside the sorted disjoint union ``u``."""
    i = max(bisect.bisect_right(u, (a, float("inf"))) - 1, 0)
    tot = 0.0
    while i < len(u) and u[i][0] < b:
        tot += max(0.0, min(b, u[i][1]) - max(a, u[i][0]))
        i += 1
    return tot


def _stats(iv, gc_u) -> dict:
    ms = np.array([(b - a) / 1e3 for a, b in iv])
    if not len(ms):
        return {"count": 0}
    return {"count": len(ms), "total_ms": float(ms.sum()), "p50_ms": float(np.percentile(ms, 50)),
            "p95_ms": float(np.percentile(ms, 95)), "max_ms": float(ms.max()),
            "gc_ms": sum(overlap(a, b, gc_u) for a, b in iv) / 1e3}


def pauses(ranges: dict, over_ms: float = 100.0) -> dict:
    """The collector's passes and the worker's spans of ``load``'s ranges,
    the passes of at least ``over_ms`` split by what the worker was in."""
    gc_u = union(ranges["python.gc"])
    disp_u = union(ranges["serve.dispatch"])
    win_u = union(ranges["serve.window"])
    over = []
    for a, b in ranges["python.gc"]:
        ms = (b - a) / 1e3
        if ms < over_ms:
            continue
        d = overlap(a, b, disp_u) / 1e3
        w = min(overlap(a, b, win_u) / 1e3, ms - d)  # a window and a dispatch never overlap
        over.append({"ms": ms, "dispatch_ms": d, "window_ms": w, "none_ms": ms - d - w})
    long_disp = [{"ms": (b - a) / 1e3, "gc_ms": overlap(a, b, gc_u) / 1e3}
                 for a, b in ranges["serve.dispatch"] if (b - a) / 1e3 >= over_ms]
    return {"over_ms": over_ms, "gc": _stats(ranges["python.gc"], gc_u), "gc_over": over,
            "dispatch": _stats(ranges["serve.dispatch"], gc_u),
            "window": _stats(ranges["serve.window"], gc_u), "dispatch_over": long_disp}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("trace", help="the Chrome trace of serve --profile DIR (DIR/serve.pt.trace.json)")
    p.add_argument("--over-ms", type=float, default=100.0,
                   help="list the collector's passes and the dispatches at least this long")
    args = p.parse_args(argv)
    out = pauses(load(args.trace), args.over_ms)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
