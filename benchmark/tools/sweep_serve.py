"""Find the knee of the serving cell once: the highest offered rate whose
completed rate keeps up with no growing backlog.

    python3 -m benchmark.tools.sweep_serve --workload serve-open.lin-f32 --seed N \
        --rates 40,60,80 [--seconds S]

Sets the cell up once and runs its open loop at each offered rate for
``--seconds``. For each it prints the requests due, how long after the
close of the window the last of them was answered (the backlog's drain),
the median latency of the first and of the last fifth of the requests,
p50/p95 and the rows a dispatch. A rate keeps up where every request was
answered, the backlog drained within 0.25 s and the last fifth's median
latency is under twice the first fifth's plus 20 ms. The traffic file keeps the knee and 0.8 of it as
numbers; nothing is searched for in a run.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark.core import manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", default="serve-open.lin-f32")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_serve needs a CUDA card", file=sys.stderr)
        return 3
    c = manifest.cell(args.workload)
    cell = manifest.driver("serve").Cell(c, args.seed, "cuda")
    cell.setup()
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        c["traffic"]["rate_per_s"] = rate
        w = cell.window(args.seconds)
        n = cell.next
        lat = cell.done[:n] - cell.due[:n]
        drain = float(np.nanmax(cell.done[:n]) - args.seconds)
        fifth = max(n // 5, 1)
        early, late = np.nanmedian(lat[:fifth]), np.nanmedian(lat[-fifth:])
        keeps = cell.failed == 0 and drain < 0.25 and late < 2 * early + 0.02
        knee = rate if keeps and (knee is None or rate > knee) else knee
        print(json.dumps({"rate": rate, "due": int(n), "failed": cell.failed, "drain_s": drain,
                          "early_p50_ms": early * 1e3, "late_p50_ms": late * 1e3,
                          "p50_ms": float(np.nanpercentile(lat, 50) * 1e3),
                          "p95_ms": float(np.nanpercentile(lat, 95) * 1e3),
                          "rows_per_dispatch": w["served"] / max(1, w["dispatches"]),
                          "keeps_up": bool(keeps)}), flush=True)
    print(json.dumps({"knee_per_s": knee}))
    cell.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
