"""Readings that set a cell's limits, in one process on the card.

    python3 -m benchmark.tools.calibrate --workload <cell> --seeds 1,2,... \
        [--controls 1,2,3] [--faults half_batch] [--seconds S] [--out FILE]

For each seed of ``--seeds`` it sets the cell up anew (its weights and
traffic from that seed), runs a window of ``--seconds`` at the cell's
own load and prints the numbers the comparison reads, the program's
against the reference (the lower readings). For each seed of
``--controls`` it also prints them for the control, the reference one
precision below the configuration's put in the program's place, and for
each fault of ``--faults`` (training: ``half_batch``) planted in the
reference put in its place (the upper readings). One JSON line a reading;
``--out`` collects them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark.core import manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 3
    c = manifest.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.controls.split(",") if s}
    faults = [f for f in args.faults.split(",") if f]
    rows = []
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        cell = manifest.driver(c["traffic"]["driver"]).Cell(c, seed, "cuda")
        cell.setup()
        cell.window(args.seconds)
        cell.release()
        found = []
        if seed in seeds:
            found.append(("program", cell.check()))
        if seed in controls:
            found.append(("control", cell.control("precision")))
            found += [(f, cell.control(f)) for f in faults]
        for side, readings in found:
            row = {"workload": args.workload, "seed": seed, "side": side, **readings,
                   "seconds": time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del cell
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
