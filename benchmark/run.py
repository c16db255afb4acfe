"""Run one cell of the benchmark of zerospeech_tts_tpu_torch on this machine.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic; the traffic names its driver
(``drivers/<driver>.py``). A run makes its inputs and weights from the
seed, sets up and warms the program (``setup_s``, from the start of this
process), measures for ``--seconds``, and with ``--trace 1`` traces a
short stretch of the same work after the window for the per-layer
metrics. Then it reads the peak memory, frees the program's state and
judges the window's outputs against the plain reference (``reference/``)
by the cell's limits (``limits/<cell>.json``). The last line of standard
output is the result: {"correct", "attempted", "failed", "metrics",
"device", ["breakdown"], "checks"}; the numbers compared, each beside its
limit, are also the last lines of standard error.

It exits non-zero with no result where no CUDA card (or too few) is
visible, and where JAX, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.core import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "zerospeech_tts_tpu")
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's,
    flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Readings:
    """What a per-layer metric's reader reads: the cell, the driver's
    object (its counters and least work), the window's record and the
    trace (None without one)."""

    def __init__(self, c: dict, cell, window: dict, trace):
        self.c, self.cell, self.window, self.trace = c, cell, window, trace


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", c: dict | None = None,
        t_start: float | None = None) -> dict:
    """One run of a cell; returns the result (``c``: the cell as
    manifest.cell gives it, to run it changed)."""
    import torch

    c = c or manifest.cell(workload)
    cuda = torch.device(device).type == "cuda"
    cell = manifest.driver(c["traffic"]["driver"]).Cell(c, seed, device)
    cell.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    window = cell.window(seconds)
    tr = None
    if trace:
        from benchmark.core.trace import traced

        tr = traced(cell.tail, cell.units_of)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    cell.release()
    checks = cell.check(flops=trace)
    readings = Readings(c, cell, window, tr)
    metrics = {}
    for m in c["per_layer"] if trace else c["end_to_end"]:
        v = setup_s if m["name"] == "setup_s" else (manifest.reader(m["name"])(readings) if trace else window[m["name"]])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    lim = c["limits"]
    result = {
        "correct": all(v <= lim[k] for k, v in checks.items()),
        "attempted": cell.attempted,
        "failed": cell.failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim[k]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ.setdefault(var, str(manifest.ROOT / "build" / "benchmark_cache" / sub))
    c = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c["workload"]["chips"]:
        print(f"benchmark: needs {c['workload']['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
        return 3
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", c)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
