"""Compare two checkouts of the repository on one CUDA card, in turns.

    python -m zerospeech_tts_tpu_torch.tools.ab_trees A_DIR B_DIR [--out FILE]
        [--steps N] [--rounds R] [--tools slice train] [--bf16 [--enc-f32]]

Runs this checkout's ``tools/profile_slice.py`` (``--bf16``, ``--enc-f32``
passed on) and ``tools/profile_train.py`` (``--steps`` timed iterations a
phase) against each checkout's package, each in its own process started
in that checkout with only that checkout on its path (so each runs its
own package and builds its own kernels, measured by the same script),
in the order A, B, B, A (``--rounds`` times), with their
bundles and corpora in ``work/`` beside ``--out``, and writes every run's
JSON to ``--out`` (default ``build/ab_trees/ab.json`` of the current
directory). Prints, per run, the conversion slice's ``convert_wavs_multi``
median and GL-0 median, the profiled run's device time and busy share,
kernel 2's time at its test shape and on the path, each kernel's launches
and device time by name, and the training phases' steps/s; then, per
tool, each metric's median, first and third quartiles over each tree's
runs and how many of the adjacent pairs of runs (0-1, 2-3, ...: one run
of each tree) each tree won (a tie counts for neither).

    python -m zerospeech_tts_tpu_torch.tools.ab_trees --report FILE [FILE ...]

prints that last summary over the runs of one or more earlier ``--out``
files (several calls of the tool pooled).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

TOOLS = {"slice": "profile_slice", "train": "profile_train"}


def run_tool(tree: Path, tool: str, out: Path, work: Path, steps: int, flags: list[str]) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    script = Path(__file__).resolve().parent / f"{TOOLS[tool]}.py"  # imports the package from PYTHONPATH
    cmd = [sys.executable, str(script), "--out", str(out), "--work", str(work)] + (
        ["--steps", str(steps)] if tool == "train" else flags)
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{tool} in {tree} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(out.read_text())


def summary(tag: str, tool: str, res: dict) -> str:
    if tool == "slice":
        kern = sorted(res["device_kernels"], key=lambda r: -r["ms"])[:6]
        return (f"{tag} slice: convert_wavs_multi median {res['convert_wavs_multi_s']['median']:.4f} s "
                f"(q1 {res['convert_wavs_multi_s']['q1']:.4f}, q3 {res['convert_wavs_multi_s']['q3']:.4f}), "
                f"GL-0 {res['convert_wavs_multi_gl0_s']['median']:.4f} s; profiled device "
                f"{res['device_ms']:.2f} ms, busy {100 * res['device_busy_share']:.1f}%; kernel 2 "
                f"16x512 {res['gru_16x512_ms']:.4f} ms, path f32 {res['gru_f32_path_ms']:.3f} ms, bf16 "
                f"{res['gru_bf16_path_ms']:.3f} ms; launches "
                f"{res['profiled_launches']}; frontend 8x512 {res['frontend_8x512_ms']:.4f} ms; top: "
                + "; ".join(f"{r['name'][:50]} {r['ms']:.2f} ms x{r['count']}" for r in kern))
    phases = " ".join(f"{k} {v['steps_per_s']:.2f}" for k, v in res["phases"].items())
    kern = sorted(res["device_kernels"], key=lambda r: -r["ms"])[:6]
    return (f"{tag} train: steps/s {phases}; profiled train device {res['device_ms']:.2f} ms, busy "
            f"{100 * res['device_busy_share']:.1f}%, launches {res['profiled_launches']}; top: "
            + "; ".join(f"{r['name'][:50]} {r['ms']:.2f} ms x{r['count']}" for r in kern))


def metrics(tool: str, res: dict) -> dict:
    """The compared numbers of one run, each with True where higher is better."""
    if tool == "slice":
        return {"convert_wavs_multi_s": (res["convert_wavs_multi_s"]["median"], False),
                "device_ms": (res["device_ms"], False), "gru_16x512_ms": (res["gru_16x512_ms"], False),
                "gru_f32_path_ms": (res["gru_f32_path_ms"], False),
                "gru_bf16_path_ms": (res["gru_bf16_path_ms"], False)}
    out = {f"{k} steps/s": (v["steps_per_s"], True) for k, v in res["phases"].items()}
    out["train device_ms"] = (res["device_ms"], False)
    return out


def report(runs: list) -> list[str]:
    """Per tool and metric: the median over each tree's runs, and the
    adjacent pairs (each run of A beside the run of B next to it in
    order, as A, B, B, A makes them) that each tree won."""
    lines = []
    for tool in sorted({r["tool"] for r in runs}):
        rs = [r for r in runs if r["tool"] == tool]
        pairs = [(rs[i], rs[i + 1]) for i in range(0, len(rs) - 1, 2) if rs[i]["tree"] != rs[i + 1]["tree"]]
        for name, (_, higher) in metrics(tool, rs[0]["result"]).items():
            val = {t: [metrics(tool, r["result"])[name][0] for r in rs if r["tree"] == t] for t in "AB"}
            sign = 1 if higher else -1  # a pair whose two runs tie counts for neither tree
            wins = sum(sign * (metrics(tool, b["result"])[name][0] - metrics(tool, a["result"])[name][0]) > 0
                       for p in pairs for a, b in [sorted(p, key=lambda r: r["tree"])])
            q = {t: statistics.quantiles(v, n=4) if len(v) > 1 else v * 3 for t, v in val.items()}
            lines.append(f"{tool} {name}: median A {statistics.median(val['A']):.4f} (q1 {q['A'][0]:.4f}, q3 "
                         f"{q['A'][2]:.4f}; {len(val['A'])} runs), B {statistics.median(val['B']):.4f} (q1 "
                         f"{q['B'][0]:.4f}, q3 {q['B'][2]:.4f}; {len(val['B'])} runs); B better in {wins} of "
                         f"{len(pairs)} pairs")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("a", type=Path, nargs="?")
    ap.add_argument("b", type=Path, nargs="?")
    ap.add_argument("--report", type=Path, nargs="+", help="summarise earlier --out files instead of running")
    ap.add_argument("--out", type=Path, default=Path("build/ab_trees/ab.json"))
    ap.add_argument("--steps", type=int, default=10, help="profile_train's timed iterations a phase")
    ap.add_argument("--rounds", type=int, default=1, help="times to run the order A, B, B, A")
    ap.add_argument("--tools", nargs="+", choices=sorted(TOOLS), default=["slice", "train"])
    ap.add_argument("--bf16", action="store_true", help="profile_slice converts with --bf16")
    ap.add_argument("--enc-f32", action="store_true", help="... and --enc-f32")
    args = ap.parse_args(argv)
    flags = (["--bf16"] if args.bf16 else []) + (["--enc-f32"] if args.enc_f32 else [])
    if args.report:
        runs = [r for f in args.report for r in json.loads(f.read_text())["runs"]]
        print("\n".join(report(runs)))
        return dict(runs=runs)
    if args.a is None or args.b is None:
        ap.error("give two checkouts, or --report FILE")
    trees = {"A": args.a.resolve(), "B": args.b.resolve()}
    runs = []
    for i, tag in enumerate("ABBA" * args.rounds):
        for tool in args.tools:
            out = (args.out.parent / f"run{i}_{tag}_{tool}.json").resolve()
            out.parent.mkdir(parents=True, exist_ok=True)
            res = run_tool(trees[tag], tool, out, out.parent / "work" / f"run{i}_{tag}_{tool}", args.steps,
                           flags)
            runs.append(dict(order=i, tree=tag, path=str(trees[tag]), tool=tool, result=res))
            print(summary(f"run {i} ({tag})", tool, res), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(trees={k: str(v) for k, v in trees.items()}, runs=runs), indent=1) + "\n")
    print("\n".join(report(runs)))
    return dict(runs=runs)


if __name__ == "__main__":
    main()
