"""Where a training step's time goes on one CUDA card, at flagship width.

    python -m zerospeech_tts_tpu_torch.tools.profile_train [--out FILE] [--work DIR] [--steps N]

On the seeded training corpus (tools/workload.py: 6 speakers x 4 wavs of
3-6 s, hps/zerospeech.json, batch 32, pairs on) it measures, in one
process and after two warm-up iterations of each phase:

- steps/s of each phase (pretrain_AE, pretrain_C, train, patchGAN with one
  iteration = n_critic + 1 steps) over ``--steps`` iterations, host clock
  around work that ends in a synchronize;
- one ``torch.profiler`` trace of ``--steps`` ``train`` steps: device time
  by kernel and the device's busy share of the wall;
- the kernel launches of those steps.

Corpus build and model init are set-up and reported apart. Writes one
JSON object to ``--out`` and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="build/profile_train/profile.json")
    ap.add_argument("--work", default="build/profile_train", help="scratch dir for the corpus")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")

    from zerospeech_tts_tpu_torch import ops
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.data.corpus import build_corpus
    from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset
    from zerospeech_tts_tpu_torch.tools.workload import card, device_rows, sync_wall, write_train_corpus
    from zerospeech_tts_tpu_torch.train import Solver, init_state

    res: dict = {"card": card(), "steps": args.steps}
    work = Path(args.work)
    hps, acfg = load_configs(DEFAULT_HPS_PATH)
    t0 = time.perf_counter()
    build_corpus(write_train_corpus(work), work / "ds", acfg, device="cuda")
    ds = DeviceDataset.from_corpus(work / "ds", hps, target_speakers=["V001", "V002"], device="cuda")
    state = init_state(hps, device="cuda")
    solver = Solver(hps)
    torch.cuda.synchronize()
    res["setup_s"] = time.perf_counter() - t0
    res["batch_size"] = hps.batch_size

    res["phases"] = {}
    for mode in ("pretrain_AE", "pretrain_C", "train", "patchGAN"):
        solver.train(state, ds, mode, 2)  # warm-up
        step0 = state.step
        dt = sync_wall(lambda: solver.train(state, ds, mode, args.steps))
        n = state.step - step0
        res["phases"][mode] = dict(steps=n, seconds=dt, steps_per_s=n / dt)

    from torch.profiler import ProfilerActivity, profile

    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res["profiled_wall_s"] = sync_wall(lambda: solver.train(state, ds, "train", args.steps))
    res["profiled_launches"] = ops.launch_counts()
    rows = device_rows(prof)
    res["device_ms"] = sum(r["ms"] for r in rows)
    res["device_busy_share"] = res["device_ms"] / 1e3 / res["profiled_wall_s"]
    res["device_kernels"] = rows[:40]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({k: v for k, v in res.items() if k != "device_kernels"}))
    for r in rows[:20]:
        print(f"  {r['ms']:9.3f} ms  x{r['count']:<6d} {r['name']}")
    return res


if __name__ == "__main__":
    main()
