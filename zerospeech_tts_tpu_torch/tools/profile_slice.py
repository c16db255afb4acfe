"""Where the conversion slice's time goes on one CUDA card.

    python -m zerospeech_tts_tpu_torch.tools.profile_slice [--out FILE] [--work DIR]

On the seeded flagship workload (tools/workload.py: 8 wavs x 2 targets,
GL-100) it measures, in one process:

- the CLI ``convert`` wall, first (kernel builds included) and 3 warm runs;
- ``Converter.convert_wavs_multi`` wall over ``--reps`` warm runs, and the
  same at GL-0 (the vocoder's iterations left out);
- the frontend and Griffin-Lim kernels beside their plain versions at
  chip_smoke's shapes (8 x 512 frames; 16 x 512 frames x 8 iterations);
- one ``torch.profiler`` trace of a warm ``convert_wavs_multi``: device
  time by kernel and the device's busy share of the wall.

Run it in two checkouts in one session to compare them. Writes one JSON
object to ``--out`` and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch


def _wall(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _quartiles(xs) -> dict:
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return dict(runs=list(xs), median=float(med), q1=float(q1), q3=float(q3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="build/profile_slice/profile.json")
    ap.add_argument("--work", default="build/profile_slice", help="scratch dir for bundle, wavs, results")
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.config import AudioConfig
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.ops import frontend, griffin_lim
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.tools.workload import (
        TARGETS, WAV_SAMPLES, cuda_ms, speechlike, write_workload,
    )

    work = Path(args.work)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    res: dict = {"card": smi.stdout.strip()}
    _, _, speakers, _ = write_workload(work)

    def cli_run(tag):
        return _wall(lambda: cli.main([
            "convert", "--from-export", str(work / "bundle"), "--from-wavs", str(work / "wavs"),
            "-result_dir", str(work / tag), "--target", *TARGETS, "--device", "cuda"]))

    res["cli_first_s"] = cli_run("first")
    res["cli_warm_s"] = [cli_run(f"warm{i}") for i in range(3)]

    b = load_export(work / "bundle")
    conv = Converter(b.hps, b.acfg, *from_flax({"enc": b.enc, "dec": b.dec}), stats=b.stats,
                     device="cuda")
    ys = [load_wav(work / "wavs" / f"utt{i}.wav", b.acfg.sr) for i in range(len(WAV_SAMPLES))]
    ids = [speakers[t] for t in TARGETS]

    def run():
        conv.convert_wavs_multi(ys, ids, tgt_names=list(TARGETS))

    run()
    res["convert_wavs_multi_s"] = _quartiles([_wall(run) for _ in range(args.reps)])
    conv.gl_iters = 0
    run()
    res["convert_wavs_multi_gl0_s"] = _quartiles([_wall(run) for _ in range(3)])
    conv.gl_iters = b.acfg.gl_iters

    cfg = AudioConfig()
    n = 512 * cfg.hop_length - 1
    y = torch.from_numpy(np.stack([speechlike(n, s) for s in range(8)])).cuda()
    ypad = audio.mirror_pad(audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2).contiguous()
    res["frontend_8x512_ms"] = cuda_ms(lambda: frontend.fused_frontend(ypad, cfg, 512), 20)
    res["frontend_8x512_plain_ms"] = cuda_ms(lambda: frontend.frontend_plain(ypad, cfg, 512), 20)
    _, mag = frontend.frontend_plain(ypad, cfg, 512)
    amp = (audio.db_norm_to_amp(torch.cat([mag, mag.flip(0)]), cfg) ** cfg.gl_power).contiguous()
    res["gl_16x512x8_ms"] = cuda_ms(lambda: griffin_lim.griffin_lim(amp, cfg, n_iters=8), 5)
    res["gl_16x512x8_plain_ms"] = cuda_ms(lambda: griffin_lim.griffin_lim_plain(amp, cfg, n_iters=8), 5)

    from torch.profiler import ProfilerActivity, profile

    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res["profiled_wall_s"] = _wall(run)
    res["profiled_launches"] = ops.launch_counts()
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev > 0 and not e.key.startswith(("aten::", "cuda")):
            rows.append(dict(name=e.key[:100], ms=dev / 1e3, count=e.count))
    rows.sort(key=lambda r: -r["ms"])
    res["device_ms"] = sum(r["ms"] for r in rows)
    res["device_busy_share"] = res["device_ms"] / 1e3 / res["profiled_wall_s"]
    res["device_kernels"] = rows[:30]

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    print(json.dumps({k: v for k, v in res.items() if k != "device_kernels"}))
    for r in rows[:12]:
        print(f"  {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name']}")
    return res


if __name__ == "__main__":
    main()
