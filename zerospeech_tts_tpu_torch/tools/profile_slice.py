"""Where the conversion slice's time goes on one CUDA card.

    python -m zerospeech_tts_tpu_torch.tools.profile_slice [--out FILE] [--work DIR] [--bf16 [--enc-f32]]

On the seeded flagship workload (tools/workload.py: 8 wavs x 2 targets,
GL-100), in the exact configuration or with ``--bf16`` (``--enc-f32``: the
encoder kept in f32) as the CLI's flags of those names, it measures, in one
process:

- the CLI ``convert`` wall, first (kernel builds included) and 3 warm runs;
- ``Converter.convert_wavs_multi`` wall over ``--reps`` warm runs, and the
  same at GL-0 (the vocoder's iterations left out);
- the frontend and Griffin-Lim kernels beside their plain versions at
  chip_smoke's shapes (8 x 512 frames; 16 x 512 frames x 8 iterations),
  and kernel 2 at its test shape (B=16 T=512 H=512) in the decoder's dtype;
- one ``torch.profiler`` trace of a warm ``convert_wavs_multi``: device
  time by kernel, kernel 2's device time in f32 and in bf16 (the path
  times), and the device's busy share of the wall.

Run it in two checkouts in one session to compare them. Writes one JSON
object to ``--out`` and prints a summary.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch


def _quartiles(xs) -> dict:
    q1, med, q3 = np.percentile(xs, [25, 50, 75])
    return dict(runs=list(xs), median=float(med), q1=float(q1), q3=float(q3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="build/profile_slice/profile.json")
    ap.add_argument("--work", default="build/profile_slice", help="scratch dir for bundle, wavs, results")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--bf16", action="store_true", help="convert in bf16 (the CLI's --bf16)")
    ap.add_argument("--enc-f32", action="store_true", help="with --bf16: the encoder in f32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.config import AudioConfig
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.ops import frontend, griffin_lim, gru
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.tools.workload import (
        TARGETS, WAV_SAMPLES, card, cuda_ms, device_rows, speechlike, sync_wall, write_workload,
    )

    work = Path(args.work)
    flags = (["--bf16"] if args.bf16 else []) + (["--enc-f32"] if args.bf16 and args.enc_f32 else [])
    res: dict = {"card": card(), "flags": flags}
    _, _, speakers, _ = write_workload(work)

    def cli_run(tag):
        return sync_wall(lambda: cli.main([
            "convert", "--from-export", str(work / "bundle"), "--from-wavs", str(work / "wavs"),
            "-result_dir", str(work / tag), "--target", *TARGETS, "--device", "cuda", *flags]))

    res["cli_first_s"] = cli_run("first")
    res["cli_warm_s"] = [cli_run(f"warm{i}") for i in range(3)]

    b = load_export(work / "bundle")
    dt = torch.bfloat16 if args.bf16 else torch.float32
    conv = Converter(b.hps, b.acfg, *from_flax({"enc": b.enc, "dec": b.dec}), stats=b.stats, device="cuda",
                     compute_dtype=dt, encoder_dtype=torch.float32 if args.bf16 and args.enc_f32 else None)
    ys = [load_wav(work / "wavs" / f"utt{i}.wav", b.acfg.sr) for i in range(len(WAV_SAMPLES))]
    ids = [speakers[t] for t in TARGETS]

    def run():
        conv.convert_wavs_multi(ys, ids, tgt_names=list(TARGETS))

    run()
    res["convert_wavs_multi_s"] = _quartiles([sync_wall(run) for _ in range(args.reps)])
    conv.gl_iters = 0
    run()
    res["convert_wavs_multi_gl0_s"] = _quartiles([sync_wall(run) for _ in range(3)])
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
    g = torch.Generator().manual_seed(0)  # kernel 2 at its test shape, in the decoder's dtype
    xw, wh, bh = (torch.randn(16, 512, 1536, generator=g), torch.randn(512, 1536, generator=g) / 512**0.5,
                  0.1 * torch.randn(1536, generator=g))
    xw, wh, bh = (a.to("cuda", dt) for a in (xw, wh, bh))
    res["gru_16x512_ms"] = cuda_ms(lambda: gru.gru_scan(xw, wh, bh), 10)

    from torch.profiler import ProfilerActivity, profile

    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res["profiled_wall_s"] = sync_wall(run)
    res["profiled_launches"] = ops.launch_counts()
    rows = device_rows(prof)
    res["device_ms"] = sum(r["ms"] for r in rows)
    res["device_busy_share"] = res["device_ms"] / 1e3 / res["profiled_wall_s"]
    scans = [r for r in rows if "gru_scan" in r["name"]]  # kernel 2's rows, by the dtype in their names
    bf16 = [r for r in scans if "bf16" in r["name"] or "bfloat16" in r["name"]]
    res["gru_bf16_path_ms"] = sum(r["ms"] for r in bf16)
    res["gru_f32_path_ms"] = sum(r["ms"] for r in scans) - res["gru_bf16_path_ms"]
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
