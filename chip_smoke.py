#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zerospeech_tts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA card (or outside a checkout of the repo).
2. Builds the three hand-written kernels from csrc/ with nvcc (sm_90a).
3. Holds each kernel against its plain PyTorch version on the card at the
   conversion path's flagship shapes, and times both.
4. Converts a seeded 8-wav, 2-target corpus at flagship width
   (hps/zerospeech.json, random weights from a seed, GL-100) through the
   port's CLI, counting kernel launches, and checks the outputs; then holds
   the card's conversion of one utterance against the plain path on the CPU.
5. Prints the card (nvidia-smi name, power limit), one JSON line with the
   kernels' results, and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, so the run exits non-zero and prints no last line.
Scratch files go to build/chip_smoke/ inside the checkout.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
SRC = "zerospeech_tts_tpu_torch/csrc"
REPLACES = {
    "frontend": "zerospeech_tts_tpu/ops/pallas_frontend.py:74",
    "gru": "zerospeech_tts_tpu/ops/pallas_gru.py:84",
    "griffin_lim": "zerospeech_tts_tpu/ops/pallas_gl.py:470",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    try:
        import numpy as np

        from zerospeech_tts_tpu_torch import ops
        from zerospeech_tts_tpu_torch.config import AudioConfig
        from zerospeech_tts_tpu_torch.dsp import audio
        from zerospeech_tts_tpu_torch.ops import build, frontend, griffin_lim, gru
        from zerospeech_tts_tpu_torch.tools.workload import (
            TARGETS, WAV_SAMPLES, cuda_ms, speechlike, write_workload,
        )
    except ImportError as e:
        fail(f"zerospeech_tts_tpu_torch is not importable beside {__file__} ({e})")

    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # ------------------------------------------------------------- build
    for name in ops.KERNELS:
        t0 = time.perf_counter()
        build.load(name)
        print(f"build {name}: {time.perf_counter() - t0:.2f} s "
              f"(nvcc {build.build_seconds[name]:.2f} s)", flush=True)
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ------------------------------------------- kernels vs plain versions
    cfg = AudioConfig()
    results = {}
    n = 512 * cfg.hop_length - 1  # 512 frames
    y = torch.from_numpy(np.stack([speechlike(n, s) for s in range(8)])).to(dev)
    lens = torch.tensor([n, n - 900, 90000, 70000, n, 60001, 99999, 81234], device=dev)
    ypad = audio.mirror_pad(audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2, lens).contiguous()
    mel_k, mag_k = frontend.fused_frontend(ypad, cfg, 512)
    torch.cuda.synchronize()
    mel_p, mag_p = frontend.frontend_plain(ypad, cfg, 512)
    err = max((mel_k - mel_p).abs().max().item(), (mag_k - mag_p).abs().max().item())
    ms = cuda_ms(lambda: frontend.fused_frontend(ypad, cfg, 512), 20)
    plain_ms = cuda_ms(lambda: frontend.frontend_plain(ypad, cfg, 512), 20)
    print(f"frontend 8x512: max_abs_err {err:.3e} (atol 1e-4)  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    check(err <= 1e-4, f"frontend kernel disagrees with its plain version: {err}")
    results["frontend"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    gen = torch.Generator().manual_seed(0)
    gru_errs, gru_ms = [], {}
    for tag, b, t, rev, masked in (("decoder fwd", 16, 512, False, False),
                                   ("encoder rev masked", 8, 64, True, True)):
        h = 512
        xw = torch.randn(b, t, 3 * h, generator=gen).to(dev)
        wh = (torch.randn(h, 3 * h, generator=gen) / math.sqrt(h)).to(dev)
        bh = (0.1 * torch.randn(3 * h, generator=gen)).to(dev)
        ln = torch.tensor([64, 61, 40, 64, 33, 9, 57, 1], dtype=torch.int32, device=dev) if masked else None
        ys_k = gru.gru_scan(xw, wh, bh, ln, reverse=rev)
        torch.cuda.synchronize()
        ys_p = gru.gru_scan_plain(xw, wh, bh, ln, reverse=rev)
        e = (ys_k - ys_p).abs().max().item()
        k_ms = cuda_ms(lambda: gru.gru_scan(xw, wh, bh, ln, reverse=rev), 5)
        p_ms = cuda_ms(lambda: gru.gru_scan_plain(xw, wh, bh, ln, reverse=rev), 3)
        print(f"gru {tag} B={b} T={t} H={h}: max_abs_err {e:.3e} (atol 1e-4)  "
              f"kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms")
        check(e <= 1e-4, f"gru kernel ({tag}) disagrees with its plain version: {e}")
        gru_errs.append(e)
        gru_ms[tag] = (k_ms, p_ms)
    results["gru"] = dict(max_abs_err=max(gru_errs), ms=gru_ms["decoder fwd"][0],
                          plain_ms=gru_ms["decoder fwd"][1])

    def consistency(out, amp):
        re, im = audio.stft(out, cfg)
        m2 = torch.sqrt(re * re + im * im)[:, 4:-4]
        m = amp[:, 4:-4]
        return (torch.linalg.norm(m2 - m) / torch.linalg.norm(m)).item()

    def row_rel(a, b):  # signal rel-L2 of each row
        return torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)

    # Bars on the kernel's signal against the plain version's (both f32):
    # pooled, the worst row, and the worst row over its first and last
    # win_length samples alone, where the untrimmed overlap-add tails and
    # the full wss envelope act. Measured on an H100 at 16 x 512: 4.4e-4
    # pooled, 1.2e-3 worst row (momentum 0.99 amplifies the two summation
    # orders' rounding), 5e-5 at the edges. A row gone wrong reads ~1.
    edge = cfg.win_length
    gl_errs = []
    amp16 = audio.db_norm_to_amp(torch.cat([mag_p, mag_p.flip(0)]), cfg) ** cfg.gl_power
    n_long = 2499 * cfg.hop_length + 100
    _, mag_long = audio.wav_to_features(torch.from_numpy(speechlike(n_long, 9)).to(dev)[None], cfg)
    amp_long = audio.db_norm_to_amp(mag_long, cfg) ** cfg.gl_power
    for tag, amp in (("16x512", amp16.contiguous()), ("1x2500", amp_long.contiguous())):
        out_k = griffin_lim.griffin_lim(amp, cfg, n_iters=8)
        torch.cuda.synchronize()
        out_p = griffin_lim.griffin_lim_plain(amp, cfg, n_iters=8)
        check(out_k.shape == out_p.shape == (amp.shape[0], (amp.shape[1] - 1) * cfg.hop_length),
              f"griffin-lim output shape {tuple(out_k.shape)}")
        ck, cp = consistency(out_k, amp), consistency(out_p, amp)
        rel = (torch.linalg.norm(out_k - out_p) / torch.linalg.norm(out_p)).item()
        rel_row = row_rel(out_k, out_p).max().item()
        ends = lambda x: torch.cat([x[:, :edge], x[:, -edge:]], -1)  # noqa: E731
        rel_edge = row_rel(ends(out_k), ends(out_p)).max().item()
        e = (out_k - out_p).abs().max().item()
        line = (f"griffin-lim {tag} x8 iters: consistency kernel {ck:.5f} plain {cp:.5f} "
                f"(|diff| <= 1e-3)  signal rel-L2 {rel:.3e} (<= 1e-3), worst row {rel_row:.3e} "
                f"(<= 2e-3), worst row edges {rel_edge:.3e} (<= 1e-3)  max_abs_err {e:.3e}")
        if tag == "16x512":
            k_ms = cuda_ms(lambda: griffin_lim.griffin_lim(amp, cfg, n_iters=8), 3)
            p_ms = cuda_ms(lambda: griffin_lim.griffin_lim_plain(amp, cfg, n_iters=8), 3)
            line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
            results["griffin_lim"] = dict(ms=k_ms, plain_ms=p_ms, rel_l2=rel)
        print(line, flush=True)
        check(abs(ck - cp) <= 1e-3, f"griffin-lim kernel ({tag}) consistency {ck} vs plain {cp}")
        check(rel <= 1e-3, f"griffin-lim kernel ({tag}) signal rel-L2 {rel}")
        check(rel_row <= 2e-3, f"griffin-lim kernel ({tag}) worst row rel-L2 {rel_row}")
        check(rel_edge <= 1e-3, f"griffin-lim kernel ({tag}) worst row edge rel-L2 {rel_edge}")
        gl_errs.append(e)
    results["griffin_lim"]["max_abs_err"] = max(gl_errs)
    torch.cuda.synchronize()

    # ------------------------------------------------ the slice, end to end
    import scipy.io.wavfile

    from zerospeech_tts_tpu_torch import cli
    from zerospeech_tts_tpu_torch.convert import Converter, read_units
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax

    hps, acfg, speakers, n_params = write_workload(OUT, seed=0)
    wav_dir, result_dir = OUT / "wavs", OUT / "result"
    print(f"slice: {len(WAV_SAMPLES)} wavs x {len(TARGETS)} targets, flagship width ({n_params} params), "
          f"GL-{acfg.gl_iters}", flush=True)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cli.main([
        "convert", "--from-export", str(OUT / "bundle"), "--from-wavs", str(wav_dir),
        "-result_dir", str(result_dir), "--target", *TARGETS, "--device", "cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"slice wall {wall:.3f} s: {len(WAV_SAMPLES) / wall:.3f} utterances/s, "
          f"{out['n_wavs'] / wall:.3f} wav/s; launches {launches}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the conversion path")

    for i, ns in enumerate(WAV_SAMPLES):
        t = 1 + ns // acfg.hop_length
        u = read_units(result_dir / "units" / f"utt{i}.txt")
        check(u.shape == (-(-t // hps.downsample), hps.emb_size), f"utt{i} units shape {u.shape}")
        check(bool(((u == 0) | (u == 1)).all()), f"utt{i} units are not 0/1")
        for tgt in TARGETS:
            sr, pcm = scipy.io.wavfile.read(result_dir / tgt / f"utt{i}.wav")
            check(sr == 16000 and pcm.dtype == np.int16, f"{tgt}/utt{i}: {sr} Hz {pcm.dtype}")
            check(pcm.shape == ((t - 1) * acfg.hop_length,), f"{tgt}/utt{i}: {pcm.shape} samples")
            check(int(np.abs(pcm.astype(np.int32)).max()) > 100, f"{tgt}/utt{i} is silent")

    # reference: the card's conversion of the shortest utterance against the
    # plain path on the CPU (same bundle, GL-4)
    b = load_export(OUT / "bundle")
    enc_sd, dec_sd = from_flax({"enc": b.enc, "dec": b.dec})
    wav = load_wav(wav_dir / f"utt{len(WAV_SAMPLES) - 1}.wav", acfg.sr)
    ref = {}
    for device in ("cuda", "cpu"):
        conv = Converter(b.hps, b.acfg, enc_sd, dec_sd, gl_iters=4, stats=b.stats, device=device)
        ref[device] = conv.convert_wavs_multi(
            [wav], [speakers[t] for t in TARGETS], tgt_names=list(TARGETS)
        )
    agree = float((ref["cuda"][0][0] == ref["cpu"][0][0]).mean())

    def spec(pcm):
        re, im = audio.stft(torch.from_numpy(pcm.astype(np.float32) / 32768.0)[None], acfg)
        return torch.sqrt(re * re + im * im)

    pcm_rel = max(
        (torch.linalg.norm(spec(ref["cuda"][1][k][0]) - spec(ref["cpu"][1][k][0]))
         / torch.linalg.norm(spec(ref["cpu"][1][k][0]))).item()
        for k in range(len(TARGETS))
    )
    print(f"reference (utt{len(WAV_SAMPLES) - 1}, GL-4, card vs CPU plain): unit agreement "
          f"{agree:.6f} (>= 0.999)  PCM STFT-magnitude rel-L2 {pcm_rel:.3e} (<= 1e-2)")
    check(agree >= 0.999, f"units on the card disagree with the CPU reference: {agree}")
    check(pcm_rel <= 1e-2, f"audio on the card disagrees with the CPU reference: {pcm_rel}")
    check("jax" not in sys.modules, "jax was imported")

    kernels = [
        dict(name=name, route="cuda", source=f"{SRC}/{name}.cu", replaces=REPLACES[name],
             launches=launches[name], max_abs_err=results[name]["max_abs_err"],
             ms=results[name]["ms"], plain_ms=results[name]["plain_ms"])
        for name in ops.KERNELS
    ]
    (OUT / "result.json").write_text(json.dumps(
        dict(kernels=kernels, slice_wall_s=wall, utterances_per_s=len(WAV_SAMPLES) / wall,
             gl_rel_l2=results["griffin_lim"]["rel_l2"], reference_unit_agreement=agree,
             reference_pcm_rel_l2=pcm_rel, card=card_line()), indent=2) + "\n")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
