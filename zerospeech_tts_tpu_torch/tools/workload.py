"""The seeded flagship workload that ``chip_smoke.py`` and
``tools/profile_slice.py`` run, and a CUDA-event timer.

The corpus is 8 synthetic "voiced" wavs of 1.5-6.4 s converted to V001 and
V002 by a bundle at flagship width (``hps/zerospeech.json``) whose weights
and speaker statistics come from a seed.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from zerospeech_tts_tpu_torch.config import AudioConfig, Hps, load_configs

FLAGSHIP_HPS = Path(__file__).resolve().parents[1] / "hps" / "zerospeech.json"
TARGETS = ("V001", "V002")
# 8 wavs of 1.5-6.4 s (samples at 16 kHz) -> frames 1 + n // 200 and their
# 64-frame buckets: 512 (pad 0, 11, 36), 384 (pad 63), 256 (pad 0),
# 320 (t=253 leaves pad 3 < 4, bumped a bucket), 256 (t=191, bumped), 128.
WAV_SAMPLES = [102200, 100000, 95000, 64000, 51000, 50400, 38000, 24000]


def speechlike(n: int, seed: int) -> np.ndarray:
    """Seeded harmonic 'voice' with slow amplitude modulation and noise:
    loud throughout (silence trimming keeps every sample)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 110 + 23 * seed
    y = sum(0.3 / k * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 6.28)) for k in range(1, 9))
    y = y * (0.75 + 0.25 * np.sin(2 * np.pi * 2.5 * t))
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


def write_workload(out: str | Path, seed: int = 0) -> tuple[Hps, AudioConfig, dict[str, int], int]:
    """Write ``<out>/bundle`` (flagship geometry, seeded weights, seeded
    stats for ``__global__``, V001 and V002) and ``<out>/wavs/utt<i>.wav``.
    Returns (hps, acfg, speaker map, parameter count)."""
    from zerospeech_tts_tpu_torch.data.speaker_norm import GLOBAL_KEY, SpeakerStats
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
    from zerospeech_tts_tpu_torch.export import save_export
    from zerospeech_tts_tpu_torch.params import init_params

    out = Path(out)
    hps, acfg = load_configs(FLAGSHIP_HPS)
    rng = np.random.default_rng(seed)
    stat_names = (GLOBAL_KEY, *TARGETS)
    stats = SpeakerStats(
        {s: rng.uniform(0.3, 0.6, hps.n_feat).astype(np.float32) for s in stat_names},
        {s: rng.uniform(0.05, 0.2, hps.n_feat).astype(np.float32) for s in stat_names},
    )
    speakers = {f"S{i:03d}": i for i in range(hps.n_speakers - len(TARGETS))}
    speakers.update({t: hps.n_speakers - len(TARGETS) + k for k, t in enumerate(TARGETS)})
    tree = init_params(hps, seed=seed)
    info = save_export(out / "bundle", hps, acfg, tree["enc"], tree["dec"], speakers, stats=stats)
    wav_dir = out / "wavs"
    for old in list(wav_dir.glob("*.wav")):
        old.unlink()
    for i, ns in enumerate(WAV_SAMPLES):
        save_wav(wav_dir / f"utt{i}.wav", speechlike(ns, i), acfg.sr)
    return hps, acfg, speakers, info["params_bytes"] // 4


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events), after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
