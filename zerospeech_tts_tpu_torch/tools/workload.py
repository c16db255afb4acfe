"""The seeded flagship workloads that ``chip_smoke.py``,
``tools/profile_slice.py`` and ``tools/profile_train.py`` run, and the
measurement helpers they share (CUDA-event timer, synchronized wall
clock, card name, profiler kernel rows, a control for kernel 2's bf16
mode).

Conversion: 8 synthetic "voiced" wavs of 1.5-6.4 s converted to V001 and
V002 by a bundle at flagship width (``hps/zerospeech.json``) whose weights
and speaker statistics come from a seed. Training: a corpus of such wavs
in the ZeroSpeech layout, 6 speakers (V001 and V002 among them) x 4
utterances of 3-6 s. Corpus conversion: a test split of 4 speakers x 6
such wavs of 1-8 s plus one of 27 s (over 2,048 frames).
"""

from __future__ import annotations

import subprocess
import time
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


def fullscale(n: int, seed: int) -> np.ndarray:
    """Seeded full-scale signal of one of four kinds (seed % 4): the
    speech-like voice scaled to a peak of 0.99; a 0.99 tone at 2, 4 or 7
    kHz under a quiet 1,234 Hz tone of 3e-4 (loud frames whose quiet bins
    lie between 1e-2 and 1e-1); or a 0.99 square wave at 300 Hz."""
    kind = seed % 4
    t = np.arange(n) / 16000
    if kind == 0:
        y = speechlike(n, seed)
        return (0.99 * y / np.abs(y).max()).astype(np.float32)
    if kind == 3:
        return (0.99 * np.sign(np.sin(2 * np.pi * 300 * t + seed))).astype(np.float32)
    f = (2000, 4000, 7000)[(kind - 1 + seed // 4) % 3]
    y = 0.99 * np.sin(2 * np.pi * f * t + seed) + 3e-4 * np.sin(2 * np.pi * 1234 * t)
    return y.astype(np.float32)


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


def gru_scan_bf16_state(xw, wh, bh, lengths=None, *, reverse: bool = False):
    """A control for kernel 2's bf16 mode, never called by the port: the
    plain bf16 recurrence (ops/gru.py ``gru_scan_plain``) with the state
    rounded to bf16 after every step, the arithmetic of a bf16 ``lax.scan``
    (``pallas_gru.py:39-41``). A kernel that rounded its state between
    steps would sit as far from the plain version as this does."""
    import torch

    b, t, h3 = xw.shape
    h = h3 // 3
    hcur = xw.new_zeros(b, h, dtype=torch.float32)
    ys = xw.new_empty(b, t, h)
    wh_f, bh_f = wh.float(), bh.float()
    for ti in range(t - 1, -1, -1) if reverse else range(t):
        hr, hz, hn = (hcur @ wh_f + bh_f).split(h, dim=-1)  # hcur holds bf16 values
        xr, xz, xn = xw[:, ti].float().split(h, dim=-1)
        r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
        hnew = ((1.0 - z) * torch.tanh(xn + r * hn) + z * hcur).to(torch.bfloat16).float()
        if lengths is not None:
            hnew = torch.where((ti < lengths)[:, None], hnew, hcur)
        ys[:, ti] = hnew
        hcur = hnew
    return ys


def sync_wall(fn) -> float:
    """Host seconds of fn(), from a synchronized start to a synchronized end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip()


def device_rows(prof) -> list[dict]:
    """The kernel rows of a ``torch.profiler`` trace, longest first:
    {"name", "ms", "count"}. Host ranges (autograd functions) and GPU-side
    user annotations (``Optimizer.step#Adam.step``, the name of a host
    range) are left out: they span kernels that have rows of their own."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type != DeviceType.CUDA}
    rows = []
    for e in events:
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if (dev > 0 and e.device_type == DeviceType.CUDA and e.key not in host_keys
                and not getattr(e, "is_user_annotation", False)):
            rows.append(dict(name=e.key[:100], ms=dev / 1e3, count=e.count))
    return sorted(rows, key=lambda r: -r["ms"])


TRAIN_SPEAKERS = ("S001", "S002", "S003", "S004", "V001", "V002")


def write_train_corpus(out: str | Path, seed: int = 0, n_utts: int = 4) -> Path:
    """``<out>/corpus`` in the ZeroSpeech layout (train/unit/S*_<i>.wav,
    train/voice/V*_<i>.wav, test/T001_0.wav), seeded wavs of 3-6 s."""
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav

    root = Path(out) / "corpus"
    rng = np.random.default_rng(seed)
    for si, spk in enumerate(TRAIN_SPEAKERS):
        sub = "voice" if spk.startswith("V") else "unit"
        for i in range(n_utts):
            n = int(rng.uniform(3.0, 6.0) * 16000)
            save_wav(root / "train" / sub / f"{spk}_{i}.wav", speechlike(n, (7 * si + i + seed) % 24), 16000)
    save_wav(root / "test" / "T001_0.wav", speechlike(52000, 1000 + seed), 16000)
    return root


TEST_SPEAKERS = ("T001", "T002", "T003", "T004")
LONG_TEST_SAMPLES = 27 * 16000  # 2,161 frames: Griffin-Lim past 2,048 frames


def write_test_corpus(out: str | Path, seed: int = 0, n_utts: int = 6) -> Path:
    """``<out>/corpus/test/<spk>_<i>.wav``: seeded speech-like wavs of 1-8 s,
    ``n_utts`` for each of TEST_SPEAKERS, plus T005_0 of 27 s."""
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav

    root = Path(out) / "corpus"
    rng = np.random.default_rng(seed)
    for si, spk in enumerate(TEST_SPEAKERS):
        for i in range(n_utts):
            n = int(rng.uniform(1.0, 8.0) * 16000)
            save_wav(root / "test" / f"{spk}_{i}.wav", speechlike(n, (5 * si + i + seed) % 24), 16000)
    save_wav(root / "test" / "T005_0.wav", speechlike(LONG_TEST_SAMPLES, 23), 16000)
    return root
