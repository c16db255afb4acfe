"""Host-side wav IO + silence trim (ref ``librosa.load`` / ``librosa.effects.trim``
calls in preprocess.py:~20-40; SURVEY.md §2 "Audio DSP").

librosa is not a dependency: wavs are decoded with scipy.io.wavfile (PCM /
float, any width) and resampled with scipy.signal.resample_poly when the
file rate differs from the target. ``trim_silence`` reimplements
librosa.effects.trim semantics (frame RMS in dB relative to the signal's
peak RMS, threshold top_db, frame_length=2048 / hop_length=512 defaults).

A copy of ``zerospeech_tts_tpu/dsp/wavio.py`` (numpy/scipy only), so the
PyTorch port reads and writes wavs without importing the JAX package.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import scipy.io.wavfile
import scipy.signal


def resample(y: np.ndarray, from_sr: int, to_sr: int) -> np.ndarray:
    """Polyphase resampling (librosa.load's resample step)."""
    if from_sr == to_sr:
        return np.asarray(y, np.float32)
    g = math.gcd(int(to_sr), int(from_sr))
    return scipy.signal.resample_poly(y, to_sr // g, from_sr // g).astype(np.float32)


def load_wav(path, sr: int) -> np.ndarray:
    """Decode a wav to float32 mono in [-1, 1] at sample rate ``sr``.
    ``path`` is a filesystem path or a binary file-like (e.g. BytesIO of
    an uploaded request body — see zerospeech_tts_tpu.serve)."""
    file_sr, data = scipy.io.wavfile.read(path if hasattr(path, "read") else str(path))
    if data.dtype == np.int16:
        y = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        y = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        y = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64
        y = data.astype(np.float32)
    if y.ndim == 2:
        y = y.mean(axis=1)
    return resample(y, file_sr, sr)


def save_wav(path: str | Path, y: np.ndarray, sr: int) -> None:
    """Write a wav as PCM16 (challenge submission format is 16 kHz wav).
    Accepts float in [-1, 1] or already-quantized int16 (the converter
    quantizes on-device to halve the transfer)."""
    y = np.asarray(y)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if y.dtype != np.int16:
        y = y.astype(np.float32)
        peak = np.max(np.abs(y)) if y.size else 0.0
        if peak > 1.0:
            y = y / peak
        y = (y * 32767.0).astype(np.int16)
    scipy.io.wavfile.write(str(path), sr, y)


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded frame RMS, matching librosa.feature.rms defaults."""
    pad = frame_length // 2
    ypad = np.pad(y, (pad, pad), mode="constant")
    n = 1 + len(y) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = ypad[idx]
    return np.sqrt(np.mean(frames**2, axis=1))


def trim_silence(
    y: np.ndarray, top_db: float = 15.0, frame_length: int = 2048, hop_length: int = 512
) -> np.ndarray:
    """Trim leading/trailing frames more than top_db below peak RMS
    (librosa.effects.trim semantics)."""
    if len(y) == 0:
        return y
    rms = _frame_rms(y, frame_length, hop_length)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(np.max(rms), 1e-10))
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return y[:0]
    start = int(keep[0]) * hop_length
    end = min(len(y), int(keep[-1] + 1) * hop_length)
    return y[start:end]
