"""Host-side wav IO + silence trim (ref ``librosa.load`` / ``librosa.effects.trim``
calls in preprocess.py:~20-40; SURVEY.md §2 "Audio DSP").

librosa is not a dependency: wavs are decoded with scipy.io.wavfile (PCM /
float, any width) and resampled with scipy.signal.resample_poly when the
file rate differs from the target. ``trim_silence`` reimplements
librosa.effects.trim semantics (frame RMS in dB relative to the signal's
peak RMS, threshold top_db, frame_length=2048 / hop_length=512 defaults).
Its frame RMS sums the squares of each hop block once and builds every
frame from the block sums in the order numpy's pairwise sum of the frame
takes, so it equals the gather over every frame bit for bit (the gather
stays for arguments whose frames do not split on block edges).

Otherwise a copy of ``zerospeech_tts_tpu/dsp/wavio.py`` (numpy/scipy only),
so the PyTorch port reads and writes wavs without importing the JAX package.
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


# frame RMS computations (one a trim_silence call) by the path _frame_rms took
_trims = {"blocks": 0, "gather": 0}


def trim_counts() -> dict[str, int]:
    """How many frame RMS computations took the block path and the gather path."""
    return dict(_trims)


def _blocks_fit(y: np.ndarray, frame_length: int, hop_length: int) -> bool:
    """Whether numpy's pairwise sum of a frame splits on hop-block edges:
    it halves a sum of more than 128 elements at a multiple of 8, so a frame
    of hop x 2^j, with hop >= 128 a multiple of 8, is summed as a tree of
    whole blocks. float32 and float64 are the dtypes np.mean sums in."""
    k = frame_length // hop_length
    return (y.dtype in (np.float32, np.float64) and hop_length >= 128 and hop_length % 8 == 0
            and k >= 1 and k * hop_length == frame_length and k & (k - 1) == 0)


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded frame RMS, matching librosa.feature.rms defaults.

    Where the frame is a power-of-two number of hops, each frame's sum of
    squares is built from the pairwise sums of its hop blocks in the order
    numpy's own sum of the frame takes ((b0 + b1) + (b2 + b3) for 2048 / 512),
    so the result equals the gather formula's bit for bit while each sample
    is squared and summed once, not frame_length / hop_length times."""
    y = np.asarray(y)
    pad = frame_length // 2
    n = 1 + len(y) // hop_length
    if not _blocks_fit(y, frame_length, hop_length):
        _trims["gather"] += 1
        ypad = np.pad(y, (pad, pad), mode="constant")
        idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
        frames = ypad[idx]
        return np.sqrt(np.mean(frames**2, axis=1))
    _trims["blocks"] += 1
    k = frame_length // hop_length
    sq = np.pad(y, (pad, pad), mode="constant")
    np.square(sq, out=sq)
    s = sq[: (n + k - 1) * hop_length].reshape(n + k - 1, hop_length).sum(axis=1)
    step = 1
    while step < k:
        s = s[:-step] + s[step:]
        step *= 2
    # np.mean's own division (a count of type intp, cast back to y's dtype)
    np.true_divide(s, np.intp(frame_length), out=s, casting="unsafe")
    return np.sqrt(s)


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
