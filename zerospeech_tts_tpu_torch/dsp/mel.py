"""Mel filterbank construction (Slaney scale + Slaney area-normalization).

The reference builds its filterbank with ``librosa.filters.mel`` defaults
(ref preprocess.py:~20-80 ``get_spectrograms``; SURVEY.md §7 flags the
filterbank as the #1 parity trap). librosa's defaults are htk=False and
norm='slaney', i.e. the Slaney mel scale (linear below 1 kHz, logarithmic
above) with each triangle scaled to unit area. This module reimplements
that construction exactly, in numpy, with no librosa dependency.

Built once on the host; the result is a static [n_mels, n_freq] matrix that
the frontend kernel (ops/frontend.py) contracts against. A copy of
``zerospeech_tts_tpu/dsp/mel.py``.
"""

from __future__ import annotations

import numpy as np

# Slaney mel-scale constants (Auditory Toolbox / librosa htk=False).
_F_SP = 200.0 / 3.0          # Hz per mel below the break frequency
_MIN_LOG_HZ = 1000.0         # break frequency
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # mels per log-Hz step above the break


def hz_to_mel(freq):
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    # np.where evaluates both branches; clip to avoid log of non-positives.
    safe = np.maximum(freq, 1e-10)
    mels = np.where(log_region, _MIN_LOG_MEL + np.log(safe / _MIN_LOG_HZ) / _LOGSTEP, mels)
    return mels


def mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    freq = mel * _F_SP
    log_region = mel >= _MIN_LOG_MEL
    freq = np.where(log_region, _MIN_LOG_HZ * np.exp(_LOGSTEP * (mel - _MIN_LOG_MEL)), freq)
    return freq


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape [n_mels, n_fft // 2 + 1].

    Matches ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` defaults
    (Slaney scale, Slaney norm) to float64 precision.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_freq = n_fft // 2 + 1

    fft_freqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # [n_mels + 2] band edges

    fdiff = np.diff(hz_pts)                      # [n_mels + 1]
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # [n_mels + 2, n_freq]

    lower = -ramps[:-2] / fdiff[:-1, None]       # rising slope
    upper = ramps[2:] / fdiff[1:, None]          # falling slope
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: each triangle integrates to ~2 / bandwidth.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)


def mel_inverse_basis(mel_basis: np.ndarray) -> np.ndarray:
    """Pseudo-inverse used by melspectrogram2wav to lift mel back to linear
    frequency before Griffin-Lim (ref utils.py melspectrogram2wav, M)."""
    return np.linalg.pinv(mel_basis.astype(np.float64)).astype(np.float32)
