"""Audio frontend + Griffin-Lim vocoder (port of
``zerospeech_tts_tpu/dsp/audio.py``; ref ``preprocess.py get_spectrograms``
and ``utils.py spectrogram2wav``):

    wav -> preemphasis(0.97) -> centred STFT(1024, 200, 800) with
    length-aware mirror padding -> |mag| and 80-bin mel -> dB-norm to [0, 1]

and back: denormalise -> amp ** 1.2 -> fast Griffin-Lim -> de-emphasis.

Public functions take the JAX package's layout: signals [B, n] (or [n]),
spectrograms time-major [B, T, F]. The STFT is the window-folded real-DFT
formulation of the JAX ``fused`` method (``_fused_bases``): frame t is the
win_length samples of the padded signal at ``lpad + t*hop``, so it needs
``win_length % hop_length == 0``. The matrix work runs in the hand-written
kernels of :mod:`zerospeech_tts_tpu_torch.ops` (frontend, Griffin-Lim) on a
CUDA tensor and in their plain PyTorch versions on a CPU tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp.mel import mel_filterbank

# ---------------------------------------------------------------------------
# static per-config constants (host numpy, cached)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _window(cfg: AudioConfig) -> np.ndarray:
    """Periodic Hann of win_length, zero-padded centered to n_fft."""
    n = np.arange(cfg.win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / cfg.win_length)
    lpad = (cfg.n_fft - cfg.win_length) // 2
    out = np.zeros(cfg.n_fft, dtype=np.float64)
    out[lpad : lpad + cfg.win_length] = w
    return out.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _mel_basis(cfg: AudioConfig) -> np.ndarray:
    return mel_filterbank(cfg.sr, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.effective_fmax)


@functools.lru_cache(maxsize=8)
def _dft_basis(cfg: AudioConfig) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis: frames[T, n_fft] @ basis -> re/im[T, n_freq]."""
    n = np.arange(cfg.n_fft)[:, None]
    k = np.arange(cfg.n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_basis(cfg: AudioConfig) -> tuple[np.ndarray, np.ndarray]:
    """Inverse real-DFT: re/im[T, n_freq] @ basis -> frames[T, n_fft]
    (interior bins count twice, DC/Nyquist once)."""
    n = np.arange(cfg.n_fft)[None, :]
    k = np.arange(cfg.n_freq)[:, None]
    ang = 2.0 * np.pi * n * k / cfg.n_fft
    w = np.full((cfg.n_freq, 1), 2.0)
    w[0] = 1.0
    if cfg.n_fft % 2 == 0:
        w[-1] = 1.0
    scale = w / cfg.n_fft
    return (np.cos(ang) * scale).astype(np.float32), (-np.sin(ang) * scale).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _fused_bases(cfg: AudioConfig):
    """Window-folded real-DFT bases over the window support only:
    analysis ca/sa [win, n_freq] = win * DFT rows, synthesis cs/ss
    [n_freq, win] = inverse-DFT columns * win (see the JAX docstring)."""
    assert cfg.win_length % cfg.hop_length == 0
    lpad = (cfg.n_fft - cfg.win_length) // 2
    sl = slice(lpad, lpad + cfg.win_length)
    win = _window(cfg).astype(np.float64)[sl]
    c, s = _dft_basis(cfg)
    ca = (win[:, None] * c[sl].astype(np.float64)).astype(np.float32)
    sa = (win[:, None] * s[sl].astype(np.float64)).astype(np.float32)
    ci, si = _idft_basis(cfg)
    cs = (ci.astype(np.float64)[:, sl] * win[None, :]).astype(np.float32)
    ss = (si.astype(np.float64)[:, sl] * win[None, :]).astype(np.float32)
    return ca, sa, cs, ss


@functools.lru_cache(maxsize=32)
def _fused_wss(cfg: AudioConfig, t: int) -> np.ndarray:
    """Window-square OLA envelope over the untrimmed output span
    [(t - 1 + win/hop) * hop] (ones where it vanishes)."""
    win = _window(cfg).astype(np.float64)
    lpad = (cfg.n_fft - cfg.win_length) // 2
    w2 = (win[lpad : lpad + cfg.win_length]) ** 2
    r = cfg.win_length // cfg.hop_length
    out_len = (t - 1 + r) * cfg.hop_length
    wss = np.zeros(out_len)
    idx = np.arange(t)[:, None] * cfg.hop_length + np.arange(cfg.win_length)[None, :]
    np.add.at(wss, idx, w2[None, :])
    wss = np.where(wss > 1e-11, wss, 1.0)
    return wss.astype(np.float32)


def n_frames_for(n_samples: int, cfg: AudioConfig) -> int:
    """librosa center=True frame count: 1 + n_samples // hop."""
    return 1 + n_samples // cfg.hop_length


def gl_lead(cfg: AudioConfig) -> int:
    """Offset of the librosa istft span in the untrimmed overlap-add."""
    return cfg.n_fft // 2 - (cfg.n_fft - cfg.win_length) // 2


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------


def preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def mirror_pad(y: torch.Tensor, pad: int, length=None) -> torch.Tensor:
    """Centre reflect-padding of [B, n] rows about each row's TRUE length.

    The first ``pad + length + pad`` positions of row b equal
    ``np.pad(y[b, :length], (pad, pad), 'reflect')`` (the librosa center=True
    boundary, at any fold depth) however much zero bucket padding follows.
    ``length=None`` means the full row. Past that span the row keeps
    folding about the true length; those positions feed only frames at or
    past the true frame count, which callers discard (the JAX version
    leaves a static reflect pad there instead)."""
    b, n = y.shape
    if length is None:
        length = torch.full((b,), n, dtype=torch.long, device=y.device)
    L = torch.as_tensor(length, device=y.device).to(torch.long).clamp(min=2)[:, None]
    period = 2 * (L - 1)  # edge-excluded reflection period (np.pad 'reflect')
    m = torch.arange(-pad, n + pad, device=y.device)[None, :].abs() % period
    j = torch.minimum(m, period - m).clamp(max=n - 1)
    return torch.gather(y, 1, j)


def _fused_segments(ypad: torch.Tensor, cfg: AudioConfig, n_frames: int) -> torch.Tensor:
    """[B, n + n_fft] mirror-padded signal -> [B, T, win] window-support
    segments (frame t starts at lpad + t*hop). The JAX version pads inside;
    here the padded signal is the frontend kernel's own input."""
    lpad = (cfg.n_fft - cfg.win_length) // 2
    return ypad[:, lpad:].unfold(-1, cfg.win_length, cfg.hop_length)[:, :n_frames]


def stft(y: torch.Tensor, cfg: AudioConfig, length=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain centred STFT of [B, n] -> (re, im) [B, T, n_freq] (the JAX
    ``stft(method="fused")``)."""
    ca, sa, _, _ = _fused_bases(cfg)
    segs = _fused_segments(mirror_pad(y, cfg.n_fft // 2, length), cfg, n_frames_for(y.shape[-1], cfg))
    return segs @ torch.from_numpy(ca).to(y.device), segs @ torch.from_numpy(sa).to(y.device)


def amp_to_db_norm(amp: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """20*log10(max(1e-5, amp)) then [0,1] normalization (ref preprocess)."""
    db = 20.0 * torch.log10(torch.clamp(amp, min=1e-5))
    return torch.clamp((db - cfg.ref_db + cfg.max_db) / cfg.max_db, 1e-8, 1.0)


def db_norm_to_amp(x: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    db = torch.clamp(x, 0.0, 1.0) * cfg.max_db - cfg.max_db + cfg.ref_db
    return torch.pow(10.0, db * 0.05)


def wav_to_features(y: torch.Tensor, cfg: AudioConfig, length=None):
    """wav [B, n] (or [n]) -> (mel [B, T, n_mels], mag [B, T, n_freq]), both
    dB-normalised to [0, 1], T = 1 + n // hop. ``length`` ([B] true sample
    counts of zero bucket-padded rows) gives the true frames the
    exact-length values; frames past the true count are fold garbage.
    The fused kernel (ops/frontend.py) computes everything after framing."""
    from zerospeech_tts_tpu_torch.ops.frontend import fused_frontend

    squeeze = y.dim() == 1
    if squeeze:
        y = y[None]
        length = None if length is None else torch.as_tensor(length).reshape(1)
    ypad = mirror_pad(preemphasis(y, cfg.preemphasis), cfg.n_fft // 2, length)
    mel, mag = fused_frontend(ypad.contiguous(), cfg, n_frames_for(y.shape[-1], cfg))
    return (mel[0], mag[0]) if squeeze else (mel, mag)


# ---------------------------------------------------------------------------
# vocoder
# ---------------------------------------------------------------------------


def de_emphasis(x: torch.Tensor, coef: float) -> torch.Tensor:
    """Inverse of preemphasis along the last axis, y[n] = x[n] + coef*y[n-1],
    as a log-depth doubling scan (each pass folds in the prefix 2^k samples
    back, weighted coef^(2^k); the JAX version uses an associative scan)."""
    y = x
    d, c = 1, float(coef)
    while d < x.shape[-1] and c != 0.0:
        y = torch.cat([y[..., :d], y[..., d:] + c * y[..., :-d]], dim=-1)
        d, c = 2 * d, c * c
    return y


def spectrogram2wav(mag_norm: torch.Tensor, cfg: AudioConfig, n_iters: int | None = None):
    """Normalised linear spectrograms [B, T, n_freq] -> wavs [B, (T-1)*hop]:
    denormalise -> amp ** gl_power -> Griffin-Lim (ops/griffin_lim.py) ->
    de-emphasis (ref utils.py spectrogram2wav)."""
    from zerospeech_tts_tpu_torch.ops.griffin_lim import griffin_lim

    amp = db_norm_to_amp(mag_norm, cfg) ** cfg.gl_power
    return de_emphasis(griffin_lim(amp.contiguous(), cfg, n_iters=n_iters), cfg.preemphasis)
