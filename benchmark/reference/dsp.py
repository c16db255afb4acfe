"""The audio path in plain PyTorch and NumPy: silence trim, the PCM16
wire, the spectrogram frontend, Griffin-Lim with momentum, de-emphasis,
and the spectral consistency that judges a synthesised signal.

A frozen copy of the port's ``dsp/wavio.py`` trim, ``dsp/audio.py`` and
the plain versions of its frontend and Griffin-Lim kernels
(``ops/frontend.py frontend_plain``, ``ops/griffin_lim.py
griffin_lim_plain``), for one utterance at its own length. Bases are
worked out in float64 and used in float32. ``ac`` is the configuration's
``audio`` dict.
"""

from __future__ import annotations

import numpy as np
import scipy.signal
import torch


def n_freq(ac: dict) -> int:
    return ac["n_fft"] // 2 + 1


def trim_silence(y: np.ndarray, top_db: float, frame_length: int = 2048, hop: int = 512) -> np.ndarray:
    """Leading and trailing frames more than top_db below the peak frame
    RMS cut (centre-padded frames, librosa.effects.trim's rule)."""
    if len(y) == 0:
        return y
    pad = frame_length // 2
    ypad = np.pad(y, (pad, pad), mode="constant")
    n = 1 + len(y) // hop
    frames = ypad[np.arange(n)[:, None] * hop + np.arange(frame_length)[None, :]]
    rms = np.sqrt(np.mean(frames**2, axis=1))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(np.max(rms), 1e-10))
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return y[:0]
    return y[int(keep[0]) * hop : min(len(y), int(keep[-1] + 1) * hop)]


def pcm16(y: np.ndarray) -> np.ndarray:
    """Float samples -> int16 PCM (x 32768, rounded, clipped): the wire
    from the host to the device."""
    return np.clip(np.rint(y * 32768.0), -32768, 32767).astype(np.int16)


def _window_support(ac: dict) -> np.ndarray:
    """Periodic Hann of win_length, float64."""
    n = np.arange(ac["win_length"])
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / ac["win_length"])


def _lpad(ac: dict) -> int:
    return (ac["n_fft"] - ac["win_length"]) // 2


def bases(ac: dict, device) -> dict[str, torch.Tensor]:
    """Window-folded real-DFT bases over the window support, float32:
    analysis ca, sa [win, F] (frame sample j sits at n = lpad + j of the
    n_fft frame); synthesis cs, ss [F, win] (inverse real DFT, interior
    bins twice, scaled by 1 / n_fft, times the window); and 1 / the
    window-square overlap-add envelope is made by :func:`wss_inv`."""
    nfft, win = ac["n_fft"], ac["win_length"]
    w = _window_support(ac)
    n = (_lpad(ac) + np.arange(win))[:, None]
    k = np.arange(n_freq(ac))[None, :]
    ang = 2.0 * np.pi * n * k / nfft
    scale = np.full(n_freq(ac), 2.0)
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    scale = scale / nfft
    arrs = dict(
        ca=w[:, None] * np.cos(ang),
        sa=w[:, None] * -np.sin(ang),
        cs=(np.cos(ang) * scale[None, :] * w[:, None]).T,
        ss=(-np.sin(ang) * scale[None, :] * w[:, None]).T,
    )
    return {name: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for name, a in arrs.items()}


def wss_inv(ac: dict, t: int, device) -> torch.Tensor:
    """1 / the window-square overlap-add envelope over (t - 1 + win/hop) x
    hop samples (1 where it vanishes)."""
    hop, win = ac["hop_length"], ac["win_length"]
    w2 = _window_support(ac) ** 2
    wss = np.zeros((t - 1 + win // hop) * hop)
    np.add.at(wss, np.arange(t)[:, None] * hop + np.arange(win)[None, :], w2[None, :])
    wss = np.where(wss > 1e-11, wss, 1.0)
    return torch.from_numpy((1.0 / wss).astype(np.float32)).to(device)


def preemphasis(y: torch.Tensor, coef: float) -> torch.Tensor:
    return torch.cat([y[..., :1], y[..., 1:] - coef * y[..., :-1]], dim=-1)


def magnitudes(y: torch.Tensor, ac: dict, bs: dict) -> torch.Tensor:
    """Centred STFT magnitudes of signals [B, n] -> [B, 1 + n // hop, F]:
    reflect padding of n_fft / 2 at each end, frame t the win_length
    samples from lpad + t x hop of the padded signal."""
    nfft, hop, win = ac["n_fft"], ac["hop_length"], ac["win_length"]
    t = 1 + y.shape[-1] // hop
    ypad = torch.nn.functional.pad(y[:, None], (nfft // 2, nfft // 2), mode="reflect")[:, 0]
    segs = ypad[:, _lpad(ac):].unfold(-1, win, hop)[:, :t]
    re, im = segs @ bs["ca"], segs @ bs["sa"]
    return torch.sqrt(re * re + im * im + 1e-12)


def amp_to_db_norm(amp: torch.Tensor, ac: dict) -> torch.Tensor:
    db = 20.0 * torch.log10(torch.clamp(amp, min=1e-5))
    return torch.clamp((db - ac["ref_db"] + ac["max_db"]) / ac["max_db"], 1e-8, 1.0)


def db_norm_to_amp(x: torch.Tensor, ac: dict) -> torch.Tensor:
    db = torch.clamp(x, 0.0, 1.0) * ac["max_db"] - ac["max_db"] + ac["ref_db"]
    return torch.pow(10.0, db * 0.05)


def features(pcm: np.ndarray, ac: dict, bs: dict, device) -> torch.Tensor:
    """int16 PCM [n] -> dB-normalised linear magnitudes [1 + n // hop, F]:
    x / 32768, preemphasis, centred STFT."""
    y = torch.from_numpy(pcm.astype(np.float32) * (1.0 / 32768.0)).to(device)[None]
    return amp_to_db_norm(magnitudes(preemphasis(y, ac["preemphasis"]), ac, bs), ac)[0]


def griffin_lim(amp: torch.Tensor, ac: dict, bs: dict, n_iters: int) -> torch.Tensor:
    """Fast Griffin-Lim over linear magnitudes [B, T, F] -> [B, (T - 1) x
    hop]: v_1 = u_0 = istft(amp); n_iters times (re, im) = stft(v),
    u = istft(amp x phase), v = u + momentum (u - u_prev); then
    istft(amp x phase(stft(v))), the analysis framing the untrimmed
    overlap-add signal, trimmed to the centred span."""
    b, t, _ = amp.shape
    hop, win = ac["hop_length"], ac["win_length"]
    r = win // hop
    inv = wss_inv(ac, t, amp.device)

    def istft(sre, sim):
        frames = sre @ bs["cs"] if sim is None else sre @ bs["cs"] + sim @ bs["ss"]
        frames = frames.reshape(b, t, r, hop)
        acc = amp.new_zeros(b, t - 1 + r, hop)
        for k in range(r):
            acc[:, k : k + t] += frames[:, :, k]
        return acc.reshape(b, -1) * inv

    def project(x):
        segs = x.unfold(-1, win, hop)
        re, im = segs @ bs["ca"], segs @ bs["sa"]
        norm = torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        return amp * re / norm, amp * im / norm

    alpha = ac["gl_momentum"]
    v = u = istft(amp, None)
    for _ in range(n_iters):
        ui = istft(*project(v))
        v = ui + alpha * (ui - u)
        u = ui
    lead = ac["n_fft"] // 2 - _lpad(ac)
    return istft(*project(v))[:, lead : lead + (t - 1) * hop]


def de_emphasis(x: np.ndarray, coef: float) -> np.ndarray:
    """y[n] = x[n] + coef y[n - 1], in float64, along the last axis."""
    return scipy.signal.lfilter([1.0], [1.0, -coef], np.asarray(x, np.float64), axis=-1)


def pcm_out(wav: np.ndarray) -> np.ndarray:
    """A synthesised signal -> int16 PCM (x 32767, clipped, truncated)."""
    return np.clip(wav * 32767.0, -32768.0, 32767.0).astype(np.int16)


def consistency(pcm: np.ndarray, amp: torch.Tensor, ac: dict, bs: dict, edge: int = 4) -> float:
    """How far a synthesised int16 PCM [(T - 1) x hop] is from being a
    signal with the magnitudes ``amp`` [T, F] that Griffin-Lim was asked
    for: rel-L2 of the centred STFT magnitudes of its preemphasised
    samples against ``amp``, ``edge`` frames in from each end. 1.0 for a
    signal of the wrong length."""
    t = amp.shape[0]
    if pcm.shape != ((t - 1) * ac["hop_length"],):
        return 1.0
    y = torch.from_numpy(pcm.astype(np.float32) * (1.0 / 32768.0)).to(amp.device)[None]
    m = magnitudes(preemphasis(y, ac["preemphasis"]), ac, bs)[0]
    a = amp[edge : t - edge]
    return (torch.linalg.norm(m[edge : t - edge] - a) / torch.linalg.norm(a)).item()
