"""Kernel 4: the whole fast Griffin-Lim vocoder (port of
``zerospeech_tts_tpu/ops/pallas_gl.py::griffin_lim_pallas``; CUDA source
``csrc/griffin_lim.cu``).

Signal-domain momentum carry, the Pallas kernel's semantics (not the XLA
path's reflect re-pad): with istft linear, fast-GL momentum on spectra is
the same extrapolation on their signals,

    v_1 = u_0 = istft(mag, 0)
    repeat: (re,im) = stft(v_i);  n_i = mag * (re,im)/max(|.|, 1e-8)
            u_i = istft(n_i);     v_{i+1} = u_i + a (u_i - u_{i-1})
    out    = istft(mag * phase(stft(v_{N+1})))

where stft analyses the UNTRIMMED overlap-add signal (frame t = samples
[t*hop, t*hop + win)) and istft divides by the full window-square envelope
``_fused_wss(cfg, t)``. The output is trimmed to the librosa span
``[lead, lead + (t-1)*hop)``. Any t >= 1 works (the TPU kernel needed
t >= 2r and three length tiers). :func:`griffin_lim` launches the kernel on
a CUDA tensor and runs :func:`griffin_lim_plain` on a CPU tensor. The
plain version contracts the window-folded DFT bases; the kernel computes
the same frames with FFTs (rfft of the windowed frame placed at lpad of an
n_fft buffer; irfft sliced to [lpad, lpad + win) and windowed), so it
takes a power-of-two n_fft (16 to 1024) only.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
from zerospeech_tts_tpu_torch.ops import build

launches = 0  # kernel launches through griffin_lim (one per whole vocoder call)


@functools.lru_cache(maxsize=16)
def _bases(cfg: AudioConfig, device: str):
    """(ca, sa [win, F], cs, ss [F, win]) f32 on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in dsp_audio._fused_bases(cfg))


@functools.lru_cache(maxsize=16)
def _fft_tables(cfg: AudioConfig, device: str):
    """The kernel's tables, f32 on ``device``, computed in float64: the
    window's support [win]; the four-step FFT's twiddles W^(k1 l) =
    exp(-2 pi i k1 l / n_fft) [P, L + 1, 2] (n_fft = P x L, L = 2^(lg // 2),
    column L padding); and exp(-2 pi i k / 32) [16, 2] for the register
    FFTs of at most 32 points."""
    n = cfg.n_fft
    lpad = (n - cfg.win_length) // 2
    win = dsp_audio._window(cfg)[lpad : lpad + cfg.win_length]
    lanes = 1 << ((n.bit_length() - 1) // 2)
    ang = -2.0 * np.pi * np.outer(np.arange(n // lanes), np.arange(lanes + 1)) / n
    w32 = -2.0 * np.pi * np.arange(16) / 32
    tw, w32 = (np.stack([np.cos(a), np.sin(a)], axis=-1).astype(np.float32) for a in (ang, w32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (win, tw, w32))


def fft_lg(cfg: AudioConfig, kernel: str) -> int:
    """log2 n_fft for a kernel built on csrc/fft.cuh (kernels 1 and 4),
    whose register FFTs take a power of two from 16 to 1024 points."""
    n = cfg.n_fft
    if n & (n - 1) or not 16 <= n <= 1024:
        raise ValueError(f"{kernel}: n_fft={n} is not a power of two from 16 to 1024")
    return n.bit_length() - 1


def _kernel_limits(cfg: AudioConfig) -> int:
    """log2 n_fft for the kernel (csrc/griffin_lim.cu), which runs
    power-of-two FFTs of 16 to 1024 points in registers and owns at least
    17 - win/hop output rows a block."""
    lg = fft_lg(cfg, "griffin-lim kernel")
    if cfg.win_length // cfg.hop_length > 16:
        raise ValueError(f"griffin-lim kernel: win/hop = {cfg.win_length // cfg.hop_length} > 16")
    return lg


@functools.lru_cache(maxsize=32)
def _wss_inv(cfg: AudioConfig, t: int, device: str) -> torch.Tensor:
    """1 / the full window-square envelope, [(t - 1 + r) * hop] f32."""
    inv = 1.0 / dsp_audio._fused_wss(cfg, t).astype(np.float64)
    return torch.from_numpy(inv.astype(np.float32)).to(device)


def _prepare(mag: torch.Tensor, cfg: AudioConfig, n_iters):
    if cfg.win_length % cfg.hop_length:
        raise ValueError("Griffin-Lim needs win_length % hop_length == 0")
    if mag.dim() != 3 or mag.shape[-1] != cfg.n_freq:
        raise ValueError(f"mag {tuple(mag.shape)}: expected [B, T, {cfg.n_freq}]")
    return cfg.gl_iters if n_iters is None else int(n_iters)


def _trim(out: torch.Tensor, cfg: AudioConfig, t: int) -> torch.Tensor:
    lead = dsp_audio.gl_lead(cfg)
    return out[:, lead : lead + (t - 1) * cfg.hop_length]


def griffin_lim_plain(mag: torch.Tensor, cfg: AudioConfig, n_iters: int | None = None):
    """Plain PyTorch version: linear magnitudes [B, T, F] -> [B, (T-1)*hop]."""
    n_iters = _prepare(mag, cfg, n_iters)
    b, t, _ = mag.shape
    hop, win = cfg.hop_length, cfg.win_length
    r = win // hop
    ca, sa, cs, ss = _bases(cfg, str(mag.device))
    wss_inv = _wss_inv(cfg, t, str(mag.device))

    def istft(sre, sim):  # [B, T, F] -> untrimmed normalised OLA [B, (T-1+r)*hop]
        frames = sre @ cs if sim is None else sre @ cs + sim @ ss
        frames = frames.reshape(b, t, r, hop)
        acc = mag.new_zeros(b, t - 1 + r, hop)
        for k in range(r):
            acc[:, k : k + t] += frames[:, :, k]
        return acc.reshape(b, -1) * wss_inv

    def project(x):
        segs = x.unfold(-1, win, hop)  # [B, T, win]: exactly T frames
        re, im = segs @ ca, segs @ sa
        norm = torch.clamp(torch.sqrt(re * re + im * im), min=1e-8)
        return mag * re / norm, mag * im / norm

    alpha = cfg.gl_momentum
    v = u = istft(mag, None)
    for _ in range(n_iters):
        ui = istft(*project(v))
        v = ui + alpha * (ui - u)
        u = ui
    return _trim(istft(*project(v)), cfg, t)


def griffin_lim(mag: torch.Tensor, cfg: AudioConfig, n_iters: int | None = None):
    """Same contract as :func:`griffin_lim_plain`; the CUDA kernel on a CUDA
    tensor (four-step FFTs in registers, so n_fft must be a power of two
    from 16 to 1024, and win/hop at most 16; n_iters + 2 launches from one
    C call)."""
    if mag.device.type == "cpu":
        return griffin_lim_plain(mag, cfg, n_iters)
    n_iters = _prepare(mag, cfg, n_iters)
    lg = _kernel_limits(cfg)
    b, t, f = mag.shape
    build.require(mag, "griffin-lim mag", (b, t, f))
    hop, win = cfg.hop_length, cfg.win_length
    n_sig = (t - 1 + win // hop) * hop
    win_w, tw, w32 = _fft_tables(cfg, str(mag.device))
    wss_inv = _wss_inv(cfg, t, str(mag.device))
    u, va, vb, out = (torch.empty(b, n_sig, device=mag.device) for _ in range(4))
    lib = build.load("griffin_lim")
    fn = build.bind(lib, "zs_griffin_lim", 9, 6, 1)
    err = fn(
        mag.data_ptr(), win_w.data_ptr(), tw.data_ptr(), w32.data_ptr(), wss_inv.data_ptr(), u.data_ptr(),
        va.data_ptr(), vb.data_ptr(), out.data_ptr(), b, t, lg, win, hop, n_iters,
        cfg.gl_momentum, build.stream_of(mag),
    )
    build.check(lib, err, "griffin-lim kernel")
    global launches
    launches += 1
    return _trim(out, cfg, t)
