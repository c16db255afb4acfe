"""Kernel 1: fused spectrogram frontend (port of
``zerospeech_tts_tpu/ops/pallas_frontend.py``; CUDA source
``csrc/frontend.cu``).

From the mirror-padded, preemphasised signal, per frame: windowed real DFT
-> mag = sqrt(re^2 + im^2 + 1e-12) -> mel = mag . mel_basis^T -> dB-norm of
both. :func:`fused_frontend` launches the kernel on a CUDA tensor and runs
:func:`frontend_plain` on a CPU tensor; any other device raises. The plain
version contracts the window-folded DFT bases; the kernel computes the
same frames by FFT (the rfft of ypad[t*hop : t*hop + n_fft] times the
window placed at lpad) and each mel band over its nonzero bins only
(:func:`mel_bands`), so it takes a power-of-two n_fft (16 to 1024) only.
Where a magnitude lies near the dB floor (from 1e-4 to the larger of 1e-2
and 3e-4 of the frame's largest), the norm turns f32 rounding into
differences above 1e-4, so the kernel sums those bins again as dot
products over the window with the plain version's bases.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
from zerospeech_tts_tpu_torch.ops import build
from zerospeech_tts_tpu_torch.ops.griffin_lim import _fft_tables, fft_lg

launches = 0  # kernel launches through fused_frontend (plain calls not counted)


@functools.lru_cache(maxsize=16)
def _constants(cfg: AudioConfig, device: str):
    """The plain version's (ca [win, F], sa [win, F], melT [F, n_mels]) f32
    on ``device``."""
    ca, sa, _, _ = dsp_audio._fused_bases(cfg)
    mel_t = dsp_audio._mel_basis(cfg).T.copy()
    return tuple(torch.from_numpy(a).to(device) for a in (ca, sa, mel_t))


def _check_span(ypad: torch.Tensor, cfg: AudioConfig, n_frames: int) -> None:
    lpad = (cfg.n_fft - cfg.win_length) // 2
    need = lpad + (n_frames - 1) * cfg.hop_length + cfg.win_length
    if ypad.dim() != 2 or ypad.shape[1] < need:
        raise ValueError(f"ypad {tuple(ypad.shape)}: need [B, >= {need}] for {n_frames} frames")


@functools.lru_cache(maxsize=16)
def _bases_t(cfg: AudioConfig, device: str):
    """The kernel's copies of ca and sa, transposed to [F, win] (a bin's
    basis contiguous, for the bins it sums directly), f32 on ``device``."""
    ca, sa, _ = _constants(cfg, device)
    return ca.T.contiguous(), sa.T.contiguous()


@functools.lru_cache(maxsize=16)
def mel_bands(cfg: AudioConfig) -> tuple[np.ndarray, np.ndarray]:
    """Each mel band's nonzero run of ``_mel_basis``: bands [3, n_mels]
    int32 (first nonzero bin, one past the last, offset of the band's
    weights in ``weights``; lo = hi = 0 for a band with none) and weights
    [nnz] f32, the concatenated runs basis[m, lo:hi]. Summing each band
    over [lo, hi) skips only exact zeros of the basis."""
    basis = dsp_audio._mel_basis(cfg)
    bands = np.zeros((3, basis.shape[0]), np.int32)
    runs, off = [], 0
    for m, row in enumerate(basis):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands[:, m] = lo, hi, off
        runs.append(row[lo:hi])
        off += hi - lo
    return bands, np.concatenate(runs).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_tables(cfg: AudioConfig, device: str):
    """(bands, weights) of :func:`mel_bands` on ``device``."""
    return tuple(torch.from_numpy(a).to(device) for a in mel_bands(cfg))


def frontend_plain(ypad: torch.Tensor, cfg: AudioConfig, n_frames: int):
    """Plain PyTorch version: ypad [B, P] -> (mel [B, T, n_mels], mag
    [B, T, n_freq]), dB-normalised."""
    _check_span(ypad, cfg, n_frames)
    ca, sa, mel_t = _constants(cfg, str(ypad.device))
    segs = dsp_audio._fused_segments(ypad, cfg, n_frames)
    re, im = segs @ ca, segs @ sa
    mag = torch.sqrt(re * re + im * im + 1e-12)
    mel = mag @ mel_t
    return dsp_audio.amp_to_db_norm(mel, cfg), dsp_audio.amp_to_db_norm(mag, cfg)


def fused_frontend(ypad: torch.Tensor, cfg: AudioConfig, n_frames: int):
    """Same contract as :func:`frontend_plain`; the CUDA kernel on a CUDA
    tensor (two frames a packed complex FFT in a unit of lanes' registers,
    so n_fft must be a power of two from 16 to 1024; bins whose magnitude
    lies near the dB floor are summed again as sequential dot products with
    the plain version's bases)."""
    if ypad.device.type == "cpu":
        return frontend_plain(ypad, cfg, n_frames)
    _check_span(ypad, cfg, n_frames)
    lg = fft_lg(cfg, "frontend kernel")
    b, p = ypad.shape
    build.require(ypad, "frontend ypad", (b, p))
    win_w, tw, w32 = _fft_tables(cfg, str(ypad.device))
    ca_t, sa_t = _bases_t(cfg, str(ypad.device))
    bands, melw = _band_tables(cfg, str(ypad.device))
    mel = torch.empty(b, n_frames, cfg.n_mels, device=ypad.device)
    mag = torch.empty(b, n_frames, cfg.n_freq, device=ypad.device)
    lib = build.load("frontend")
    fn = build.bind(lib, "zs_frontend", 10, 8, 2)
    err = fn(
        ypad.data_ptr(), win_w.data_ptr(), tw.data_ptr(), w32.data_ptr(), ca_t.data_ptr(), sa_t.data_ptr(),
        melw.data_ptr(), bands.data_ptr(), mel.data_ptr(), mag.data_ptr(),
        b, p, n_frames, lg, cfg.n_mels, melw.numel(), cfg.win_length, cfg.hop_length,
        cfg.ref_db, cfg.max_db, build.stream_of(ypad),
    )
    build.check(lib, err, "frontend kernel")
    global launches
    launches += 1
    return mel, mag
