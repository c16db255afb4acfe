"""Kernel 1: fused spectrogram frontend (port of
``zerospeech_tts_tpu/ops/pallas_frontend.py``; CUDA source
``csrc/frontend.cu``).

From the mirror-padded, preemphasised signal, per frame: windowed real DFT
-> mag = sqrt(re^2 + im^2 + 1e-12) -> mel = mag . mel_basis^T -> dB-norm of
both. :func:`fused_frontend` launches the kernel on a CUDA tensor and runs
:func:`frontend_plain` on a CPU tensor; any other device raises.
"""

from __future__ import annotations

import functools

import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
from zerospeech_tts_tpu_torch.ops import build

launches = 0  # kernel launches through fused_frontend (plain calls not counted)


@functools.lru_cache(maxsize=16)
def _constants(cfg: AudioConfig, device: str):
    """(ca [win, F], sa [win, F], melT [F, n_mels]) f32 on ``device``."""
    ca, sa, _, _ = dsp_audio._fused_bases(cfg)
    mel_t = dsp_audio._mel_basis(cfg).T.copy()
    return tuple(torch.from_numpy(a).to(device) for a in (ca, sa, mel_t))


def _check_span(ypad: torch.Tensor, cfg: AudioConfig, n_frames: int) -> None:
    lpad = (cfg.n_fft - cfg.win_length) // 2
    need = lpad + (n_frames - 1) * cfg.hop_length + cfg.win_length
    if ypad.dim() != 2 or ypad.shape[1] < need:
        raise ValueError(f"ypad {tuple(ypad.shape)}: need [B, >= {need}] for {n_frames} frames")


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
    tensor."""
    if ypad.device.type == "cpu":
        return frontend_plain(ypad, cfg, n_frames)
    _check_span(ypad, cfg, n_frames)
    b, p = ypad.shape
    build.require(ypad, "frontend ypad", (b, p))
    ca, sa, mel_t = _constants(cfg, str(ypad.device))
    mel = torch.empty(b, n_frames, cfg.n_mels, device=ypad.device)
    mag = torch.empty(b, n_frames, cfg.n_freq, device=ypad.device)
    lib = build.load("frontend")
    fn = build.bind(lib, "zs_frontend", 6, 8, 2)
    err = fn(
        ypad.data_ptr(), ca.data_ptr(), sa.data_ptr(), mel_t.data_ptr(),
        mel.data_ptr(), mag.data_ptr(),
        b, p, n_frames, cfg.n_freq, cfg.n_mels, cfg.win_length, cfg.hop_length,
        (cfg.n_fft - cfg.win_length) // 2,
        cfg.ref_db, cfg.max_db, build.stream_of(ypad),
    )
    build.check(lib, err, "frontend kernel")
    global launches
    launches += 1
    return mel, mag
