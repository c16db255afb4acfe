"""8-bit mu-law companding for the host<->device PCM wire (the port of
``zerospeech_tts_tpu/dsp/mulaw.py``).

``Converter(pcm_wire="mulaw")`` (``--wire-mulaw``) sends each wav to the
device as one byte a sample and reads each synthesised wav back the same
way, half the int16 wire's bytes in both directions; files on disk and
HTTP clients stay PCM16. The int16 wire (the default) stays bit-exact for
PCM16 sources.

Code layout: u = 128 + round(f * 127) with f = sign(y) * ln(1 + mu|y|) /
ln(1 + mu), mu = 255, so u = 128 is exactly zero (digital silence survives
the wire) and u spans [1, 255].

The host half is the JAX package's numpy code, copied: two lookup tables
in float64 (65,536 int16 samples -> code, 256 codes -> int16), one gather a
batch. The device half is elementwise torch in f32 (``sign``, ``log1p``,
``exp2``, ``round``: half to even, as ``jnp.round``), on whatever device
its tensor lies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MU = 255.0
_LN1P_MU = float(np.log1p(MU))


def mulaw_compress_device(y: torch.Tensor) -> torch.Tensor:
    """float wav in [-1, 1] -> uint8 mu-law code (f32 math, on y's device)."""
    y = y.to(torch.float32)
    f = torch.sign(y) * torch.log1p(MU * torch.abs(y)) * (1.0 / _LN1P_MU)
    return torch.clamp(torch.round(f * 127.0) + 128.0, 1.0, 255.0).to(torch.uint8)


def mulaw_expand_device(u: torch.Tensor) -> torch.Tensor:
    """uint8 mu-law code -> float wav in [-1, 1] (f32 math, on u's device)."""
    # the clamp keeps the out-of-protocol code 0 (compression emits [1, 255]) in range
    f = torch.clamp((u.to(torch.float32) - 128.0) * (1.0 / 127.0), -1.0, 1.0)
    mag = (torch.exp2(torch.abs(f) * (_LN1P_MU / np.log(2.0))) - 1.0) * (1.0 / MU)
    return torch.sign(f) * mag


@functools.lru_cache(maxsize=1)
def _encode_lut() -> np.ndarray:
    """int16 sample (offset by 32768) -> uint8 mu-law code, float64 math."""
    y = (np.arange(65536, dtype=np.float64) - 32768.0) / 32768.0
    f = np.sign(y) * np.log1p(MU * np.abs(y)) / _LN1P_MU
    return np.clip(np.round(f * 127.0) + 128.0, 1.0, 255.0).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _decode_lut() -> np.ndarray:
    """uint8 mu-law code -> int16 sample (load_wav's 32768 scale)."""
    f = (np.arange(256, dtype=np.float64) - 128.0) / 127.0
    y = np.sign(f) * (np.power(1.0 + MU, np.abs(f)) - 1.0) / MU
    return np.clip(np.round(y * 32768.0), -32768, 32767).astype(np.int16)


def mulaw_compress_host(pcm16: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law codes (one LUT gather)."""
    return _encode_lut()[pcm16.astype(np.int32) + 32768]


def mulaw_expand_host(codes: np.ndarray) -> np.ndarray:
    """uint8 mu-law codes -> int16 PCM (one LUT gather)."""
    return _decode_lut()[codes]
