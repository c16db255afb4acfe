"""MBV discretizer, inference half (port of
``zerospeech_tts_tpu/models/mbv.py``; ref model.py gumbel_softmax + the
encoder-mode switch).

Multilabel-Binary Vectors: each latent dimension is an independent binary
{on, off} choice, hard-thresholded at inference. These bits ARE the
ZeroSpeech challenge's discrete units. Modes (ref ``enc_mode``): ``binary``
(MBV), ``one_hot`` (single choice over the latent vocabulary),
``continues`` (reference spelling; no discretization). The Gumbel-softmax
sampling used in training is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def discretize(logits: torch.Tensor, mode: str, temperature: float, rng=None) -> torch.Tensor:
    """Encoder logits [..., D, 2] -> latent [..., D], deterministic
    (``rng=None``): binary = (on > off); one_hot = one-hot argmax of the
    "on" logits; continues = the raw "on" logits."""
    on = logits[..., 0]
    if mode == "continues":
        return on
    if rng is not None:
        raise NotImplementedError("Gumbel-softmax sampling (training) is not ported yet")
    if mode == "binary":
        return (logits[..., 0] > logits[..., 1]).to(logits.dtype)
    if mode == "one_hot":
        return F.one_hot(on.argmax(dim=-1), on.shape[-1]).to(logits.dtype)
    raise ValueError(f"unknown enc_mode {mode!r}")


def hard_units(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic binary units as int32 (challenge unit-file payload)."""
    return (logits[..., 0] > logits[..., 1]).to(torch.int32)


def unit_bits(logits: torch.Tensor, mode: str = "binary") -> torch.Tensor:
    """Mode-aware 0/1 unit rows for the challenge dump: binary and
    continues threshold the head; one_hot is the argmax one-hot row."""
    if mode == "one_hot":
        on = logits[..., 0]
        return F.one_hot(on.argmax(dim=-1), on.shape[-1]).to(torch.int32)
    return hard_units(logits)
