"""MBV discretizer (port of ``zerospeech_tts_tpu/models/mbv.py``; ref
model.py gumbel_softmax / sample_gumbel + the encoder-mode switch).

Multilabel-Binary Vectors: each latent dimension is an independent binary
{on, off} choice, sampled with straight-through Gumbel-softmax during
training and hard-thresholded at inference. These bits ARE the ZeroSpeech
challenge's discrete units. Modes (ref ``enc_mode``): ``binary`` (MBV),
``one_hot`` (single choice over the latent vocabulary), ``continues``
(reference spelling; no discretization).

Training noise comes from a noise source (models/layers.py ``Noise`` or
``FedNoise``) as uniforms, clamped below at 1e-20 as JAX's
``uniform(minval=1e-20)`` draws them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_gumbel(noise, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) samples -log(-log(u)), u uniform in [1e-20, 1)."""
    u = noise.uniform(shape, device).clamp_min(1e-20)
    return -torch.log(-torch.log(u))


def gumbel_softmax(logits: torch.Tensor, temperature: float, noise) -> torch.Tensor:
    """Soft Gumbel-softmax sample along the last axis."""
    g = sample_gumbel(noise, logits.shape, logits.device)
    return torch.softmax((logits + g) / temperature, dim=-1)


def straight_through(soft: torch.Tensor) -> torch.Tensor:
    """Hard one-hot (last axis) forward, soft gradients backward, written
    as JAX writes it (``soft + sg(hard - soft)``) so the forward value
    rounds the same."""
    hard = F.one_hot(soft.argmax(dim=-1), soft.shape[-1]).to(soft.dtype)
    return soft + (hard - soft).detach()


def discretize(logits: torch.Tensor, mode: str, temperature: float, noise=None) -> torch.Tensor:
    """Encoder logits [..., D, 2] -> latent [..., D].

    binary:    per-dim 2-way straight-through Gumbel-softmax over {on,
               off}; the "on" coordinate.
    one_hot:   Gumbel-softmax over the D axis of the "on" logits.
    continues: the raw "on" logits.

    ``noise=None`` is deterministic inference: binary = (on > off), one_hot
    = one-hot argmax of the "on" logits."""
    on = logits[..., 0]
    if mode == "continues":
        return on
    if noise is None:
        if mode == "binary":
            return (logits[..., 0] > logits[..., 1]).to(logits.dtype)
        if mode == "one_hot":
            return F.one_hot(on.argmax(dim=-1), on.shape[-1]).to(logits.dtype)
        raise ValueError(f"unknown enc_mode {mode!r}")
    if mode == "binary":
        return straight_through(gumbel_softmax(logits, temperature, noise))[..., 0]
    if mode == "one_hot":
        return straight_through(gumbel_softmax(on, temperature, noise))
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
