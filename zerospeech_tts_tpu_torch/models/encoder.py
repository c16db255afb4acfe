"""Encoder (port of ``zerospeech_tts_tpu/models/encoder.py``; ref
model.py:~100-180).

Spectrogram [B, T, n_feat] -> per-frame latent logits
[B, T/downsample, emb_size, 2]: conv bank (1..8) -> stride-2 residual
conv stages (x8 temporal downsample) -> dense -> BiGRU -> 2-logit head.

``lengths`` ([B] true frame counts) makes encoding padding-invariant for
length-bucketed batches: pad rows are re-filled with the reflection of the
true rows before every conv stage and the backward GRU starts at each
row's true tail. With the bucket rule pad == 0 or pad >= 4 input frames
(Converter._MIN_PAD) the true rows equal an exact-length run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import BiGRU, ConvBank, ConvNorm, mirror_fill_time


class Encoder(nn.Module):
    def __init__(self, hps: Hps):
        super().__init__()
        h = self.hps = hps
        self.n_down = h.downsample.bit_length() - 1  # 8 -> 3 stride-2 stages
        assert 2**self.n_down == h.downsample
        self.bank = ConvBank(h.n_feat, h.bank_size, h.bank_channels, h.ns)
        self.proj = ConvNorm(h.bank_size * h.bank_channels + h.n_feat, h.conv_channels, 3, ns=h.ns)
        for i in range(self.n_down):
            self.add_module(f"down_{i}", ConvNorm(h.conv_channels, h.conv_channels, 3, stride=2, ns=h.ns))
            self.add_module(f"res_{i}", ConvNorm(h.conv_channels, h.conv_channels, 3, ns=h.ns))
        self.dense = nn.Linear(h.conv_channels, h.emb_size)
        self.rnn = BiGRU(h.emb_size, h.emb_size // 2)
        self.head = nn.Linear(h.emb_size, 2 * h.emb_size)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        h = self.hps
        L = lengths

        def fill(v, n):
            return v if n is None else mirror_fill_time(v, n)

        y = self.bank(fill(x, L))
        y = self.proj(fill(y, L))
        for i in range(self.n_down):
            y = fill(y, L)
            z = getattr(self, f"down_{i}")(y)
            if L is not None:
                L = (L + 1) // 2  # ceil: stride-2 VALID conv over reflect pad
            z = getattr(self, f"res_{i}")(fill(z, L))
            y = z + y[:, ::2, :]  # strided residual
        y = F.leaky_relu(self.dense(y), h.ns)
        y = self.rnn(y, lengths=L)
        logits = self.head(y)
        b, t, _ = logits.shape
        return logits.reshape(b, t, h.emb_size, 2)
