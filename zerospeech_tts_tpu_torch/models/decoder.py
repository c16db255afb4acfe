"""Decoder (port of ``zerospeech_tts_tpu/models/decoder.py``; ref
model.py:~180-280).

Latent [B, T/downsample, emb_size] + speaker id [B] -> spectrogram
[B, T, n_feat]. The speaker embedding is broadcast-concatenated at every
block; pixel_shuffle_1d x2 per stage undoes the encoder's x8 downsample.
``lengths`` ([B] true LATENT row counts) re-fills pad rows with reflected
true rows before each conv so bucket padding cannot bleed into true frames
(the GRU is forward-only, so it needs no mask).
"""

from __future__ import annotations

import torch
from torch import nn

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import (
    GRU,
    ConvNorm,
    Embed,
    append_emb,
    mirror_fill_time,
    pixel_shuffle_1d,
)


class Decoder(nn.Module):
    def __init__(self, hps: Hps):
        super().__init__()
        h = self.hps = hps
        self.n_up = h.downsample.bit_length() - 1
        c, e = h.conv_channels, h.spk_emb_size
        self.spk_embed = Embed(h.n_speakers, e)
        self.proj = ConvNorm(h.emb_size + e, c, 3, ns=h.ns)
        for i in range(self.n_up):
            self.add_module(f"up_{i}", ConvNorm(c + e, 2 * c, 3, ns=h.ns))
            self.add_module(f"res_{i}", ConvNorm(c, c, 3, ns=h.ns))
        self.rnn = GRU(c + e, c)
        self.out = nn.Linear(c, h.n_feat)

    def forward(self, z: torch.Tensor, spk: torch.Tensor, lengths=None) -> torch.Tensor:
        emb = self.spk_embed(spk)
        L = lengths

        def fill(v, n):
            return v if n is None else mirror_fill_time(v, n)

        y = self.proj(append_emb(fill(z, L), emb))
        for i in range(self.n_up):
            y = getattr(self, f"up_{i}")(append_emb(fill(y, L), emb))
            y = pixel_shuffle_1d(y, 2)  # [B, 2T, conv_channels]
            if L is not None:
                L = 2 * L
            y = fill(y, L)
            y = y + getattr(self, f"res_{i}")(y)
        y = self.rnn(append_emb(y, emb))
        return self.out(y)
