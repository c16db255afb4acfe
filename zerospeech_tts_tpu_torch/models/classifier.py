"""SpeakerClassifier, the stage-1 adversary (port of
``zerospeech_tts_tpu/models/classifier.py``; ref model.py:~280-340).

Latent sequence [B, T', emb] -> speaker logits [B, n_speakers]: three
reflect-padded conv stages, each followed by ``dis_dp`` dropout in training,
a temporal mean, dense + leaky-relu, dense.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import ConvNorm, dropout


class SpeakerClassifier(nn.Module):
    def __init__(self, hps: Hps):
        super().__init__()
        h = self.hps = hps
        chans = [h.emb_size, h.conv_channels, h.conv_channels, h.conv_channels // 2]
        for i in range(3):
            self.add_module(f"conv_{i}", ConvNorm(chans[i], chans[i + 1], 3, ns=h.ns))
        self.dense = nn.Linear(h.conv_channels // 2, h.conv_channels // 2)
        self.out = nn.Linear(h.conv_channels // 2, h.n_speakers)

    def forward(self, z: torch.Tensor, train: bool = False, noise=None) -> torch.Tensor:
        h = self.hps
        y = z
        for i in range(3):
            y = dropout(getattr(self, f"conv_{i}")(y), h.dis_dp, noise if train else None)
        y = F.leaky_relu(self.dense(y.mean(dim=1)), h.ns)
        return self.out(y)
