"""PatchDiscriminator, the stage-2 GAN critic (port of
``zerospeech_tts_tpu/models/patch_discriminator.py``; ref model.py:~340-430).

2-D convs over the spectrogram as a one-channel image: four 5x5 stride-2
convs (32, 64, 128, 256 channels) with leaky-relu and ``dis_dp`` dropout,
then (a) a 3x3 per-patch WGAN validity head and (b) a speaker head on the
spatial mean. No normalization layers (WGAN-GP).

flax ``padding="SAME"`` pads a stride-s, size-k conv over n positions by
``max((ceil(n/s) - 1) s + k - n, 0)`` in all, the smaller half first: for
k = 5, s = 2 that is (1, 2) at even n (T = 128, 64, 32, 16) and (2, 2) at
odd n (F = 513, 257, 129, 65). ``nn.Conv2d(padding=2)`` would give the same
output shape at a shifted alignment, so the port pads explicitly and runs
VALID convs. Tensors are [B, C, T, F] inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import dropout

CHANNELS = (32, 64, 128, 256)


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, y: torch.Tensor) -> torch.Tensor:
    """``conv`` (padding 0) over [B, C, T, F] with flax SAME padding."""
    (kt, kf), (st, sf) = conv.kernel_size, conv.stride
    t_lo, t_hi = same_pad(y.shape[2], kt, st)
    f_lo, f_hi = same_pad(y.shape[3], kf, sf)
    return conv(F.pad(y, (f_lo, f_hi, t_lo, t_hi)))


class PatchDiscriminator(nn.Module):
    def __init__(self, hps: Hps):
        super().__init__()
        self.hps = hps
        cin = 1
        for i, ch in enumerate(CHANNELS):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 5, stride=2))
            cin = ch
        self.patch_head = nn.Conv2d(cin, 1, 3)
        self.cls_head = nn.Linear(cin, hps.n_speakers)

    def forward(self, x: torch.Tensor, train: bool = False, noise=None):
        """x [B, T, n_feat] -> (patch validity [B, t', f'], speaker logits
        [B, n_speakers])."""
        h = self.hps
        y = x[:, None]
        for i in range(len(CHANNELS)):
            y = F.leaky_relu(conv_same(getattr(self, f"conv_{i}"), y), h.ns)
            y = dropout(y, h.dis_dp, noise if train else None)
        patch = conv_same(self.patch_head, y)[:, 0]
        return patch, self.cls_head(y.mean(dim=(2, 3)))
