"""NN building blocks (port of ``zerospeech_tts_tpu/models/layers.py``; ref
model.py:~10-90: conv_bank, pad_layer, pixel_shuffle_1d, GRU wrappers,
append_emb).

Public functions and module ``forward``s take the JAX package's [B, T, C]
layout; convolutions transpose to [B, C, T] inside. Module and parameter
names follow the flax tree (``bank/bank_1/Conv_0/kernel`` is
``bank.bank_1.Conv_0.weight`` here) so ``params.from_flax`` is a rename
plus the layout transposes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from zerospeech_tts_tpu_torch.ops.gru import gru_scan


def reflect_pad_time(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Reflect-pad the time axis of [B, T, C] for an odd/even kernel (ref
    pad_layer): the extra element of an even kernel goes on the right."""
    lpad = (kernel_size - 1) // 2
    rpad = kernel_size - 1 - lpad
    if lpad == rpad == 0:
        return x
    return F.pad(x.transpose(1, 2), (lpad, rpad), mode="reflect").transpose(1, 2)


def mirror_fill_time(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Replace rows at/after each row's true ``length`` with the
    edge-excluded reflection of its true rows (np.pad 'reflect' indices,
    exact at any fold depth): [B, T, C] + lengths [B] -> [B, T, C]. Convs
    over the result see at every true row exactly the context an
    exact-length run would."""
    t = x.shape[1]
    L = lengths.to(torch.long).clamp(min=2)[:, None]
    period = 2 * (L - 1)
    m = torch.arange(t, device=x.device)[None, :] % period
    j = torch.minimum(m, period - m)
    return torch.gather(x, 1, j[:, :, None].expand(-1, -1, x.shape[2]))


def pixel_shuffle_1d(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, T, C*r] -> [B, T*r, C] sub-pixel temporal upsample."""
    b, t, cr = x.shape
    assert cr % r == 0, (cr, r)
    return x.reshape(b, t, r, cr // r).reshape(b, t * r, cr // r)


def append_emb(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Broadcast-concat a per-utterance embedding [B, E] onto every frame."""
    b, t, _ = x.shape
    return torch.cat([x, emb[:, None, :].expand(b, t, emb.shape[-1])], dim=-1)


class ConvNorm(nn.Module):
    """Reflect-padded 1-D conv + leaky-relu on [B, T, C]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, ns: float = 0.01, use_act: bool = True):
        super().__init__()
        self.kernel_size, self.ns, self.use_act = kernel_size, ns, use_act
        self.Conv_0 = nn.Conv1d(in_channels, features, kernel_size, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(reflect_pad_time(x, self.kernel_size).transpose(1, 2)).transpose(1, 2)
        return F.leaky_relu(y, self.ns) if self.use_act else y


class ConvBank(nn.Module):
    """Conv bank with kernel sizes 1..bank_size, outputs concatenated with
    the input (ref conv_bank)."""

    def __init__(self, in_channels: int, bank_size: int = 8, channels: int = 128, ns: float = 0.01):
        super().__init__()
        self.bank_size = bank_size
        for k in range(1, bank_size + 1):
            self.add_module(f"bank_{k}", ConvNorm(in_channels, channels, k, ns=ns))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [getattr(self, f"bank_{k}")(x) for k in range(1, self.bank_size + 1)]
        return torch.cat(outs + [x], dim=-1)


class GRU(nn.Module):
    """GRU over time with the input projections for ALL steps hoisted into
    one matmul (``wi``) and the recurrence in the GRU kernel
    (ops/gru.py). Parameters follow the flax layout: ``wh`` [H, 3H], ``bh``
    [3H], gate order r, z, n."""

    def __init__(self, in_features: int, hidden: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.wi = nn.Linear(in_features, 3 * hidden)
        self.wh = nn.Parameter(torch.zeros(hidden, 3 * hidden))
        self.bh = nn.Parameter(torch.zeros(3 * hidden))

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        xw = self.wi(x).contiguous()
        if lengths is not None:
            lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        return gru_scan(xw, self.wh, self.bh, lengths, reverse=self.reverse)


class BiGRU(nn.Module):
    """Forward + reversed GRU, concatenated. ``lengths`` masks the BACKWARD
    scan only (padding follows the true rows)."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.fwd = GRU(in_features, hidden)
        self.bwd = GRU(in_features, hidden, reverse=True)

    def forward(self, x: torch.Tensor, lengths=None) -> torch.Tensor:
        return torch.cat([self.fwd(x), self.bwd(x, lengths=lengths)], dim=-1)


class Embed(nn.Module):
    """Lookup table with the flax parameter name ``embedding``."""

    def __init__(self, num: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]
