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

``penalty_input_grad`` is the WGAN-GP penalty's input gradient written out
as its own chain: a forward under ``no_grad`` keeps each layer's padded
input and pre-activation, then the gradient walks back through
leaky-relu's backward rule and one transposed conv a layer. Differentiating
the penalty through that chain reaches each weight through cuDNN's
backward-filter (``_TransposedConv.backward``). Autograd's double backward
of a conv computes the same weight gradient as a forward conv whose
"filter" is the layer's gradient map (64 x 257 for ``conv_0`` at the
flagship F = 513), and it sends the zeros of leaky-relu's second
derivative back through the forward convs. ``penalty_counts()`` counts the
routes and their backward-filter calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import dropout

CHANNELS = (32, 64, 128, 256)


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(conv: nn.Conv2d, y: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int, int]]:
    """[B, C, T, F] padded for ``conv`` (padding 0) as flax SAME pads it,
    and the pads (T's lo and hi, then F's)."""
    (kt, kf), (st, sf) = conv.kernel_size, conv.stride
    (t_lo, t_hi), (f_lo, f_hi) = same_pad(y.shape[2], kt, st), same_pad(y.shape[3], kf, sf)
    return F.pad(y, (f_lo, f_hi, t_lo, t_hi)), (t_lo, t_hi, f_lo, f_hi)


def conv_same(conv: nn.Conv2d, y: torch.Tensor) -> torch.Tensor:
    """``conv`` (padding 0) over [B, C, T, F] with flax SAME padding."""
    return conv(pad_same(conv, y)[0])


# explicit penalty routes run, and backward-filter calls from their backward
_penalty_runs = {"routes": 0, "weight_grads": 0}


def penalty_counts() -> dict[str, int]:
    """How many ``penalty_input_grad`` routes ran, and how many weight
    gradients their backward computed through backward-filter."""
    return dict(_penalty_runs)


def _conv_backward(gy, x, weight, stride, mask):
    """``aten.convolution_backward`` of a VALID, undilated, ungrouped conv
    at input ``x``, given the real ``x`` and ``weight`` (``torch.nn.grad``'s
    helpers pass a stand-in expanded from one element, which a backend that
    wants contiguous inputs copies to full size)."""
    return torch.ops.aten.convolution_backward(gy, x, weight, None, stride, (0, 0), (1, 1), False, (0, 0), 1, mask)


class _TransposedConv(torch.autograd.Function):
    """(gy, W) -> the gradient of a conv at its padded input ``x`` (cuDNN's
    dgrad, as autograd computes it). Its backward: d gy is the conv of the
    incoming gradient, dW is backward-filter with that gradient as the
    input and ``gy`` as the output gradient."""

    @staticmethod
    def forward(ctx, gy, weight, x, stride):
        ctx.save_for_backward(gy, weight)
        ctx.stride = stride
        return _conv_backward(gy, x, weight, stride, (True, False, False))[0]

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        gy, weight = ctx.saved_tensors
        d_gy = F.conv2d(gg, weight, stride=ctx.stride) if ctx.needs_input_grad[0] else None
        d_w = None
        if ctx.needs_input_grad[1]:
            d_w = _conv_backward(gy, gg, weight, ctx.stride, (False, True, False))[1]
            _penalty_runs["weight_grads"] += 1
        return d_gy, d_w, None, None


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

    def penalty_input_grad(self, x: torch.Tensor) -> torch.Tensor:
        """d(mean patch validity of each sample)/dx [B, T, n_feat], the
        critic in eval mode (no dropout), differentiable in the conv weights
        (the module docstring says how). Equal to autograd's gradient of
        ``forward(x)[0].mean(dim=(1, 2)).sum()`` taken with
        ``create_graph``: the same dgrad convs and leaky-relu rule. The
        biases do not enter it."""
        ns = self.hps.ns
        layers = []  # (conv, its padded input, the pads, its pre-activation; None at the head)
        with torch.no_grad():
            y = x[:, None]
            for conv in [getattr(self, f"conv_{i}") for i in range(len(CHANNELS))] + [self.patch_head]:
                p, pad = pad_same(conv, y)
                pre = None if conv is self.patch_head else conv(p)
                layers.append((conv, p, pad, pre))
                if pre is not None:
                    y = F.leaky_relu(pre, ns)
        (kt, kf), (st, sf), p = self.patch_head.kernel_size, self.patch_head.stride, layers[-1][1]
        t_out, f_out = (p.shape[2] - kt) // st + 1, (p.shape[3] - kf) // sf + 1
        g = p.new_full((x.shape[0], 1, t_out, f_out), 1.0 / (t_out * f_out))
        for conv, p, (t_lo, t_hi, f_lo, f_hi), pre in reversed(layers):
            if pre is not None:
                g = torch.ops.aten.leaky_relu_backward(g, pre, ns, False)
            gp = _TransposedConv.apply(g, conv.weight, p, conv.stride)
            g = gp[:, :, t_lo : gp.shape[2] - t_hi, f_lo : gp.shape[3] - f_hi]
        _penalty_runs["routes"] += 1
        return g[:, 0]
