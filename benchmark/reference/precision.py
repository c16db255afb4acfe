"""Operand rounding for the references and their controls.

``exact`` leaves every operand as it is (the configuration's precision).
The controls round the operands of every matrix product and convolution of
the encoder and decoder (and of the critic in training) to the nearest
precision below the configuration's: TF32 under a float32 model (the
rounding cuBLAS and cuDNN apply when ``allow_tf32`` is on), float8 e4m3
with one scale a tensor under a bfloat16 model. Each rounding passes the
gradient straight through.
"""

from __future__ import annotations

import torch


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def _straight_through(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return x + (r - x).detach() if x.requires_grad else r


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 bits of mantissa, to nearest."""
    if x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return _straight_through(x, r)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """A tensor rounded to float8 e4m3 under one scale (its largest
    magnitude at e4m3's largest, 448), back in its own dtype."""
    if not x.is_floating_point():
        return x
    d = x.detach()
    scale = d.abs().amax().float().clamp_min(1e-30) / 448.0
    r = ((d.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return _straight_through(x, r)


ROUNDINGS = {"exact": exact, "tf32": tf32, "fp8": fp8}
# the control of each precision a configuration states: the step below it
CONTROL_OF = {"float32": "tf32", "bfloat16": "fp8"}
