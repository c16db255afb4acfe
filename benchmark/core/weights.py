"""Seeded weights and speaker statistics, made by the benchmark and handed
to both the program and the reference.

Weights are drawn on the device in one call from a ``torch.Generator``
seeded with the run's seed: kernels a normal of flax's lecun sigma
(sqrt(1 / fan_in) / 0.8796) clamped at +-2 sigma, recurrent ``wh`` a
normal of 1 / sqrt(H), the speaker embedding a normal of 1 / sqrt(width),
biases zero.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.model import param_shapes

TRUNC_STD = 0.87962566103423978


def make_params(hp: dict, modules, seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{module: {state-dict name: float32 tensor on device}}."""
    shapes = {m: param_shapes(hp, m) for m in modules}
    total = sum(math.prod(s) for sh in shapes.values() for s in sh.values())
    gen = torch.Generator(device=device).manual_seed(int(seed))
    r = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for m, sh in shapes.items():
        out[m] = {}
        for name, shape in sh.items():
            n = math.prod(shape)
            v = r[off : off + n].view(shape)
            off += n
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "bh"):
                v = torch.zeros_like(v)
            elif leaf == "wh":
                v = v / math.sqrt(shape[0])
            elif leaf == "embedding":
                v = v / math.sqrt(shape[1])
            else:
                v = v.clamp(-2.0, 2.0) * (math.sqrt(1.0 / math.prod(shape[1:])) / TRUNC_STD)
            out[m][name] = v.contiguous()
    return out


def make_stats(names, n_feat: int, seed: int) -> tuple[dict, dict]:
    """Speaker statistics (mean, std) [n_feat] for each of ``names``:
    means uniform on [0.3, 0.6], stds on [0.05, 0.2]."""
    g = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    mean = {s: g.uniform(0.3, 0.6, n_feat).astype(np.float32) for s in names}
    std = {s: g.uniform(0.05, 0.2, n_feat).astype(np.float32) for s in names}
    return mean, std
