"""The flax -> PyTorch parameter bridge, and seeded weights.

The JAX package's parameters are nested dicts (``enc`` and ``dec``, each
with or without the flax ``params`` level). The port's modules carry the
same names (models/layers.py), so a flax path maps to a state-dict key by
joining with "." and renaming the leaf, plus a layout change:

    Conv  kernel [k, in, out]  <->  Conv1d.weight [out, in, k]
    Dense kernel [in, out]     <->  Linear.weight [out, in]
    bias, Embed embedding, GRU wh [H, 3H] / bh [3H]   unchanged

(GRU gate order r, z, n in both). In an export bundle's ``model.npz`` the
arrays keep the flax layout under "/"-joined paths such as
``enc/rnn/bwd/wh``.
"""

from __future__ import annotations

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import Hps


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    """{"a/b/c": array} -> nested dict."""
    tree: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _strip_params(tree: dict) -> dict:
    return tree["params"] if set(tree) == {"params"} else tree


def _to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    sd = {}
    for path, arr in flatten(_strip_params(tree)).items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":  # Conv [k, in, out] / Dense [in, out]
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
            leaf = "weight"
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.array(arr, np.float32))  # own copy
    return sd


def _to_flax(sd: dict) -> dict:
    flat = {}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":  # Conv1d [out, in, k] / Linear [out, in]
            arr = arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T
            leaf = "kernel"
        flat["/".join(mods + [leaf])] = np.ascontiguousarray(arr)
    return unflatten(flat)


def from_flax(tree: dict) -> tuple[dict, dict]:
    """``{"enc": ..., "dec": ...}`` flax params (numpy leaves) ->
    (encoder state_dict, decoder state_dict)."""
    return _to_state_dict(tree["enc"]), _to_state_dict(tree["dec"])


def to_flax(enc_sd: dict, dec_sd: dict) -> dict:
    """Inverse of :func:`from_flax` (no ``params`` level)."""
    return {"enc": _to_flax(enc_sd), "dec": _to_flax(dec_sd)}


def _init_module(module: torch.nn.Module, gen: torch.Generator) -> None:
    """flax's initialisers in spirit: lecun-normal kernels (std
    1/sqrt(fan_in)), zero biases, orthogonal recurrent ``wh`` (orthonormal
    rows), unit-normal embeddings."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bias", "bh"):
                p.zero_()
            elif leaf == "wh":
                q, r = torch.linalg.qr(torch.randn(p.shape[1], p.shape[0], generator=gen))
                p.copy_((q * torch.sign(torch.diagonal(r))).T)
            elif leaf == "embedding":
                p.copy_(torch.randn(p.shape, generator=gen))
            else:  # Conv1d [out, in, k] / Linear [out, in]
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(fan_in))


def init_params(hps: Hps, seed: int = 0) -> dict:
    """Seeded weights at any geometry, as a flax-layout tree
    ``{"enc": ..., "dec": ...}`` (what an export bundle stores)."""
    from zerospeech_tts_tpu_torch.models import Decoder, Encoder

    gen = torch.Generator().manual_seed(int(seed))
    enc, dec = Encoder(hps), Decoder(hps)
    _init_module(enc, gen)
    _init_module(dec, gen)
    return to_flax(enc.state_dict(), dec.state_dict())
