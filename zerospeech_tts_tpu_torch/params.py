"""The flax -> PyTorch parameter bridge, and seeded weights.

The JAX package's parameters are nested dicts (``enc``, ``dec``, ``clf``
and ``dis``, each with or without the flax ``params`` level). The port's
modules carry the same names (models/), so a flax path maps to a
state-dict key by joining with "." and renaming the leaf, plus a layout
change:

    Conv 1-D kernel [k, in, out]         <->  Conv1d.weight [out, in, k]
    Conv 2-D kernel [kh, kw, in, out]    <->  Conv2d.weight [out, in, kh, kw]
    Dense kernel [in, out]               <->  Linear.weight [out, in]
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


# flax kernel layout -> torch weight layout, by rank (and back)
_TO_TORCH = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def flax_last_axis(key: str, ndim: int) -> int:
    """The torch axis of state-dict entry ``key`` (``ndim`` dims) that is
    the last axis of its flax layout: torch dim 0 (the output axis) of a
    Conv/Linear ``weight``, the last dim of a leaf kept in flax layout
    (GRU ``wh``, the speaker embedding)."""
    return _TO_FLAX[ndim][-1] if key.rsplit(".", 1)[-1] == "weight" else ndim - 1


def _to_state_dict(tree: dict) -> dict[str, torch.Tensor]:
    sd = {}
    for path, arr in flatten(_strip_params(tree)).items():
        *mods, leaf = path.split("/")
        if leaf == "kernel":  # Conv [k.., in, out] / Dense [in, out]
            arr = arr.transpose(_TO_TORCH[arr.ndim])
            leaf = "weight"
        sd[".".join(mods + [leaf])] = torch.from_numpy(np.array(arr, np.float32))  # own copy
    return sd


def _to_flax(sd: dict) -> dict:
    flat = {}
    for key, t in sd.items():
        *mods, leaf = key.split(".")
        arr = t.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":  # Conv1d/Conv2d [out, in, k..] / Linear [out, in]
            arr = arr.transpose(_TO_FLAX[arr.ndim])
            leaf = "kernel"
        flat["/".join(mods + [leaf])] = np.ascontiguousarray(arr)
    return unflatten(flat)


def from_flax(tree: dict) -> tuple[dict, dict]:
    """``{"enc": ..., "dec": ...}`` flax params (numpy leaves) ->
    (encoder state_dict, decoder state_dict)."""
    return _to_state_dict(tree["enc"]), _to_state_dict(tree["dec"])


def to_flax(enc_sd: dict, dec_sd: dict) -> dict:
    """Inverse of :func:`from_flax` (no ``params`` level)."""
    return flax_from_state_dicts({"enc": enc_sd, "dec": dec_sd})


def state_dicts_from_flax(tree: dict) -> dict[str, dict]:
    """Any of ``{"enc", "dec", "clf", "dis"}`` flax trees -> state dicts
    under the same names."""
    return {name: _to_state_dict(sub) for name, sub in tree.items()}


def flax_from_state_dicts(sds: dict[str, dict]) -> dict:
    """Inverse of :func:`state_dicts_from_flax` (no ``params`` level)."""
    return {name: _to_flax(sd) for name, sd in sds.items()}


def load_adam_state(opt: torch.optim.Adam, module: torch.nn.Module, count, mu: dict, nu: dict) -> None:
    """Set ``opt`` (over ``module.parameters()``) to an optax Adam state:
    step ``count`` and first/second moments ``mu``/``nu`` as flax-layout
    trees of ``module``'s parameters (numpy leaves)."""
    m_sd, v_sd = _to_state_dict(mu), _to_state_dict(nu)
    for name, p in module.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": m_sd[name].to(p.device),
            "exp_avg_sq": v_sd[name].to(p.device),
        }


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
            else:  # Conv1d/Conv2d [out, in, k..] / Linear [out, in]
                fan_in = int(np.prod(p.shape[1:]))
                p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(fan_in))


MODULES = ("enc", "dec", "clf", "dis")


def make_module(name: str, hps: Hps) -> torch.nn.Module:
    from zerospeech_tts_tpu_torch.models import Decoder, Encoder, PatchDiscriminator, SpeakerClassifier

    cls = {"enc": Encoder, "dec": Decoder, "clf": SpeakerClassifier, "dis": PatchDiscriminator}[name]
    return cls(hps)


def init_modules(hps: Hps, seed: int = 0, names=MODULES) -> dict[str, torch.nn.Module]:
    """Seeded modules (CPU), initialised in the order of ``names`` from one
    generator, so ``enc`` and ``dec`` get the same weights whatever follows."""
    gen = torch.Generator().manual_seed(int(seed))
    mods = {}
    for name in names:
        mods[name] = make_module(name, hps)
        _init_module(mods[name], gen)
    return mods


def init_params(hps: Hps, seed: int = 0, names=("enc", "dec")) -> dict:
    """Seeded weights at any geometry, as a flax-layout tree
    ``{"enc": ..., "dec": ...}`` (what an export bundle stores)."""
    mods = init_modules(hps, seed, names)
    return flax_from_state_dicts({n: m.state_dict() for n, m in mods.items()})


def train_state_from_flax(hps: Hps, params: dict, adam: dict | None = None, step: int = 0,
                          train_start: int = -1, device: str | torch.device = "cuda"):
    """A port ``TrainState`` (train/solver.py) on ``device`` (the card
    unless the caller asks for the CPU) from a JAX one's numpy leaves:
    ``params`` {"enc", "dec", "clf", "dis"} flax trees, ``adam`` {name:
    (count, mu, nu)} from each module's optax Adam state, and the step
    counters. The generator is seeded with 0."""
    from zerospeech_tts_tpu_torch.train.solver import TrainState

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is visible")

    sds = state_dicts_from_flax(params)
    mods = {}
    for name in MODULES:
        mods[name] = make_module(name, hps)
        mods[name].load_state_dict(sds[name])
        mods[name].to(device)
    state = TrainState(hps, mods, torch.Generator(device=torch.device(device)).manual_seed(0))
    for name, (count, mu, nu) in (adam or {}).items():
        load_adam_state(state.opts[name], mods[name], count, mu, nu)
    state.step, state.train_start = int(step), int(train_start)
    return state
