"""Stage 2 (patchGAN) training steps in plain PyTorch: the batch sampler
of the training arena, the WGAN-GP critic step and the generator step,
each module's gradient clipped by its own global norm, then Adam.

A frozen copy of the port's ``data/device_dataset.py`` sampler and
``train/solver.py`` ``step_patch_d`` / ``step_patch_g``, over the
functions of reference/model.py, with gradients from autograd through
the plain GRU and Adam written out. Every draw comes from one
``torch.Generator`` in the port's order, so from the port's generator
state the reference draws the port's batches, masks and noise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import model
from benchmark.reference.precision import exact


class Noise:
    """Uniform [0, 1) draws from one generator, on its device."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.gen, device=self.gen.device).to(device)


def sample(arena, starts, lens, spk, weights, gen, batch: int, seg: int):
    """(x [B, seg, F] f32, spk [B]): utterances drawn in proportion to
    weights x valid segment positions (length - seg + 1), the start
    uniform over them."""
    n_pos = (lens - seg + 1).clamp(min=0)
    idx = torch.multinomial(n_pos.float() * weights, batch, replacement=True, generator=gen)
    u = torch.rand(batch, generator=gen, device=arena.device)
    t0 = torch.minimum((u * n_pos[idx].float()).long(), n_pos[idx] - 1)
    rows = (starts[idx] + t0)[:, None] + torch.arange(seg, device=arena.device)[None, :]
    return arena[rows].float(), spk[idx]


def batch(data: dict, gen, hp: dict) -> dict:
    """A stage-2 batch: sources with every utterance weighted alike, reals
    weighted by ``real_w`` (the target speakers)."""
    a = (data["arena"], data["starts"], data["lens"], data["spk"])
    x, s = sample(*a, torch.ones_like(data["real_w"]), gen, hp["batch_size"], hp["seg_len"])
    xr, sr = sample(*a, data["real_w"], gen, hp["batch_size"], hp["seg_len"])
    return {"x": x, "spk": s, "x_real": xr, "spk_real": sr}


class Adam:
    """Adam as torch.optim.Adam steps it (no weight decay, eps outside
    the root of the bias-corrected second moment)."""

    def __init__(self, params: list, lr: float, b1: float, b2: float, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / c2**0.5 + self.eps))


class Trainer:
    """The four modules' parameters (dicts of leaf tensors), an Adam for
    each, and the generator every draw comes from. ``q`` rounds the
    operands of every product and convolution (the control). ``half``
    (a fault): every batch cut to its first half, the means over those
    rows."""

    def __init__(self, hp: dict, params: dict, gen: torch.Generator, q=exact, half: bool = False):
        self.hp, self.gen, self.q, self.half = hp, gen, q, half
        self.p = {n: {k: v.detach().clone().requires_grad_(True) for k, v in d.items()}
                  for n, d in params.items()}
        self.opt = {n: Adam(list(d.values()), hp["lr"], hp["beta1"], hp["beta2"]) for n, d in self.p.items()}
        self.noise = Noise(gen)
        self.losses: list[float] = []
        self.first_grads: dict[str, dict] = {}  # module -> {leaf: gradient of its first step, clipped}

    def _batch(self, data):
        b = batch(data, self.gen, self.hp)
        return {k: v[: v.shape[0] // 2] for k, v in b.items()} if self.half else b

    def _encode(self, x):
        hp = self.hp
        logits = model.encoder(self.p["enc"], hp, x, self.q, self.noise)
        return model.gumbel_binary(logits, hp["gumbel_temp"], self.noise)

    def _targets(self, spk_real):
        n = spk_real.shape[0]
        u = self.noise.uniform((n,), spk_real.device)
        return spk_real[(u * n).long().clamp(max=n - 1)]

    def _update(self, name: str, loss) -> None:
        params = list(self.p[name].values())
        grads = torch.autograd.grad(loss, params)
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm < self.hp["max_grad_norm"], torch.ones_like(norm), self.hp["max_grad_norm"] / norm)
        grads = [g * scale for g in grads]
        if name not in self.first_grads:
            self.first_grads[name] = {k: g.detach().clone() for k, g in zip(self.p[name], grads)}
        self.opt[name].step(grads)
        self.losses.append(float(loss.detach()))

    def critic_step(self, data) -> None:
        hp, q, b = self.hp, self.q, self._batch(data)
        spk_tgt = self._targets(b["spk_real"])
        with torch.no_grad():
            x_fake = model.decoder(self.p["dec"], hp, self._encode(b["x"]), spk_tgt, q)
        patch_real, cls_real = model.critic(self.p["dis"], hp, b["x_real"], q, self.noise)
        patch_fake, _ = model.critic(self.p["dis"], hp, x_fake, q, self.noise)
        w_dist = patch_real.mean() - patch_fake.mean()
        eps = self.noise.uniform((b["x_real"].shape[0], 1, 1), b["x_real"].device)
        x_hat = (eps * b["x_real"] + (1.0 - eps) * x_fake).requires_grad_(True)
        p_hat, _ = model.critic(self.p["dis"], hp, x_hat, q)
        (g,) = torch.autograd.grad(p_hat.mean(dim=(1, 2)).sum(), x_hat, create_graph=True)
        gp = ((torch.sqrt((g * g).sum(dim=(1, 2)) + 1e-12) - 1.0) ** 2).mean()
        loss = (hp["beta_dis"] * (-w_dist) + hp["lambda_"] * gp
                + hp["beta_clf"] * F.cross_entropy(cls_real, b["spk_real"]))
        self._update("dis", loss)

    def generator_step(self, data) -> None:
        hp, q = self.hp, self.q
        if hp["beta_rec"]:
            raise ValueError("the reference generator step has no reconstruction anchor (beta_rec > 0)")
        b = self._batch(data)
        spk_tgt = self._targets(b["spk_real"])
        with torch.no_grad():
            z = self._encode(b["x"])
        patch_fake, cls_fake = model.critic(self.p["dis"], hp, model.decoder(self.p["dec"], hp, z, spk_tgt, q), q)
        loss = hp["beta_gen"] * -patch_fake.mean() + hp["beta_clf"] * F.cross_entropy(cls_fake, spk_tgt)
        self._update("dec", loss)

    def iteration(self, data) -> None:
        """n_critic critic steps, each on a batch of its own, then one
        generator step on the next batch."""
        for _ in range(self.hp["n_critic"]):
            self.critic_step(data)
        self.generator_step(data)
