"""Solver, the training runtime of the PyTorch port (counterpart of
``zerospeech_tts_tpu/train/solver.py``; ref solver.py).

* stage-1 phases: ``pretrain_AE`` (reconstruction, plus the same-utterance
  pair term), ``pretrain_C`` (speaker classifier on stop-gradient
  latents), ``train`` (a classifier step, then the adversarial autoencoder
  step L_rec - alpha L_clf against the UPDATED classifier in eval mode,
  alpha annealed over ``lat_sched_iters`` from the recorded phase start).
* stage 2 ``patchGAN``: WGAN-GP patch critic with an auxiliary speaker
  head, ``n_critic`` critic steps per generator (decoder) step.

The optimizer of each module is ``clip_by_global_norm(max_grad_norm)``
then Adam(lr, beta1, beta2), as optax chains them: the clip scales a
module's gradient by min(1, max / ||g||) with that module's norm alone.
Steps run eagerly; every random draw (dropout, Gumbel noise, stage-2 target
speakers, penalty mixes) comes from a noise source (models/layers.py),
by default the state's generator, so a test can feed JAX's draws.
Each step leaves the (clipped) gradients in the parameters' ``.grad``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import Noise
from zerospeech_tts_tpu_torch.models.mbv import discretize
from zerospeech_tts_tpu_torch.params import MODULES, init_modules

PAIR_SEP_MARGIN = 0.2  # min mean |z_t - z_{t+n/2}|: anti-collapse floor of the pair term


class TrainState:
    """Step counters, the four modules, their Adam optimizers and the
    generator every draw comes from (all on one device)."""

    def __init__(self, hps: Hps, modules: dict, gen: torch.Generator):
        self.step = 0
        self.train_start = -1  # global step at which the 'train' phase began
        self.modules = modules
        self.opts = {
            name: torch.optim.Adam(m.parameters(), lr=hps.lr, betas=(hps.beta1, hps.beta2), eps=1e-8)
            for name, m in modules.items()
        }
        self.gen = gen

    @property
    def device(self) -> torch.device:
        return next(self.modules["enc"].parameters()).device

    enc = property(lambda self: self.modules["enc"])
    dec = property(lambda self: self.modules["dec"])
    clf = property(lambda self: self.modules["clf"])
    dis = property(lambda self: self.modules["dis"])


def init_state(hps: Hps, seed: int | None = None, device: str | torch.device = "cuda") -> TrainState:
    """Seeded modules (params.init_modules) on ``device`` and a generator
    there seeded from the same seed."""
    seed = hps.seed if seed is None else seed
    mods = {n: m.to(device) for n, m in init_modules(hps, seed, MODULES).items()}
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed) + 1)
    return TrainState(hps, mods, gen)


def _abs(x):
    """|x| with JAX's gradient: +1 at x == 0, where ``torch.abs`` has 0.
    Differences of binary latents are often exactly 0 (the pair term)."""
    return torch.where(x >= 0, x, -x)


def _acc(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


class Solver:
    def __init__(self, hps: Hps):
        self.hps = hps

    # ------------------------------------------------------- shared pieces

    def _noise(self, state, noise):
        return Noise(state.gen) if noise is None else noise

    def _encode(self, enc, x, noise):
        """Spectrogram -> discretized latent in training mode (dropout and
        Gumbel noise from ``noise``)."""
        h = self.hps
        return discretize(enc(x, train=True, noise=noise), h.enc_mode, h.gumbel_temp, noise)

    def _update(self, state, names, loss) -> None:
        """Gradients of ``loss`` for each module in ``names``, each clipped
        by its own global norm (optax: g * max / ||g|| when ||g|| >= max)
        and left in ``.grad``; then one Adam step per module."""
        params = {n: list(state.modules[n].parameters()) for n in names}
        grads = iter(torch.autograd.grad(loss, [p for n in names for p in params[n]]))
        mx = self.hps.max_grad_norm
        for n in names:
            gs = [next(grads) for _ in params[n]]
            norm = torch.sqrt(sum((g * g).sum() for g in gs))
            scale = torch.where(norm < mx, torch.ones_like(norm), mx / norm)
            for p, g in zip(params[n], gs):
                p.grad = g * scale
        for n in names:
            state.opts[n].step()

    def alpha(self, step: int, train_start: int) -> float:
        """Adversarial weight, ramped over lat_sched_iters from the recorded
        start of the 'train' phase (-1, not yet stamped, counts as 0)."""
        h = self.hps
        rel = (step - max(train_start, 0)) / h.lat_sched_iters
        return h.alpha_enc * min(max(rel, 0.0), 1.0)

    @staticmethod
    def stamp_train_start(state: TrainState, mode: str) -> None:
        if mode == "train" and state.train_start < 0:
            state.train_start = state.step

    def pair_consistency(self, z, z2, pair_dt):
        """Same-utterance pair term: L1 between the latents aligned on the
        overlap of the two windows (offset pair_dt / downsample latent
        frames; masked mean) plus the hinge relu(margin - mean |z_t -
        z_{t+n/2}|) against the collapsed constant solution."""
        n = z.shape[1]
        d = torch.div(pair_dt, self.hps.downsample, rounding_mode="floor")[:, None]
        t = torch.arange(n, device=z.device)[None, :]
        ia = (t + d.clamp(min=0)).clamp(0, n - 1)
        ib = (t + (-d).clamp(min=0)).clamp(0, n - 1)
        za = torch.gather(z, 1, ia[..., None].expand(-1, -1, z.shape[2]))
        zb = torch.gather(z2, 1, ib[..., None].expand(-1, -1, z.shape[2]))
        valid = (t < n - d.abs()).to(z.dtype)
        l_align = (_abs(za - zb) * valid[..., None]).sum() / (valid.sum() * z.shape[-1] + 1e-8)
        sep = _abs(z[:, n // 2 :] - z[:, : n - n // 2]).mean()
        return l_align + F.relu(PAIR_SEP_MARGIN - sep)

    def _has_pair(self, batch) -> bool:
        return self.hps.lambda_pair > 0 and "x2" in batch and "pair_dt" in batch

    def _ae_latents(self, state, batch, noise):
        """(z, z2 or None): x and its pair encoded in one batched pass."""
        x = batch["x"]
        if self._has_pair(batch):
            z, z2 = self._encode(state.enc, torch.cat([x, batch["x2"]]), noise).chunk(2)
            return z, z2
        return self._encode(state.enc, x, noise), None

    # ---------------------------------------------------------- stage 1

    def step_pretrain_ae(self, state: TrainState, batch: dict, noise=None) -> dict:
        """Reconstruction warm-up of encoder + decoder (+ the pair term)."""
        h, noise = self.hps, self._noise(state, noise)
        z, z2 = self._ae_latents(state, batch, noise)
        l_rec = _abs(state.dec(z, batch["spk"]) - batch["x"]).mean()
        loss, metrics = l_rec, {"loss_rec": l_rec}
        if z2 is not None:
            l_pair = self.pair_consistency(z, z2, batch["pair_dt"])
            loss = loss + h.lambda_pair * l_pair
            metrics["loss_pair"] = l_pair
        self._update(state, ("enc", "dec"), loss)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def step_pretrain_clf(self, state: TrainState, batch: dict, noise=None) -> dict:
        """Speaker classifier on stop-gradient (frozen encoder) latents."""
        h, noise = self.hps, self._noise(state, noise)
        with torch.no_grad():
            z = self._encode(state.enc, batch["x"], noise)
        logits = state.clf(z, train=True, noise=noise)
        l_clf = h.alpha_dis * F.cross_entropy(logits, batch["spk"])
        self._update(state, ("clf",), l_clf)
        state.step += 1
        return {"loss_clf": l_clf.detach(), "acc_clf": _acc(logits.detach(), batch["spk"])}

    def step_train(self, state: TrainState, batch: dict, noise=None) -> dict:
        """(a) classifier step on stop-gradient latents, then (b) the
        adversarial autoencoder step against the updated classifier.

        The JAX step encodes both passes with one key: without the pair its
        two latents are the same sample, so here (a) reuses (b)'s latents;
        with the pair, (a) encodes x alone with draws of its own."""
        h, noise = self.hps, self._noise(state, noise)
        x, spk = batch["x"], batch["spk"]
        alpha = self.alpha(state.step, state.train_start)
        if self._has_pair(batch):
            with torch.no_grad():
                z_sg = self._encode(state.enc, x, noise)
            z, z2 = self._ae_latents(state, batch, noise)
        else:
            z, z2 = self._ae_latents(state, batch, noise)
            z_sg = z.detach()

        clf_logits = state.clf(z_sg, train=True, noise=noise)
        l_clf = h.alpha_dis * F.cross_entropy(clf_logits, spk)
        self._update(state, ("clf",), l_clf)

        l_rec = _abs(state.dec(z, spk) - x).mean()
        l_adv = F.cross_entropy(state.clf(z, train=False), spk)  # the encoder wants this large
        loss = l_rec - alpha * l_adv
        metrics = {"loss_rec": l_rec, "loss_clf": l_clf, "loss_adv": l_adv,
                   "acc_clf": _acc(clf_logits.detach(), spk)}
        if z2 is not None:
            l_pair = self.pair_consistency(z, z2, batch["pair_dt"])
            loss = loss + h.lambda_pair * l_pair
            metrics["loss_pair"] = l_pair
        self._update(state, ("enc", "dec"), loss)
        state.step += 1
        out = {k: v.detach() for k, v in metrics.items()}
        out["alpha"] = torch.tensor(alpha)
        return out

    # ---------------------------------------------------------- stage 2

    def _target_speakers(self, spk_real, noise):
        """Targets drawn uniformly, with replacement, from the real labels."""
        n = spk_real.shape[0]
        u = noise.uniform((n,), spk_real.device)
        return spk_real[(u * n).long().clamp(max=n - 1)]

    def step_patch_d(self, state: TrainState, batch: dict, noise=None) -> dict:
        """WGAN-GP critic step: fakes are the decoder's conversions of
        ``x`` to targets drawn from ``spk_real``; the gradient penalty
        takes per-sample critic gradients (critic in eval mode) at random
        mixes of real and fake."""
        h, noise = self.hps, self._noise(state, noise)
        x_src, x_real, spk_real = batch["x"], batch["x_real"], batch["spk_real"]
        spk_tgt = self._target_speakers(spk_real, noise)
        with torch.no_grad():
            x_fake = state.dec(self._encode(state.enc, x_src, noise), spk_tgt)
        patch_real, cls_real = state.dis(x_real, train=True, noise=noise)
        patch_fake, _ = state.dis(x_fake, train=True, noise=noise)
        w_dist = patch_real.mean() - patch_fake.mean()
        eps = noise.uniform((x_real.shape[0], 1, 1), x_real.device)
        x_hat = (eps * x_real + (1.0 - eps) * x_fake).requires_grad_(True)
        p_hat, _ = state.dis(x_hat, train=False)
        (g_int,) = torch.autograd.grad(p_hat.mean(dim=(1, 2)).sum(), x_hat, create_graph=True)
        gnorm = torch.sqrt((g_int * g_int).sum(dim=(1, 2)) + 1e-12)
        gp = ((gnorm - 1.0) ** 2).mean()
        l_cls = F.cross_entropy(cls_real, spk_real)
        loss = h.beta_dis * (-w_dist) + h.lambda_ * gp + h.beta_clf * l_cls
        self._update(state, ("dis",), loss)
        state.step += 1
        return {"loss_d": loss.detach(), "w_dist": w_dist.detach(), "grad_penalty": gp.detach(),
                "loss_d_cls": l_cls.detach(), "acc_d_cls": _acc(cls_real.detach(), spk_real)}

    def step_patch_g(self, state: TrainState, batch: dict, noise=None) -> dict:
        """Generator (decoder) step: fool the critic and land its speaker
        head on the drawn target (+ beta_rec x a same-speaker
        reconstruction anchor when beta_rec > 0)."""
        h, noise = self.hps, self._noise(state, noise)
        x_src = batch["x"]
        spk_tgt = self._target_speakers(batch["spk_real"], noise)
        with torch.no_grad():
            z = self._encode(state.enc, x_src, noise)
        patch_fake, cls_fake = state.dis(state.dec(z, spk_tgt), train=False)
        l_adv = -patch_fake.mean()
        l_cls = F.cross_entropy(cls_fake, spk_tgt)
        loss = h.beta_gen * l_adv + h.beta_clf * l_cls
        if h.beta_rec > 0:
            loss = loss + h.beta_rec * _abs(state.dec(z, batch["spk"]) - x_src).mean()
        self._update(state, ("dec",), loss)
        state.step += 1
        return {"loss_g": loss.detach(), "loss_g_adv": l_adv.detach(), "loss_g_cls": l_cls.detach()}

    # -------------------------------------------------------- orchestration

    def step_fn(self, mode: str):
        return {"pretrain_AE": self.step_pretrain_ae, "pretrain_C": self.step_pretrain_clf,
                "train": self.step_train}[mode]

    def train(self, state: TrainState, dataset, mode: str, iters: int, logger=None, ckpt=None,
              log_interval: int | None = None, save_interval: int | None = None,
              pairs: bool = True) -> dict:
        """One phase of ``iters`` iterations with batches sampled on the
        device from ``dataset`` (data/device_dataset.py) with the state's
        generator, updating ``state`` in place. For patchGAN an iteration is
        n_critic critic steps and one generator step. Logs and saves every
        log/save interval; returns the last iteration's metrics."""
        h = self.hps
        log_interval = log_interval or h.log_interval
        save_interval = save_interval or h.save_interval
        want_pairs = pairs and mode in ("pretrain_AE", "train") and h.lambda_pair > 0

        def sample(p=False):
            return dataset.sample_batch(state.gen, pairs=p)

        self.stamp_train_start(state, mode)
        metrics = {}
        for i in range(iters):
            if mode == "patchGAN":
                for _ in range(h.n_critic):
                    m_d = self.step_patch_d(state, sample())
                metrics = {**m_d, **self.step_patch_g(state, sample())}
            else:
                metrics = self.step_fn(mode)(state, sample(want_pairs))
            if logger and (i + 1) % log_interval == 0:
                logger.log(state.step, metrics, prefix=mode)
            if ckpt and (i + 1) % save_interval == 0:
                ckpt.save(state)
        return metrics
