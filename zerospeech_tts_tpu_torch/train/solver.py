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
Each step leaves the (clipped) gradients in the parameters' ``.grad``
(tensor-parallel: it frees them).

Batches come from a ``DeviceDataset`` (sampled on the device with the
state's generator) or from any iterator of batch dicts, such as the host
``SegmentLoader`` (data/loader.py). With ``check_numerics`` every step's
losses and per-module gradient norms are checked, and the first
non-finite one raises ``FloatingPointError`` naming the phase and step
(the counterpart of JAX's ``jax_debug_nans``); without it nothing is
checked and nothing waits for the device.

Data-parallel steps (``Solver(group=)``, one process a card, each with its
rows of the global batch): after ``autograd.grad`` and before each
module's clip, that module's gradients go through one ``all_reduce`` (a
flat buffer, summed, divided by the world size), which is what pjit's psum
gives the JAX step; the modules are not wrapped in
``DistributedDataParallel``, whose hooks fire on ``.grad`` accumulation and
never on ``autograd.grad``. Three places read more than a rank's rows and
are made global, so that a step equals the single-process step on the
global batch: the stage-2 target draw indexes the gathered ``spk_real``;
the pair term's masked mean divides by the global count of valid frames,
and its hinge acts on the global separation; the returned metrics are
means over the ranks (so ``check_numerics`` raises on every rank
together). Each rank's generator is seeded from (seed, data rank).

Tensor-parallel steps (``--mesh data=D,model=M``, a state placed by
``parallel.mesh.shard_state``): the M ranks of a data row step on the same
rows with the same draws, and each keeps between steps its block of every
sharded parameter and of its Adam moments. A step gathers the whole
weights of a module when it first reads it (``TrainState.module``); the
gradient all_reduce stays one a module over the world (so every rank holds
the same whole gradient, and each module's clip norm is the norm of the
logical gradient on every rank); each rank then takes its block of a
sharded leaf's gradient and its Adam steps the blocks; an updated module's
whole weights and the gradients are freed, and so is every gathered module
when the step ends. The collectives that read rows (target draw, pair
term, metrics) run over the data group (``Solver(data_group=)``), which
holds one rank of each data row.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models.layers import Noise
from zerospeech_tts_tpu_torch.models.mbv import discretize
from zerospeech_tts_tpu_torch.params import MODULES, init_modules
from zerospeech_tts_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_mean_
from zerospeech_tts_tpu_torch.tracing import span

PAIR_SEP_MARGIN = 0.2  # min mean |z_t - z_{t+n/2}|: anti-collapse floor of the pair term


class TrainState:
    """Step counters, the four modules, their Adam optimizers and the
    generator every draw comes from (all on one device). ``seed`` and
    ``rank`` (the data rank) say where the generator comes from
    (``reseed``). ``shards`` is None, or the tensor-parallel placement
    (``parallel.mesh.ModelShards``), whose blocks the optimizers step."""

    def __init__(self, hps: Hps, modules: dict, gen: torch.Generator, seed: int | None = None,
                 rank: int = 0):
        self.seed = hps.seed if seed is None else seed
        self.rank = rank
        self.step = 0
        self.train_start = -1  # global step at which the 'train' phase began
        self.modules = modules
        self.opts = {
            name: torch.optim.Adam(m.parameters(), lr=hps.lr, betas=(hps.beta1, hps.beta2), eps=1e-8)
            for name, m in modules.items()
        }
        self.gen = gen
        self.shards = None

    def reseed(self, step: int = 0) -> None:
        """Seed the generator: data rank 0 from seed + 1 (a single
        process's seed), a data rank above 0 from (seed, rank, step), so
        the ranks of one data row draw alike. A checkpoint holds rank 0's
        generator alone, so a resume at ``step`` restores it on data rank 0
        and reseeds every other data rank here."""
        if self.rank == 0:
            self.gen.manual_seed(int(self.seed) + 1)
        else:
            seq = np.random.SeedSequence([int(self.seed) + 1, self.rank, int(step)])
            self.gen.manual_seed(int(seq.generate_state(1)[0]))

    @property
    def device(self) -> torch.device:
        return next(self.modules["enc"].parameters()).device

    def module(self, name: str) -> torch.nn.Module:
        """Module ``name`` with its whole weights (tensor-parallel: gathered
        for the running step when it first reads them)."""
        if self.shards is not None:
            self.shards.gather(self, name)
        return self.modules[name]

    enc = property(lambda self: self.module("enc"))
    dec = property(lambda self: self.module("dec"))
    clf = property(lambda self: self.module("clf"))
    dis = property(lambda self: self.module("dis"))

    def end_step(self) -> None:
        """Count the step; tensor-parallel, free the weights it gathered."""
        self.step += 1
        if self.shards is not None:
            for n in list(self.shards.whole):
                self.shards.release(self, n)

    def whole_state_dicts(self) -> tuple[dict, dict]:
        """({module: state dict}, {module: Adam state dict}) with every
        tensor whole: tensor-parallel, gathered over the model group (every
        rank of it calls this)."""
        if self.shards is not None:
            return self.shards.whole_state_dicts(self)
        return ({n: m.state_dict() for n, m in self.modules.items()},
                {n: o.state_dict() for n, o in self.opts.items()})

    def load_whole_state_dicts(self, modules: dict, opts: dict) -> None:
        """Load whole state dicts (a checkpoint's) strictly; tensor-parallel,
        each rank keeps its blocks."""
        if self.shards is not None:
            self.shards.load(self, modules, opts)
            return
        for n, m in self.modules.items():
            m.load_state_dict(modules[n])
        for n, o in self.opts.items():
            o.load_state_dict(opts[n])


def init_state(hps: Hps, seed: int | None = None, device: str | torch.device = "cuda",
               rank: int = 0) -> TrainState:
    """Seeded modules (params.init_modules, the same on every rank) on
    ``device`` and a generator there seeded from the same seed and the
    rank (TrainState.reseed)."""
    seed = hps.seed if seed is None else seed
    mods = {n: m.to(device) for n, m in init_modules(hps, seed, MODULES).items()}
    state = TrainState(hps, mods, torch.Generator(device=torch.device(device)), seed=seed, rank=rank)
    state.reseed()
    return state


def _abs(x):
    """|x| with JAX's gradient: +1 at x == 0, where ``torch.abs`` has 0.
    Differences of binary latents are often exactly 0 (the pair term)."""
    return torch.where(x >= 0, x, -x)


def _acc(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


class Solver:
    def __init__(self, hps: Hps, check_numerics: bool = False, group=None, data_group=None):
        """``group``: the process group of a multi-process run (e.g.
        ``torch.distributed.group.WORLD``), over which each module's
        gradient is averaged; ``data_group`` (default ``group``): the ranks
        that hold one data row each, over which the collectives that read
        rows run (tensor-parallel: ``distributed.mesh_groups``). None steps
        on the whole batch alone."""
        self.hps = hps
        self.check_numerics = check_numerics
        self.group = group
        self.data_group = group if data_group is None else data_group
        self.grad_norms: dict[str, torch.Tensor] = {}  # each module's last gradient norm (before clipping)

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
        and left in ``.grad``; then one Adam step per module.
        Tensor-parallel, the masters' ``.grad`` take their blocks, and
        after the Adam step the module's gathered weights and the
        gradients are freed."""
        params = {n: list(state.modules[n].parameters()) for n in names}
        with span("solver.backward"):
            grads = iter(torch.autograd.grad(loss, [p for n in names for p in params[n]]))
        with span("solver.update"):
            mx = self.hps.max_grad_norm
            for n in names:
                gs = [next(grads) for _ in params[n]]
                if self.group is not None:  # one all_reduce a module: the mean over the ranks
                    flat = self._grad_mean(torch.cat([g.reshape(-1) for g in gs]))
                    gs = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in gs]), gs)]
                norm = torch.sqrt(sum((g * g).sum() for g in gs))
                self.grad_norms[n] = norm
                scale = torch.where(norm < mx, torch.ones_like(norm), mx / norm)
                if state.shards is None:
                    for p, g in zip(params[n], gs):
                        p.grad = g * scale
                else:
                    state.shards.set_grads(n, gs, scale)
            for n in names:
                state.opts[n].step()
                if state.shards is not None:
                    state.shards.release(state, n)

    def _grad_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """A module's flattened gradient, averaged over the ranks in place."""
        return all_reduce_mean_(flat, self.group)

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
        l_sum = (_abs(za - zb) * valid[..., None]).sum()
        count = valid.sum() * z.shape[-1]
        sep = _abs(z[:, n // 2 :] - z[:, : n - n // 2]).mean()
        if self.group is None:
            return l_sum / (count + 1e-8) + F.relu(PAIR_SEP_MARGIN - sep)
        # data-parallel: each rank's term is its share of the global masked
        # mean, and the hinge is open where the global separation is under
        # the margin, so the mean over ranks has the single-process value
        # and gradient
        world = dist.get_world_size(self.data_group)
        count_g = count.detach().clone()
        dist.all_reduce(count_g, group=self.data_group)
        sep_g = all_reduce_mean_(sep.detach().clone(), self.data_group)
        return l_sum * world / (count_g + 1e-8) + (PAIR_SEP_MARGIN - sep) * (sep_g < PAIR_SEP_MARGIN)

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
        with span("solver.forward"):
            z, z2 = self._ae_latents(state, batch, noise)
            l_rec = _abs(state.dec(z, batch["spk"]) - batch["x"]).mean()
            loss, metrics = l_rec, {"loss_rec": l_rec}
            if z2 is not None:
                l_pair = self.pair_consistency(z, z2, batch["pair_dt"])
                loss = loss + h.lambda_pair * l_pair
                metrics["loss_pair"] = l_pair
        self._update(state, ("enc", "dec"), loss)
        state.end_step()
        return self._metrics(metrics)

    def step_pretrain_clf(self, state: TrainState, batch: dict, noise=None) -> dict:
        """Speaker classifier on stop-gradient (frozen encoder) latents."""
        h, noise = self.hps, self._noise(state, noise)
        with span("solver.forward"):
            with torch.no_grad():
                z = self._encode(state.enc, batch["x"], noise)
            logits = state.clf(z, train=True, noise=noise)
            l_clf = h.alpha_dis * F.cross_entropy(logits, batch["spk"])
        self._update(state, ("clf",), l_clf)
        state.end_step()
        return self._metrics({"loss_clf": l_clf, "acc_clf": _acc(logits.detach(), batch["spk"])})

    def step_train(self, state: TrainState, batch: dict, noise=None) -> dict:
        """(a) classifier step on stop-gradient latents, then (b) the
        adversarial autoencoder step against the updated classifier.

        The JAX step encodes both passes with one key: without the pair its
        two latents are the same sample, so here (a) reuses (b)'s latents;
        with the pair, (a) encodes x alone with draws of its own."""
        h, noise = self.hps, self._noise(state, noise)
        with span("solver.forward"):
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

        with span("solver.forward"):
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
        state.end_step()
        out = self._metrics(metrics)
        out["alpha"] = torch.tensor(alpha)
        return out

    # ---------------------------------------------------------- stage 2

    def _target_speakers(self, spk_real, noise):
        """Targets drawn uniformly, with replacement, from the real labels
        of the global batch (data-parallel: every rank's ``spk_real``,
        gathered over the data group; each rank draws its own rows'
        indices)."""
        n = spk_real.shape[0]
        pool = spk_real if self.group is None else all_gather_rows(spk_real, self.data_group)
        u = noise.uniform((n,), spk_real.device)
        return pool[(u * pool.shape[0]).long().clamp(max=pool.shape[0] - 1)]

    def _metrics(self, metrics: dict) -> dict:
        """Detached metrics; data-parallel, each the mean over the data
        group (one all_reduce)."""
        out = {k: v.detach() for k, v in metrics.items()}
        if self.group is None:
            return out
        vals = all_reduce_mean_(torch.stack([v.float() for v in out.values()]), self.data_group)
        return dict(zip(out, vals.unbind()))

    def step_patch_d(self, state: TrainState, batch: dict, noise=None) -> dict:
        """WGAN-GP critic step: fakes are the decoder's conversions of
        ``x`` to targets drawn from ``spk_real``; the gradient penalty
        takes per-sample critic gradients (critic in eval mode) at random
        mixes of real and fake."""
        h, noise = self.hps, self._noise(state, noise)
        with span("solver.forward"):
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
            with span("solver.penalty_grad"):
                (g_int,) = torch.autograd.grad(p_hat.mean(dim=(1, 2)).sum(), x_hat, create_graph=True)
            gnorm = torch.sqrt((g_int * g_int).sum(dim=(1, 2)) + 1e-12)
            gp = ((gnorm - 1.0) ** 2).mean()
            l_cls = F.cross_entropy(cls_real, spk_real)
            loss = h.beta_dis * (-w_dist) + h.lambda_ * gp + h.beta_clf * l_cls
        self._update(state, ("dis",), loss)
        state.end_step()
        return self._metrics({"loss_d": loss, "w_dist": w_dist, "grad_penalty": gp, "loss_d_cls": l_cls,
                              "acc_d_cls": _acc(cls_real.detach(), spk_real)})

    def step_patch_g(self, state: TrainState, batch: dict, noise=None) -> dict:
        """Generator (decoder) step: fool the critic and land its speaker
        head on the drawn target (+ beta_rec x a same-speaker
        reconstruction anchor when beta_rec > 0)."""
        h, noise = self.hps, self._noise(state, noise)
        with span("solver.forward"):
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
        state.end_step()
        return self._metrics({"loss_g": loss, "loss_g_adv": l_adv, "loss_g_cls": l_cls})

    # -------------------------------------------------------- orchestration

    def step_fn(self, mode: str):
        return {"pretrain_AE": self.step_pretrain_ae, "pretrain_C": self.step_pretrain_clf,
                "train": self.step_train}[mode]

    def check_finite(self, mode: str, state: TrainState, metrics: dict) -> None:
        """Raise FloatingPointError when a loss of ``metrics`` or a module's
        gradient norm of the step just taken is not finite (one wait for
        the device)."""
        named = {**{f"loss {k}": v for k, v in metrics.items()},
                 **{f"gradient norm of {n}": v for n, v in self.grad_norms.items()}}
        dev = state.device
        finite = torch.stack([torch.isfinite(torch.as_tensor(v)).all().to(dev) for v in named.values()])
        if not bool(finite.all()):
            bad = [k for k, ok in zip(named, finite.tolist()) if not ok]
            raise FloatingPointError(f"--check-numerics: phase {mode}, step {state.step}: non-finite {bad}")

    def train(self, state: TrainState, data, mode: str, iters: int, logger=None, ckpt=None,
              log_interval: int | None = None, save_interval: int | None = None,
              pairs: bool = True) -> dict:
        """One phase of ``iters`` iterations, updating ``state`` in place.
        ``data`` is a ``DeviceDataset`` (data/device_dataset.py; batches
        sampled on the device with the state's generator, the pair fields
        when ``pairs``) or an iterator of batch dicts (the
        ``SegmentLoader``, whose batches carry the pair fields it was made
        with). For patchGAN an iteration is n_critic critic steps, each on
        a batch of its own, and one generator step on the next batch. Logs
        and saves every log/save interval; returns the last iteration's
        metrics."""
        h = self.hps
        log_interval = log_interval or h.log_interval
        save_interval = save_interval or h.save_interval
        want_pairs = pairs and mode in ("pretrain_AE", "train") and h.lambda_pair > 0

        if hasattr(data, "sample_batch"):
            def draw(p):
                return data.sample_batch(state.gen, pairs=p)
        else:
            def draw(p):
                return next(data)

        def sample(p=False):
            with span("solver.sample"):
                return draw(p)

        def step(fn, batch):
            self.grad_norms.clear()  # this step's modules only
            m = fn(state, batch)
            if self.check_numerics:
                self.check_finite(mode, state, m)
            return m

        self.stamp_train_start(state, mode)
        metrics = {}
        for i in range(iters):
            if mode == "patchGAN":
                for _ in range(h.n_critic):
                    m_d = step(self.step_patch_d, sample())
                metrics = {**m_d, **step(self.step_patch_g, sample())}
            else:
                metrics = step(self.step_fn(mode), sample(want_pairs))
            if logger and (i + 1) % log_interval == 0:
                logger.log(state.step, metrics, prefix=mode)
            if ckpt and (i + 1) % save_interval == 0:
                ckpt.save(state)
        return metrics
