"""Driver ``train``: whole iterations of one training phase through
``Solver.train(state, DeviceDataset, phase, 1)``, from an arena made on
the device.

Traffic parameters: ``phase`` (the reference follows ``patchGAN``),
``utterances`` of ``duration_s``'s log-normal (their frames make the
arena: 1 + samples // hop each, random normal frames drawn on the device
from the seed), the speakers the configuration has (balanced, in a seeded
order; its targets are the reals of stage 2), ``warm_iters`` and
``trace_iters``. Batch and segment length are the configuration's.

Set-up builds one training state from the benchmark's weights, drives it
through its first iteration with the window's own call and feed, and
hands that same state to the window. ``train_steps_per_s`` is the
optimizer steps (``state.step``) of the whole iterations in the window
over the time to the synchronised end of the last. ``correct`` holds the
first iteration against the plain reference started from the same
weights and generator state: each step's loss, each module's first
gradient as Adam got it (from its state after that step) and each
leaf's change over the iteration.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark.core import counts, traffic, weights
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.precision import CONTROL_OF, ROUNDINGS, exact

STEPPED = ("dis", "dec")  # the modules a patchGAN iteration steps


class Cell:
    def __init__(self, c: dict, seed: int, device):
        self.c, self.seed, self.device = c, seed, device
        self.tr, cfg = c["traffic"], c["config"]
        self.hp, self.ac = cfg["hps"], cfg["audio"]
        self.targets = list(cfg["targets"])
        self.attempted = self.failed = 0
        self.flops = None
        if self.tr["phase"] != "patchGAN":
            raise ValueError(f"the reference follows patchGAN only, not {self.tr['phase']!r}")

    def _arena(self) -> dict:
        """The arena and its index tensors on the device, from the seed."""
        tr, hp = self.tr, self.hp
        g = traffic.rng(self.seed, 5)
        secs = g.permutation(traffic.durations(tr["duration_s"], tr["utterances"]))
        lens = 1 + np.round(secs * self.ac["sr"]).astype(np.int64) // self.ac["hop_length"]
        spk = traffic.balanced(len(lens), hp["n_speakers"], g)
        real = spk >= hp["n_speakers"] - len(self.targets)  # the targets hold the last ids
        gen = torch.Generator(device=self.device).manual_seed(int(self.seed) + (1 << 40))  # not the weights' stream
        t = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return {
            "arena": torch.randn(int(lens.sum()), hp["n_feat"], generator=gen, device=self.device),
            "starts": t(np.concatenate([[0], np.cumsum(lens)[:-1]])),
            "lens": t(lens),
            "spk": t(spk.astype(np.int64)),
            "real_w": t(real.astype(np.float32)),
        }

    def setup(self) -> None:
        from zerospeech_tts_tpu_torch.config import Hps
        from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset
        from zerospeech_tts_tpu_torch.params import make_module
        from zerospeech_tts_tpu_torch.train import Solver, TrainState

        hps = Hps.from_dict(self.hp)
        self.data = self._arena()
        self.params = weights.make_params(self.hp, ref_model.MODULES, self.seed, self.device)
        mods = {}
        for name in ref_model.MODULES:
            with torch.device("meta"):
                m = make_module(name, hps)
            mods[name] = m.to_empty(device=self.device)
            mods[name].load_state_dict(self.params[name])
        self.state = TrainState(hps, mods, torch.Generator(device=self.device), seed=self.seed)
        self.state.reseed()
        self.gen0 = self.state.gen.get_state().clone()
        self.ds = DeviceDataset(hps=hps, **self.data)
        self.solver = Solver(hps)
        self._first_iteration()
        if self.tr["warm_iters"]:
            self.solver.train(self.state, self.ds, self.tr["phase"], self.tr["warm_iters"])

    def _first_iteration(self) -> None:
        """The window's call for one iteration, recording each step's loss
        and each stepped module's first gradient (Adam's first moment after
        its first step over 1 - beta1), then the parameters after it."""
        solver, state = self.solver, self.state
        self.losses, self.first_grads, hooks = [], {}, []
        for name, key in (("step_patch_d", "loss_d"), ("step_patch_g", "loss_g")):
            def rec(st, batch, _fn=getattr(solver, name), _key=key):
                m = _fn(st, batch)
                self.losses.append(m[_key])
                return m
            setattr(solver, name, rec)
        for name in STEPPED:
            opt, mod = state.opts[name], state.modules[name]

            def first(o, args, kwargs, _name=name, _mod=mod):
                if _name not in self.first_grads:
                    self.first_grads[_name] = {  # no state: no step was taken
                        k: o.state[p].get("exp_avg", torch.zeros_like(p)) / (1.0 - self.hp["beta1"])
                        for k, p in _mod.named_parameters()}
            hooks.append(opt.register_step_post_hook(first))
        try:
            solver.train(state, self.ds, self.tr["phase"], 1)
        finally:
            for h in hooks:
                h.remove()
            del solver.step_patch_d, solver.step_patch_g
        self.losses = [float(v) for v in self.losses]
        self.after = {n: {k: p.detach().clone() for k, p in state.modules[n].named_parameters()} for n in STEPPED}

    def _iterate(self, n: int) -> None:
        with torch.profiler.record_function("bench.iteration"):
            self.solver.train(self.state, self.ds, self.tr["phase"], n)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> dict:
        step0, t0 = self.state.step, time.perf_counter()
        while True:
            self._iterate(1)
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        steps = self.state.step - step0
        self.attempted = steps
        return {"train_steps_per_s": steps / elapsed, "units": steps, "elapsed": elapsed}

    def tail(self) -> int:
        step0 = self.state.step
        self._iterate(self.tr["trace_iters"])
        return self.state.step - step0

    def units_of(self, steps: int) -> int:
        return steps

    def release(self) -> None:
        del self.state, self.solver, self.ds
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------ the comparison

    def _reference(self, q=exact, half: bool = False, flops: bool = False):
        gen = torch.Generator(device=self.device)
        gen.set_state(self.gen0)
        ref = ref_train.Trainer(self.hp, self.params, gen, q, half)
        if flops:
            from torch.utils.flop_counter import FlopCounterMode

            with FlopCounterMode(display=False) as fc:
                ref.iteration(self.data)
            self.flops = fc.get_total_flops()
        else:
            ref.iteration(self.data)
        return ref

    def readings(self, losses, first_grads, after, ref) -> dict:
        """The three numbers compared, of one side against the reference:
        the largest relative gap of a step's loss; the worst leaf's gap
        between the norms of the first gradients; and the worst leaf's gap
        between the norms of the change over the iteration, leaves whose
        reference gradient is under a thousandth of the median leaf's left
        out. A leaf's gap is against the larger of the reference's norm of
        it and of the median leaf."""
        loss_gap = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, ref.losses))
        if len(losses) != len(ref.losses):
            loss_gap = 1.0
        g_p = {(n, k): float(v.norm()) for n in STEPPED for k, v in first_grads.get(n, {}).items()}
        g_r = {(n, k): float(v.norm()) for n in STEPPED for k, v in ref.first_grads[n].items()}
        d_p = {(n, k): float((after[n][k] - self.params[n][k]).norm()) for n in STEPPED for k in after[n]}
        d_r = {(n, k): float((ref.p[n][k].detach() - self.params[n][k]).norm()) for n in STEPPED for k in after[n]}
        med_g = statistics.median(g_r.values())
        moved = [key for key in d_r if g_r[key] >= 1e-3 * med_g]
        med_d = statistics.median(d_r[key] for key in moved)

        def worst(p, r, keys, med):
            return max(abs(p.get(key, 0.0) - r[key]) / max(r[key], med) for key in keys)

        return {"loss_gap": loss_gap, "grad_gap": worst(g_p, g_r, g_r, med_g),
                "change_gap": worst(d_p, d_r, moved, med_d)}

    def check(self, flops: bool = False) -> dict:
        return self.readings(self.losses, self.first_grads, self.after, self._reference(flops=flops))

    def control(self, which: str = "precision") -> dict:
        """A side put in the program's place, judged against the reference:
        ``precision``, the reference one precision below the
        configuration's; ``half_batch``, the reference on half of each
        batch (the mean over the rest)."""
        side = (self._reference(ROUNDINGS[CONTROL_OF[self.c["config"]["dtypes"]["decoder"]]]) if which == "precision"
                else self._reference(half=True))
        after = {n: {k: v.detach() for k, v in side.p[n].items()} for n in STEPPED}
        return self.readings(side.losses, side.first_grads, after, self._reference())

    # ------------------------------------------------ for the metrics

    def least_s(self, kernel: str) -> float:
        """Least time of ``kernel``'s work in one optimizer step, the mean
        over an iteration: every step runs the encoder's two scans over the
        latent frames and the decoder's scan; the generator step also the
        decoder's backward pass."""
        hp = self.hp
        b, t, zl = hp["batch_size"], hp["seg_len"], hp["seg_len"] // hp["downsample"]
        steps = hp["n_critic"] + 1
        if kernel == "gru_fwd":
            per = 2 * counts.bound_s(*counts.gru_fwd(b, zl, hp["emb_size"] // 2)) + counts.bound_s(
                *counts.gru_fwd(b, t, hp["conv_channels"]))
            return per
        if kernel == "gru_bwd":
            return counts.bound_s(*counts.gru_bwd(b, t, hp["conv_channels"])) / steps
        raise ValueError(f"no least work for {kernel!r} in training")

    def flop_s(self) -> float | None:
        """Least time of one optimizer step at the float32 peak: the
        operations of the reference's first iteration (FlopCounterMode)
        over its steps."""
        if self.flops is None:
            return None
        return self.flops / (self.hp["n_critic"] + 1) / counts.PEAK_FLOPS["float32"]
