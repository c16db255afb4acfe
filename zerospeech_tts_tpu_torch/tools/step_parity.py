"""One training step on the card against the CPU, from the same state and
the same draws, at flagship width.

    python -m zerospeech_tts_tpu_torch.tools.step_parity [--seeds 0 1 ...] [--out FILE]

For each seed: modules initialised from the seed (params.init_modules), a
batch of 4 random segments with the same-utterance pair, and every random
draw (dropout masks, Gumbel noise) from one CPU generator seeded from the
seed, moved to each device. A ``pretrain_AE`` step and a ``train`` step
(at alpha = alpha_enc / 2) run on the card and on the CPU; the result is
each loss's relative difference and each module's gradient rel-L2.

Both sides compute in f32. The steps hold hard decisions (the leaky-relu
slope at 0, the straight-through argmax of the binary units): an element
within f32 rounding of a decision can fall on different sides on the two
devices and move a module's gradient by a discrete amount, while the rest
agree to ~1e-6. So the card run records its decisions and the CPU run
replays them (:class:`DecisionReplay`); the report counts the CPU's own
decisions that differed (``flips``). ``--no-replay`` compares the two
runs' own decisions.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

STEPS = ("step_pretrain_ae", "step_train")


class DecisionReplay(TorchFunctionMode):
    """Records a run's hard decisions (``F.leaky_relu``'s slope, argmax)
    in call order, or replays a recorded tape in a second run of the same
    program, counting where its own decisions differ. A recording run
    computes with the ops themselves and only notes their decisions."""

    def __init__(self, tape: list | None = None):
        super().__init__()
        self.record = tape is None
        self.tape = [] if tape is None else list(tape)
        self.flips = self.decisions = 0

    def _take(self, own: torch.Tensor) -> torch.Tensor:
        if self.record:
            self.tape.append(own.detach().cpu())
            return own
        ref = self.tape.pop(0).to(own.device)
        self.flips += int((ref != own).sum())
        self.decisions += own.numel()
        return ref

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.leaky_relu:
            x = args[0]
            if self.record:
                self._take(x > 0)
                return func(*args, **kwargs)
            ns = args[1] if len(args) > 1 else kwargs.get("negative_slope", 0.01)
            return torch.where(self._take(x > 0), x, x * ns)
        if func in (torch.argmax, torch.Tensor.argmax):
            return self._take(func(*args, **kwargs))
        return func(*args, **kwargs)


def card_vs_cpu(seed: int = 0, replay: bool = True) -> dict:
    """{step: {"loss_rel": {name: x}, "grad_rel_l2": {module: x},
    "modules": [...], "flips": n, "decisions": n}}."""
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.models.layers import Noise
    from zerospeech_tts_tpu_torch.params import MODULES, init_modules, make_module
    from zerospeech_tts_tpu_torch.train.solver import Solver, TrainState

    hps, _ = load_configs(DEFAULT_HPS_PATH)
    hps = hps.replace(batch_size=4)
    sds = {n: m.state_dict() for n, m in init_modules(hps, seed, MODULES).items()}
    rng = np.random.default_rng(seed)
    b, ds = hps.batch_size, hps.downsample
    feats = lambda: rng.standard_normal((b, hps.seg_len, hps.n_feat)).astype(np.float32)  # noqa: E731
    batch = {"x": feats(), "spk": rng.integers(0, hps.n_speakers, b), "x2": feats(),
             "pair_dt": ds * rng.integers(-(hps.seg_len // ds) // 2, (hps.seg_len // ds) // 2 + 1, b)}
    report = {}
    for step in STEPS:
        got, tape = {}, None
        for device in ("cuda", "cpu"):
            mods = {n: make_module(n, hps) for n in MODULES}
            for n, m in mods.items():
                m.load_state_dict(sds[n])
                m.to(device)
            st = TrainState(hps, mods, torch.Generator(device=device))
            st.train_start, st.step = 0, hps.lat_sched_iters // 2  # alpha = alpha_enc / 2
            tb = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
            mode = DecisionReplay(tape if replay else None)
            with mode:
                metrics = getattr(Solver(hps), step)(st, tb, noise=Noise(torch.Generator().manual_seed(seed + 1)))
            tape = mode.tape
            grads = {n: torch.cat([p.grad.flatten() for p in m.parameters()]).cpu()
                     for n, m in mods.items() if next(m.parameters()).grad is not None}
            got[device] = ({k: float(v) for k, v in metrics.items()}, grads)
        (m_c, g_c), (m_p, g_p) = got["cuda"], got["cpu"]
        report[step] = dict(
            loss_rel={k: abs(m_c[k] - m_p[k]) / max(abs(m_p[k]), 1e-12) for k in m_p if k != "acc_clf"},
            grad_rel_l2={n: (torch.linalg.norm(g_c[n] - g) / torch.linalg.norm(g)).item()
                         for n, g in g_p.items()},
            modules=sorted(g_c), flips=mode.flips, decisions=mode.decisions)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--out", default="build/step_parity/parity.json")
    ap.add_argument("--no-replay", action="store_true", help="each run keeps its own decisions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_parity needs a CUDA card")
    res = {}
    for seed in args.seeds:
        res[seed] = card_vs_cpu(seed, replay=not args.no_replay)
        print(f"seed {seed}: " + " | ".join(
            f"{s[5:]} grad rel-L2 " + " ".join(f"{n}={v:.2e}" for n, v in r["grad_rel_l2"].items())
            + f" loss rel<={max(r['loss_rel'].values()):.1e} flips {r['flips']}/{r['decisions']}"
            for s, r in res[seed].items()), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()
