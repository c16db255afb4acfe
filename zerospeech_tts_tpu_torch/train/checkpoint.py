"""Checkpoint / resume of the PyTorch port (counterpart of
``zerospeech_tts_tpu/train/checkpoint.py``; ref Solver.save_model /
load_model, ``torch.save`` of every module and optimizer state).

One file per step, ``<dir>/step_<N>.pt``: step, train_start, the four
modules' state dicts, the four Adam states and the generator state. Keeps
the JAX manager's semantics: retention of the newest ``max_to_keep``
steps, ``latest_step``/``all_steps``/``restore(step)``, ``read_only``
sources, a saved step overwritten in place, and ``hps.json`` checked on
open against the data-space hps a checkpoint is only valid for.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path

import torch

_STEP_RE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    # data-space fields a checkpoint is only valid for
    _CRITICAL = ("speaker_norm", "n_feat", "emb_size", "enc_mode", "downsample")

    def __init__(self, ckpt_dir: str | Path, max_to_keep: int = 3, hps=None, read_only: bool = False):
        """``read_only=True`` is for restore sources (``--load_model DIR``):
        the directory must exist, and nothing in it is created or written."""
        self.path = Path(ckpt_dir).absolute()
        self.read_only = read_only
        self.max_to_keep = max_to_keep
        if read_only:
            if not self.path.is_dir():
                raise FileNotFoundError(f"checkpoint dir {self.path} does not exist")
        else:
            self.path.mkdir(parents=True, exist_ok=True)
        if hps is not None:
            self._check_or_write_hps(hps)

    def _check_or_write_hps(self, hps) -> None:
        meta = self.path / "hps.json"
        current = dataclasses.asdict(hps)
        if meta.exists():
            saved = json.loads(meta.read_text())
            diffs = {k: (saved.get(k), current.get(k)) for k in self._CRITICAL
                     if saved.get(k) != current.get(k)}
            if diffs:
                raise ValueError(
                    f"checkpoint dir {self.path} was written with different data-space hps: "
                    f"{diffs} (saved, current); restored weights would not match the current "
                    f"feature space. Use a fresh -ckpt_dir or the hps it was trained with."
                )
        elif not self.read_only:
            meta.write_text(json.dumps(current, indent=2) + "\n")

    def _file(self, step: int) -> Path:
        return self.path / f"step_{step}.pt"

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in self.path.iterdir() if (m := _STEP_RE.match(f.name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state) -> None:
        """Save at the state's step (a step that exists is overwritten),
        then drop all but the newest ``max_to_keep`` steps."""
        if self.read_only:
            raise RuntimeError(f"checkpoint dir {self.path} is read-only")
        payload = {
            "step": state.step,
            "train_start": state.train_start,
            "modules": {n: m.state_dict() for n, m in state.modules.items()},
            "opts": {n: o.state_dict() for n, o in state.opts.items()},
            "gen": state.gen.get_state(),
        }
        tmp = self._file(state.step).with_suffix(f".tmp{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, self._file(state.step))  # atomic, also over an existing step
        for old in self.all_steps()[: -self.max_to_keep]:
            self._file(old).unlink()

    def restore(self, state, step: int | None = None):
        """Load a saved step (default the latest) into ``state`` (from
        solver.init_state with the same hps), strictly: a checkpoint of
        another architecture raises."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.path}")
        if not self._file(step).exists():
            raise FileNotFoundError(f"step {step} not in {self.path} (available: {self.all_steps()})")
        payload = torch.load(self._file(step), map_location=state.device, weights_only=True)
        for n, m in state.modules.items():
            m.load_state_dict(payload["modules"][n])
        for n, o in state.opts.items():
            o.load_state_dict(payload["opts"][n])
        state.gen.set_state(payload["gen"].cpu())
        state.step = int(payload["step"])
        state.train_start = int(payload["train_start"])
        return state
