"""Checkpoint / resume of the PyTorch port (counterpart of
``zerospeech_tts_tpu/train/checkpoint.py``; ref Solver.save_model /
load_model, ``torch.save`` of every module and optimizer state).

One file per step, ``<dir>/step_<N>.pt``: step, train_start, the four
modules' state dicts, the four Adam states and the generator state. Keeps
the JAX manager's semantics: retention of the newest ``max_to_keep``
steps, ``latest_step``/``all_steps``/``restore(step)``, ``read_only``
sources, a saved step overwritten in place, and ``hps.json`` checked on
open against the data-space hps a checkpoint is only valid for.

Data-parallel runs: rank 0 alone creates the directory and writes
``hps.json`` and the step files, and every rank waits at a barrier after
each save (and after the directory is set up), so no rank reads a step
before it is whole. Every rank restores the same file, as the JAX
package's restore does. The generator saved is rank 0's; on restore the
other data ranks re-derive theirs from (seed, data rank, restored step)
(``TrainState.reseed``). Tensor-parallel states are saved whole (every
rank gathers its model group's blocks, rank 0 writes: the file is the
world-1 format) and restored into their blocks (JAX restores into the
sharded template), so a checkpoint resumes under any mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from pathlib import Path

import torch

from zerospeech_tts_tpu_torch.parallel.distributed import barrier, is_primary

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
        elif is_primary():
            self.path.mkdir(parents=True, exist_ok=True)
        if hps is not None and (read_only or is_primary()):
            self._check_or_write_hps(hps)
        if not read_only:
            barrier()  # the directory and hps.json exist on every rank's return
            if hps is not None and not is_primary():
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
        elif not self.read_only and is_primary():
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
        then drop all but the newest ``max_to_keep`` steps (multi-process:
        every rank makes the whole state dicts, rank 0 writes, every rank
        waits for it)."""
        if self.read_only:
            raise RuntimeError(f"checkpoint dir {self.path} is read-only")
        modules, opts = state.whole_state_dicts()
        if is_primary():
            self._write(state, modules, opts)
        barrier()

    def _write(self, state, modules: dict, opts: dict) -> None:
        payload = {
            "step": state.step,
            "train_start": state.train_start,
            "modules": modules,
            "opts": opts,
            "gen": state.gen.get_state(),
        }
        tmp = self._file(state.step).with_suffix(f".tmp{os.getpid()}")
        torch.save(payload, tmp)
        os.replace(tmp, self._file(state.step))  # atomic, also over an existing step
        for old in self.all_steps()[: -self.max_to_keep]:
            self._file(old).unlink()

    def restore(self, state, step: int | None = None):
        """Load a saved step (default the latest) into ``state`` (from
        solver.init_state with the same hps, placed or not), strictly: a
        checkpoint of another architecture raises."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.path}")
        if not self._file(step).exists():
            raise FileNotFoundError(f"step {step} not in {self.path} (available: {self.all_steps()})")
        payload = torch.load(self._file(step), map_location=state.device, weights_only=True)
        state.load_whole_state_dicts(payload["modules"], payload["opts"])
        state.step = int(payload["step"])
        state.train_start = int(payload["train_start"])
        if state.rank == 0:
            state.gen.set_state(payload["gen"].cpu())
        else:  # the saved generator is rank 0's
            state.reseed(state.step)
        return state
