"""Metrics logging (counterpart of ``zerospeech_tts_tpu/train/logger.py``;
ref Logger over tensorboardX + console prints of the losses).

JSONL (``<log_dir>/metrics.jsonl``) is the primary sink; tensorboardX is
attached only when it imports. Each call copies the step's scalars to the
host (the first copy waits for the device; the rest find it done). In a
data-parallel run only rank 0 prints and writes (the metrics it is given
are already the means over the ranks); the others only return them.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from zerospeech_tts_tpu_torch.parallel.distributed import is_primary


class Logger:
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.on = is_primary()
        self._jsonl = self._tb = None
        if not self.on:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._t0 = time.time()
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(str(self.log_dir))

    def log(self, step: int, metrics: dict, prefix: str = "") -> dict:
        names = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).cpu() for k in names])
        vals = dict(zip(names, vals.tolist()))
        if not self.on:
            return vals
        body = " ".join(f"{k}={v:.4g}" for k, v in vals.items())
        print(f"[{time.time() - self._t0:8.1f}s] {prefix} step {step}: {body}", flush=True)
        self._jsonl.write(json.dumps({"step": step, "mode": prefix, **vals}) + "\n")
        self._jsonl.flush()
        if self._tb:
            tag = f"{prefix}/" if prefix else ""
            for k, v in vals.items():
                self._tb.add_scalar(tag + k, v, step)
        return vals

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
