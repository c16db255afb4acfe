"""Metrics logging (counterpart of ``zerospeech_tts_tpu/train/logger.py``;
ref Logger over tensorboardX + console prints of the losses).

JSONL (``<log_dir>/metrics.jsonl``) is the primary sink; tensorboardX is
attached only when it imports. Each call copies the step's scalars to the
host (the first copy waits for the device; the rest find it done).
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch


class Logger:
    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
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
        self._jsonl.close()
        if self._tb:
            self._tb.close()
