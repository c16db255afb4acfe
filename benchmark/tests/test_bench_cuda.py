"""On the card: a short traced run of each cell, as the driver runs it
(skips where no CUDA card is visible)."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.core import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.manifest()["workloads"]])
def test_a_traced_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", name, "--seed", "2147483999",
                          "--seconds", "3", "--trace", "1"], capture_output=True, text=True, cwd=manifest.ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert list(res)[-1] == "checks"
