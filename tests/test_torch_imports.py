"""PyTorch port, hygiene: the package never imports JAX (or flax, optax,
orbax, h5py, the JAX package), and chip_smoke.py refuses to run without a
card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import zerospeech_tts_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = [m for m in ("jax", "flax", "optax", "orbax", "h5py", "zerospeech_tts_tpu") if m in sys.modules]
need = {pkg.__name__ + "." + m for m in ("train.solver", "train.checkpoint", "train.logger",
        "data.corpus", "data.device_dataset", "models.classifier", "models.patch_discriminator",
        "eval", "submission")}
print(len(names), sorted(need - set(names)) + bad)
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO))


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.split(maxsplit=1)
    assert int(n_mods) >= 24 and bad.strip() == "[]"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    cwd = REPO
    script = REPO / "chip_smoke.py"
    if where == "alone":  # a directory holding chip_smoke.py and nothing else
        (tmp_path / "chip_smoke.py").write_bytes(script.read_bytes())
        cwd, script = tmp_path, tmp_path / "chip_smoke.py"
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
