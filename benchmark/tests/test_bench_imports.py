"""A run loads no module whose top-level name, compared whole, is
``jax``, ``jaxlib``, ``flax`` or the JAX package ``zerospeech_tts_tpu``
(the port's name begins with the JAX package's, so a prefix test would
be wrong either way); and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import run
from benchmark.core import manifest

PROBE = """
import json, sys, torch
torch.set_num_threads(1)
from benchmark import run
from benchmark.tests.tiny import tiny_cell
for name in ("convert-corpus.lin-f32", "serve-open.lin-f32", "train-patchgan.lin-f32"):
    run.run(name, 5, 0.2, False, "cpu", tiny_cell(name))
print(json.dumps({"bad": run.forbidden_modules(),
                  "port": "zerospeech_tts_tpu_torch" in sys.modules}))
"""


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "zerospeech_tts_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.x", sys)
    assert "zerospeech_tts_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "zerospeech_tts_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert run.forbidden_modules() == ["flax", "zerospeech_tts_tpu"]


def test_a_run_loads_no_jax():
    env_root = str(manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True, cwd=env_root,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": env_root})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"bad": [], "port": True}


def test_the_reference_imports_nothing_of_the_port():
    for f in (manifest.HERE / "reference").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("zerospeech_tts_tpu_torch", *run.FORBIDDEN), (f.name, n)
