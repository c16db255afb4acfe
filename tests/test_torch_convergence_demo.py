"""PyTorch port, the convergence demo (tools/convergence_demo.py): its
synthetic corpus equals the JAX demo's (examples/convergence_demo.py) file
for file, bit for bit; its gates, applied to the JAX demo's report
(docs/convergence_report.json), pass as the JAX run did; and a 4-iteration
run on the CPU goes end to end and reports every key of the JAX demo's
report (no gate: 4 iterations learn nothing)."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from zerospeech_tts_tpu_torch.tools import convergence_demo

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_demo():
    spec = importlib.util.spec_from_file_location("jax_convergence_demo", REPO / "examples" / "convergence_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_equals_the_jax_demos(tmp_path):
    jax_demo = _jax_demo()
    assert jax_demo.SPEAKERS == convergence_demo.SPEAKERS and jax_demo._CLASSES == convergence_demo._CLASSES
    assert jax_demo.make_corpus(tmp_path / "jax") == convergence_demo.make_corpus(tmp_path / "port")
    ref = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.wav"))
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.wav"))
    assert got == ref and len(got) == 6 * 6 * 2 + 4 * 3 * 2
    for rel in got:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_gates_pass_the_jax_report():
    report = json.loads((REPO / "docs" / "convergence_report.json").read_text())
    gates = convergence_demo.gate_results(report, n_speakers=6)
    assert len(gates) == 7 and all(gates.values()), gates
    worse = dict(report, abx_delta=-0.01)
    assert not convergence_demo.gate_results(worse, n_speakers=6)["abx_delta > 0"]


@pytest.mark.slow  # ~110 s on one CPU thread: the flagship-width GAN steps dominate
def test_demo_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    rc = convergence_demo.main(["--cpu", "--iters", "4", "--out", str(tmp_path / "w"),
                                "--report", str(tmp_path / "report.json")])
    out = capsys.readouterr().out
    assert rc in (0, 1) and ("CONVERGENCE: PASS" in out or "CONVERGENCE: WEAK" in out)
    report = json.loads((tmp_path / "report.json").read_text())
    jax_keys = set(json.loads((REPO / "docs" / "convergence_report.json").read_text()))
    assert jax_keys <= set(report) and report["iters"] == 4 and report["device"] == "cpu"
    assert len(report["stage2_w_dist_trend"]) == 4 and report["n_test_utts"] == 24
