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


def _port_probe_after_pretrain_c(root, iters):
    """The port's demo through pretrain_C (seed 0), then its probe: (accuracy,
    predicted-class histogram) over the demo's 16 fixed probe batches."""
    import numpy as np

    from zerospeech_tts_tpu_torch.config import AudioConfig
    from zerospeech_tts_tpu_torch.data.corpus import build_corpus
    from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset
    from zerospeech_tts_tpu_torch.models import discretize
    from zerospeech_tts_tpu_torch.train import Solver, init_state

    hps = _demo_hps(iters)
    convergence_demo.make_corpus(root / "corpus")
    build_corpus(root / "corpus", root / "ds", AudioConfig(gl_iters=60), device="cpu")
    ds = DeviceDataset.from_corpus(root / "ds", hps, target_speakers=["V001", "V002"], device="cpu")
    sol, state = Solver(hps), init_state(hps, seed=0, device="cpu")
    sol.train(state, ds, "pretrain_AE", iters)
    sol.train(state, ds, "pretrain_C", iters // 2)
    accs, hist = [], np.zeros(6, int)
    with torch.no_grad():
        for i in range(16):
            b = ds.sample_batch(torch.Generator().manual_seed(1234 + i), pairs=False)
            pred = state.clf(discretize(state.enc(b["x"], train=False), hps.enc_mode, hps.gumbel_temp, None),
                             train=False).argmax(-1)
            accs.append(float((pred == b["spk"]).float().mean()))
            hist += np.bincount(pred.numpy(), minlength=6)
    return float(np.mean(accs)), hist


def _jax_probe_after_pretrain_c(root, iters):
    """The same through JAX's demo pieces (examples/convergence_demo.py):
    its corpus, Solver.init_state(PRNGKey(0)), train_many, and its probe."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from zerospeech_tts_tpu.config import AudioConfig, Hps
    from zerospeech_tts_tpu.data import build_corpus
    from zerospeech_tts_tpu.data.device_dataset import DeviceDataset
    from zerospeech_tts_tpu.train import Solver

    hps = Hps(**{k: getattr(_demo_hps(iters), k) for k in _DEMO_HPS})
    _jax_demo().make_corpus(root / "corpus")
    build_corpus(root / "corpus", root / "ds.h5", AudioConfig(gl_iters=60))
    ds = DeviceDataset.from_h5(root / "ds.h5", hps, target_speakers=["V001", "V002"])
    sol = Solver(hps)
    state = sol.init_state(jax.random.PRNGKey(0))
    state, _ = sol.train_many(state, ds, "pretrain_AE", iters)
    state, _ = sol.train_many(state, ds, "pretrain_C", iters // 2)

    @jax.jit
    def predict(enc, clf, x):
        z = sol._encode_latent(enc, x, jax.random.PRNGKey(0), train=False)
        return jnp.argmax(sol.classifier.apply(clf, z, train=False), -1)

    accs, hist = [], np.zeros(6, int)
    for i in range(16):
        b = ds.sample_batch(jax.random.fold_in(jax.random.PRNGKey(1234), i), pairs=False)
        pred = np.asarray(predict(state.enc, state.clf, b["x"]))
        accs.append(float((pred == np.asarray(b["spk"])).mean()))
        hist += np.bincount(pred, minlength=6)
    return float(np.mean(accs)), hist


_DEMO_HPS = ("batch_size", "seg_len", "n_feat", "emb_size", "spk_emb_size", "n_speakers", "bank_size",
             "bank_channels", "conv_channels", "lr", "lat_sched_iters", "alpha_enc", "n_critic", "beta_rec")


def _demo_hps(iters):
    from zerospeech_tts_tpu_torch.config import Hps

    return Hps(batch_size=32, seg_len=64, n_feat=513, emb_size=128, spk_emb_size=32, n_speakers=6,
               bank_size=8, bank_channels=64, conv_channels=256, lr=4e-4, lat_sched_iters=iters,
               alpha_enc=0.02, n_critic=2, beta_rec=0.2)


@pytest.mark.slow  # ~50 min: JAX's flagship-width steps take ~13 s each on the CPU
def test_classifier_probe_after_pretrain_c_reads_one_class_in_both(tmp_path):
    """Both demos (seed 0, the same corpus, pretrain_AE 200 and pretrain_C
    100 iterations, the demos' hps) leave a classifier that predicts one
    speaker for (nearly) every one of the 512 probe samples, so each probe
    reads that speaker's share of the samples, near 1/6 and on either side
    of the demo's 1.05/6 gate: the port's probe at chance is the demo's,
    not a fault of the port."""
    port_acc, port_hist = _port_probe_after_pretrain_c(tmp_path / "port", 200)
    jax_acc, jax_hist = _jax_probe_after_pretrain_c(tmp_path / "jax", 200)
    print(f"probe after pretrain_C: port {port_acc:.4f}, predicted classes {port_hist.tolist()}; "
          f"JAX {jax_acc:.4f}, predicted classes {jax_hist.tolist()}")
    for acc, hist in ((port_acc, port_hist), (jax_acc, jax_hist)):
        assert hist.max() >= 0.9 * 512 and acc < 0.25, (acc, hist)
