"""PyTorch port, eval: the numpy metrics (bitrate, unit statistics, DTW,
ABX within and across speakers, capped and exact) give exactly the JAX
package's values on seeded units; unit stability (equal) and
reconstruction L1 (within 1e-5 relative) against JAX's on the same
features, which the test writes into an h5 file from the port corpus's own
arrays; ``eval --units`` prints JAX's report."""

import dataclasses
import json
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu import cli as jax_cli
from zerospeech_tts_tpu import eval as jax_ev
from zerospeech_tts_tpu.models import Decoder as JaxDecoder
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch import eval as port_ev
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import write_units
from zerospeech_tts_tpu_torch.data.corpus import build_corpus, load_speaker_map
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.models import Decoder, Encoder
from zerospeech_tts_tpu_torch.params import from_flax, init_params

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
RECON_REL = 1e-5  # recon L1: two f32 encoders/decoders, summed in other orders


def _seeded_units(rng, n, width=6):
    """Short binary unit sequences drawn from a small codebook, so symbols
    repeat (entropy, DTW ties) as they do in real dumps."""
    book = rng.integers(0, 2, (5, width))
    return [book[rng.integers(0, 5, int(rng.integers(2, 9)))].astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def unit_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("units")
    rng = np.random.default_rng(0)
    for i, u in enumerate(_seeded_units(rng, 12)):
        write_units(d / f"utt{i:02d}.txt", u)
    return d


def test_bitrate_and_stats_equal_jax(unit_dir):
    pu, ju = port_ev.load_unit_files(unit_dir), jax_ev.load_unit_files(unit_dir)
    assert len(pu) == len(ju) == 12
    for a, b in zip(pu, ju):
        np.testing.assert_array_equal(a, b)
    for fs in (0.1, 0.032):
        assert port_ev.unit_bitrate(unit_dir, fs) == jax_ev.unit_bitrate(unit_dir, fs)
    assert port_ev.unit_stats(unit_dir) == jax_ev.unit_stats(unit_dir)


def test_dtw_equals_jax():
    rng = np.random.default_rng(1)
    pairs = []
    for ta, tb in ((1, 1), (3, 7), (8, 8), (30, 40), (45, 30)):  # the last two: the wavefront sweep
        a, b = rng.integers(0, 2, (ta, 6)), rng.integers(0, 2, (tb, 6))
        pairs.append((a, b))
    pairs.append((rng.normal(size=(5, 6)), rng.integers(0, 2, (4, 6))))  # non-binary
    pairs.append((rng.normal(size=(40, 3)), rng.normal(size=(33, 3))))
    for a, b in pairs:
        assert port_ev.dtw_distance(a, b) == jax_ev.dtw_distance(a, b)
    np.testing.assert_array_equal(port_ev._dtw_many(pairs), jax_ev._dtw_many(pairs))


def _items(seed, n_cls=3, n_spk=3, per=3):
    rng = np.random.default_rng(seed)
    units = _seeded_units(rng, n_cls * n_spk * per)
    return [{"cls": f"c{k % n_cls}", "spk": f"s{(k // n_cls) % n_spk}", "units": u}
            for k, u in enumerate(units)]


@pytest.mark.parametrize("across", [False, True])
@pytest.mark.parametrize("cap", [None, 5])
def test_abx_equals_jax(across, cap):
    items = _items(2)
    kw = dict(across_speaker=across, max_triples_per_cell=cap)
    rep = port_ev.abx_discriminability(items, **kw)
    assert rep == jax_ev.abx_discriminability(items, **kw) and rep["n_class_pairs"] == 3


def test_cell_scoring_and_item_file_equal_jax(tmp_path, unit_dir):
    items = _items(3)
    a, b = [it["units"] for it in items[:3]], [it["units"] for it in items[3:6]]
    for x_is_a, x in ((True, a), (False, b[:2])):
        assert port_ev._cell_score_loop(a, b, x, x_is_a, port_ev.dtw_distance) == \
            jax_ev._cell_score_loop(a, b, x, x_is_a, jax_ev.dtw_distance)
    (tmp_path / "items.txt").write_text(
        "# utt start end cls spk\n" + "".join(
            f"utt{i:02d} 0 {2 + i % 3} c{i % 2} s{i % 3}\n" for i in range(12)))
    pi = port_ev.load_abx_items(tmp_path / "items.txt", unit_dir)
    ji = jax_ev.load_abx_items(tmp_path / "items.txt", unit_dir)
    assert [(x["cls"], x["spk"]) for x in pi] == [(x["cls"], x["spk"]) for x in ji]
    for x, y in zip(pi, ji):
        np.testing.assert_array_equal(x["units"], y["units"])


def test_cli_eval_units_prints_jax_report(tmp_path, unit_dir, capsys):
    items = tmp_path / "items.txt"
    items.write_text("".join(f"utt{i:02d} 0 3 c{i % 2} s{i % 2}\n" for i in range(12)))
    argv = ["eval", "--units", str(unit_dir), "--abx", str(items), "--abx-max-triples", "4"]
    capsys.readouterr()
    cli.main(argv)
    port_out = json.loads(capsys.readouterr().out)
    jax_cli.main(argv)
    assert port_out == json.loads(capsys.readouterr().out)
    assert set(port_out) == {"bitrate", "units", "abx"}


# ----------------------------------------------- model half, against JAX


@pytest.fixture(scope="module")
def model(tiny_hps):
    hps = tiny_hps.replace(n_feat=129)
    tree = init_params(hps, seed=0)
    enc_sd, dec_sd = from_flax(tree)
    enc, dec = Encoder(hps), Decoder(hps)
    enc.load_state_dict(enc_sd)
    dec.load_state_dict(dec_sd)
    port_state = SimpleNamespace(enc=enc.eval(), dec=dec.eval(), device=torch.device("cpu"))
    jax_state = SimpleNamespace(enc={"params": tree["enc"]}, dec={"params": tree["dec"]})
    solver = SimpleNamespace(encoder=JaxEncoder(hps), decoder=JaxDecoder(hps))
    return hps, port_state, jax_state, solver


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A port corpus of 2 speakers x 2 train wavs (the CPU frontend) and an
    h5 file in the JAX package's layout holding the same arrays."""
    root = tmp_path_factory.mktemp("eval_corpus")
    rng = np.random.default_rng(4)
    for spk in ("S02", "S01"):
        for i in range(2):
            n = int(rng.integers(3000, 6000))
            t = np.arange(n) / 16000
            y = 0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * rng.standard_normal(n)
            save_wav(root / "wavs" / "train" / "unit" / f"{spk}_{i}.wav", y.astype(np.float32), 16000)
    build_corpus(root / "wavs", root / "ds", AudioConfig(**ACFG), device="cpu")
    index = json.loads((root / "ds" / "train" / "index.json").read_text())
    arena = np.load(root / "ds" / "train" / "lin.npy")
    with h5py.File(root / "ds.h5", "w") as f:
        f.attrs["speakers"] = json.dumps(load_speaker_map(root / "ds"))
        for spk, utt, s, n in zip(index["speakers"], index["names"], index["starts"], index["lengths"]):
            f.create_dataset(f"train/{spk}/{utt}/lin", data=arena[s : s + n])
    return root


def test_unit_stability_equals_jax(model, corpus):
    hps, port_state, jax_state, solver = model
    kw = dict(split="train", n_utts=3, seed=1)
    rep = port_ev.unit_stability(port_state, corpus / "ds", hps, **kw)
    assert rep == jax_ev.unit_stability(solver, jax_state, corpus / "ds.h5", hps, **kw)
    assert rep["n_utterances"] == 3 and 0.0 < rep["unit_stability"] <= 1.0


def test_reconstruction_l1_equals_jax(model, corpus):
    hps, port_state, jax_state, solver = model
    kw = dict(split="train", n_segments=6, seed=2)
    rep = port_ev.reconstruction_l1(port_state, corpus / "ds", hps, **kw)
    ref = jax_ev.reconstruction_l1(solver, jax_state, corpus / "ds.h5", hps, **kw)
    assert {k: v for k, v in rep.items() if k != "recon_l1"} == \
        {k: v for k, v in ref.items() if k != "recon_l1"}
    assert abs(rep["recon_l1"] - ref["recon_l1"]) <= RECON_REL * ref["recon_l1"]


def test_cli_eval_model_metrics(tmp_path, model, corpus):
    """eval --recon --stability through the CLI: the latest checkpoint of
    -ckpt_dir on the CPU gives the library functions' reports."""
    from zerospeech_tts_tpu_torch.train import CheckpointManager, init_state

    hps = model[0]
    state = init_state(hps, seed=5, device="cpu")
    CheckpointManager(tmp_path / "ck", hps=hps).save(state)
    d = dataclasses.asdict(hps)
    d["audio"] = dataclasses.asdict(AudioConfig(**ACFG))
    (tmp_path / "hps.json").write_text(json.dumps(d))
    rep = cli.main(["eval", "--recon", "--stability", "-dataset_path", str(corpus / "ds"),
                    "-ckpt_dir", str(tmp_path / "ck"), "--hps", str(tmp_path / "hps.json"),
                    "--n-segments", "4", "--device", "cpu"])
    assert rep["stability"] == port_ev.unit_stability(state, corpus / "ds", hps)
    assert rep["reconstruction"] == port_ev.reconstruction_l1(state, corpus / "ds", hps, n_segments=4)
