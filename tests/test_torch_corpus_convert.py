"""PyTorch port, corpus conversion through its CLI (``preprocess`` ->
``convert -dataset_path``) against the JAX package's
``convert_features_multi`` on the same feature arrays, in the (speaker,
utterance) name order in which the JAX package walks its h5 groups; the
units-only route with fitted buckets and a frame budget, the checkpoint
route, and the convert verb's refusals."""

import dataclasses
import json

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu import cli as jax_cli
from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.data.speaker_norm import SpeakerStats as JaxSpeakerStats
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter, load_corpus_split, read_units
from zerospeech_tts_tpu_torch.data.speaker_norm import GLOBAL_KEY, SpeakerStats
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.export import save_export
from zerospeech_tts_tpu_torch.params import init_params
from zerospeech_tts_tpu_torch.train import CheckpointManager, init_state

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
MARGIN = 1e-4  # a flipped unit must sit within this JAX logit margin
# STFT-magnitude rel-L2 of the port's PCM against JAX's; the vocoders differ
# at their edges (tests/test_torch_convert.py states the measurement).
PCM_REL_L2 = 0.25
TARGETS = ("V001", "V002")
# Test wavs in paths whose sorted (encounter) order is not the (speaker,
# utterance) order: a/T002_0, b/T001_0, b/T001_1. 64, 47 and 32 frames
# before trimming, all in one 64-frame bucket.
TEST_WAVS = {"a/T002_0": (4032, 0), "b/T001_1": (3000, 1), "b/T001_0": (2000, 2)}
NAME_ORDER = ["T001_0", "T001_1", "T002_0"]


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * seed
    y = sum(0.25 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
    y = y * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (y + 0.02 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(n_feat=129, speaker_norm=True)


@pytest.fixture(scope="module")
def params(hps):
    """Seeded flax variables ({"params": ...}) that both packages load."""
    return {k: {"params": v} for k, v in init_params(hps, seed=0).items()}


@pytest.fixture(scope="module")
def stats(hps):
    rng = np.random.default_rng(0)
    names = (GLOBAL_KEY, *TARGETS)
    mean = {s: rng.uniform(0.2, 0.5, hps.n_feat).astype(np.float32) for s in names}
    std = {s: rng.uniform(0.05, 0.2, hps.n_feat).astype(np.float32) for s in names}
    return mean, std


@pytest.fixture(scope="module")
def work(tmp_path_factory, hps, params, stats):
    """A corpus (one train wav, three test wavs) preprocessed by the port's
    CLI on the CPU, its hps file, and a bundle with seeded weights."""
    root = tmp_path_factory.mktemp("corpus_convert")
    save_wav(root / "corpus" / "train" / "unit" / "S01_0.wav", _speechlike(5000, 5), 16000)
    for rel, (n, seed) in TEST_WAVS.items():
        save_wav(root / "corpus" / "test" / f"{rel}.wav", _speechlike(n, seed), 16000)
    d = dataclasses.asdict(hps)
    d["audio"] = dataclasses.asdict(AudioConfig(**ACFG))
    (root / "hps.json").write_text(json.dumps(d))
    out = cli.main(["preprocess", "--corpus", str(root / "corpus"), "-dataset_path", str(root / "ds"),
                    "-index_path", str(root / "idx.json"), "--n-samples", "16",
                    "--hps", str(root / "hps.json"), "--device", "cpu"])
    assert out["counts"] == {"train": 1, "test": 3}
    speakers = {"S01": 0, "V001": 1, "V002": 2}
    save_export(root / "bundle", hps, AudioConfig(**ACFG), params["enc"], params["dec"], speakers,
                stats=SpeakerStats(*stats))
    return root


def _corpus_arrays(ds):
    """The test split's lin arrays in (speaker, utterance) name order, read
    straight from the arena (not through the port's convert module)."""
    index = json.loads((ds / "test" / "index.json").read_text())
    arena = np.load(ds / "test" / "lin.npy")
    rows = sorted(zip(index["speakers"], index["names"], index["starts"], index["lengths"]))
    return ([arena[s : s + n] for _, _, s, n in rows], [u for _, u, _, _ in rows],
            [spk for spk, _, _, _ in rows])


def _margin(hps, params, stats, f, spk):
    """|logit 0 - logit 1| of the JAX encoder on the features as the JAX
    feature path encodes them (normalised, rounded to bf16 on its wire)."""
    import jax.numpy as jnp

    x = jnp.asarray(JaxSpeakerStats(*stats).normalize(f, spk), jnp.bfloat16).astype(jnp.float32)
    logits = np.asarray(JaxEncoder(hps).apply(params["enc"], x[None]))[0]
    return np.abs(logits[..., 0] - logits[..., 1])


def _assert_units(u, ref, margin_fn):
    assert u.shape == ref.shape
    if (u != ref).any():
        m = margin_fn()
        assert (m[u != ref] < MARGIN).all(), m[u != ref]


@pytest.fixture(scope="module")
def jax_result(work, hps, params, stats):
    """JAX's convert_features_multi on the same arrays, at the CLI's
    bucket_frames (64) and batch 4 (one dispatch)."""
    feats, names, srcs = _corpus_arrays(work / "ds")
    conv = JaxConverter(hps, JaxAudioConfig(**ACFG), params["enc"], params["dec"], batch_size=4,
                        stats=JaxSpeakerStats(*stats), gru_impl="scan")
    units, wavs = conv.convert_features_multi(feats, [1, 2], tgt_names=list(TARGETS), src_speakers=srcs)
    return feats, names, srcs, units, wavs


def test_load_corpus_split_is_in_name_order(work):
    feats, names, srcs = load_corpus_split(work / "ds", "test")
    assert names == NAME_ORDER and srcs == ["T001", "T001", "T002"]
    index = json.loads((work / "ds" / "test" / "index.json").read_text())
    assert index["names"] != NAME_ORDER  # the index itself is in encounter order
    ref, _, _ = _corpus_arrays(work / "ds")
    for f, r in zip(feats, ref):
        np.testing.assert_array_equal(f, r)
    assert load_corpus_split(work / "ds", "test", limit=2)[1] == NAME_ORDER[:2]


def test_cli_convert_corpus_matches_jax(work, hps, params, stats, jax_result):
    feats, names, srcs, ju, jw = jax_result
    out = cli.main(["convert", "--from-export", str(work / "bundle"), "-dataset_path", str(work / "ds"),
                    "-result_dir", str(work / "port"), "--target", *TARGETS, "--gl-iters", "2",
                    "--batch-size", "4", "--device", "cpu"])
    assert out["n_utterances"] == 3 and out["n_wavs"] == 6
    assert sorted(p.stem for p in (work / "port" / "units").glob("*.txt")) == NAME_ORDER
    acfg = AudioConfig(**ACFG)
    for i, utt in enumerate(names):
        pu = read_units(work / "port" / "units" / f"{utt}.txt")
        _assert_units(pu, ju[i], lambda: _margin(hps, params, stats, feats[i], srcs[i]))
        for k, tgt in enumerate(TARGETS):
            sr, pw = scipy.io.wavfile.read(work / "port" / tgt / f"{utt}.wav")
            assert sr == 16000 and pw.dtype == np.int16 and pw.shape == jw[k][i].shape
            re, im = port_audio.stft(torch.from_numpy(pw.astype(np.float32) / 32768.0)[None], acfg)
            rj, ij = port_audio.stft(torch.from_numpy(jw[k][i].astype(np.float32) / 32768.0)[None], acfg)
            mp, mj = torch.sqrt(re * re + im * im), torch.sqrt(rj * rj + ij * ij)
            assert float(torch.linalg.norm(mp - mj) / torch.linalg.norm(mj)) < PCM_REL_L2
    for tgt in TARGETS:
        assert sorted(p.stem for p in (work / "port" / tgt).glob("*.wav")) == NAME_ORDER


def test_cli_units_only_limit_fitted_buckets(work, hps, params, stats, jax_result):
    """--units-only --limit 2 with fitted edges and a frame budget: the
    first two utterances in name order, JAX's units, no wavs, and the
    plan's statistics in the result."""
    feats, names, srcs, ju, _ = jax_result
    out = cli.main(["convert", "--from-export", str(work / "bundle"), "-dataset_path", str(work / "ds"),
                    "-result_dir", str(work / "units_only"), "--units-only", "--limit", "2",
                    "--adaptive-buckets", "2", "--bucket-cost-model", "executed",
                    "--frame-budget", "512", "--batch-size", "1", "--device", "cpu"])
    assert out["n_utterances"] == 2 and out["n_wavs"] == 0 and out["n_dispatches"] == 1
    assert set(out) >= {"bucket_edges", "padding_overhead", "executed_overhead"}
    assert sorted(p.name for p in (work / "units_only").iterdir()) == ["units"]
    assert sorted(p.stem for p in (work / "units_only" / "units").glob("*.txt")) == NAME_ORDER[:2]
    for i in range(2):
        pu = read_units(work / "units_only" / "units" / f"{names[i]}.txt")
        _assert_units(pu, ju[i], lambda: _margin(hps, params, stats, feats[i], srcs[i]))


def test_cli_convert_from_checkpoint(work, hps):
    """-dataset_path + -ckpt_dir: the latest checkpoint's weights and the
    corpus's statistics, as a Converter built from them directly."""
    state = init_state(hps, seed=3, device="cpu")
    CheckpointManager(work / "ck", hps=hps).save(state)
    cli.main(["convert", "-dataset_path", str(work / "ds"), "-ckpt_dir", str(work / "ck"),
              "--hps", str(work / "hps.json"), "-result_dir", str(work / "from_ckpt"),
              "--target", "S01", "--units-only", "--device", "cpu"])
    conv = Converter(hps, AudioConfig(**ACFG), state.enc.state_dict(), state.dec.state_dict(),
                     stats=SpeakerStats.load_corpus(work / "ds"), device="cpu")
    feats, names, srcs = load_corpus_split(work / "ds", "test")
    for utt, ref in zip(names, conv.encode_units(feats, src_speakers=srcs)):
        np.testing.assert_array_equal(read_units(work / "from_ckpt" / "units" / f"{utt}.txt"), ref)


@pytest.mark.parametrize("args, message", [
    ([], "pass -dataset_path and -ckpt_dir, or --from-export"),
    (["--from-export", "B"], "--from-export has no corpus features"),
    (["--adaptive-buckets", "0"], None),
    (["--frame-budget", "-4"], None),
])
def test_convert_refusals_match_jax(tmp_path, args, message):
    """What the JAX verb refuses, the port's refuses too (argparse errors
    exit with 2). The JAX verb reads a bundle before it finds that no
    features were named, so that case runs on the port alone."""
    argv = ["convert", "-result_dir", str(tmp_path / "o"), *args]
    mains = (cli.main,) if "--from-export" in args else (cli.main, jax_cli.main)
    for main in mains:
        with pytest.raises(SystemExit) as e:
            main(argv)
        if message:
            assert message in str(e.value)
        else:
            assert e.value.code == 2


def test_convert_refuses_mel_and_unknown_targets(work):
    """A bundle's meta.json decides its features: --feat mel against a lin
    bundle is refused (the port converts mel bundles, see
    tests/test_torch_mel.py), as is a target outside the speaker map."""
    base = ["convert", "--from-export", str(work / "bundle"), "-dataset_path", str(work / "ds"),
            "-result_dir", str(work / "refused"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="trained on lin features"):
        cli.main([*base, "--feat", "mel"])
    with pytest.raises(SystemExit, match="not in the speaker map"):
        cli.main([*base, "--target", "V009"])
    assert not (work / "refused").exists()
