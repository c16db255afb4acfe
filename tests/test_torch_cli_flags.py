"""PyTorch port, the CLI's global flags (JAX cli.py ``_common``):
``--profile DIR`` writes a torch.profiler Chrome trace of training and of
conversion; ``--check-numerics`` raises FloatingPointError, naming the
phase and step, at a non-finite loss or gradient norm in training (on
either data route) and at a non-finite encoder logit in conversion, while
the same runs finish without the flag; ``--matmul-precision`` sets the
PyTorch flags its help states; every verb JAX gives them to takes them."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.convert import Converter, write_units
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.train import init_state

torch.set_num_threads(1)

HPS = Hps().replace(batch_size=2, seg_len=32, emb_size=16, spk_emb_size=8, n_speakers=6, bank_size=2,
                    bank_channels=4, conv_channels=8, n_critic=1, log_interval=1, save_interval=100)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A preprocessed corpus (4 speakers, a test split), its segment index
    and tiny hps, with --device cpu."""
    root = tmp_path_factory.mktemp("flags")
    for si, spk in enumerate(("S01", "S02", "V001", "V002")):
        for i in range(2):
            rng = np.random.default_rng(10 * si + i)
            n = 24000 + 1600 * i
            y = 0.3 * np.sin(np.arange(n) * 2 * np.pi * (180 + 40 * si) / 16000) + 0.05 * rng.standard_normal(n)
            save_wav(root / "wavs" / "train" / f"{spk}_{i}.wav", y.astype(np.float32), 16000)
    y = 0.2 * np.sin(np.arange(9000) * 0.07) + 0.05 * np.random.default_rng(99).standard_normal(9000)
    save_wav(root / "wavs" / "test" / "S09_0.wav", y.astype(np.float32), 16000)
    d = dataclasses.asdict(HPS)
    d["audio"] = dataclasses.asdict(AudioConfig())
    (root / "tiny.json").write_text(json.dumps(d))
    common = ["--hps", str(root / "tiny.json"), "--device", "cpu"]
    cli.main(["preprocess", "--corpus", str(root / "wavs"), "-dataset_path", str(root / "ds"),
              "-index_path", str(root / "idx.json"), "--n-samples", "100", *common])
    return root, common


def _train_args(root, common, ck, *extra):
    return ["train1", "-dataset_path", str(root / "ds"), "-index_path", str(root / "idx.json"),
            "-ckpt_dir", str(ck), "--iters-override", "2", *common, *extra]


@pytest.mark.parametrize("route", [[], ["--device-data"]], ids=["loader", "device_data"])
def test_check_numerics_raises_on_an_injected_nan(corpus, tmp_path, route):
    root, common = corpus
    ds = tmp_path / "ds"
    import shutil

    shutil.copytree(root / "ds", ds)
    arena = np.load(ds / "train" / "lin.npy")
    arena[:, 5] = np.nan  # one bin of every frame: every batch carries it
    np.save(ds / "train" / "lin.npy", arena)
    args = ["train1", "-dataset_path", str(ds), "-index_path", str(root / "idx.json"),
            "--iters-override", "2", *common, *route]
    with pytest.raises(FloatingPointError, match=r"phase pretrain_AE, step 1: non-finite \[.*loss loss_rec"):
        cli.main([*args, "-ckpt_dir", str(tmp_path / "ck1"), "--check-numerics"])
    out = cli.main([*args, "-ckpt_dir", str(tmp_path / "ck2")])  # unchecked: the run finishes
    assert out["step"] == 6 and np.isnan(out["phases"]["pretrain_AE"]["last"]["loss_rec"])


def test_check_numerics_passes_a_finite_run(corpus, tmp_path):
    root, common = corpus
    out = cli.main(_train_args(root, common, tmp_path / "ck", "--check-numerics"))
    assert out["step"] == 6 and all(np.isfinite(v) for v in out["phases"]["train"]["last"].values())


def test_check_numerics_in_conversion(tmp_path):
    """A non-finite encoder weight gives non-finite logits: the checked
    Converter raises, the unchecked one returns units."""
    hps, acfg = HPS, AudioConfig()
    state = init_state(hps, device="cpu")
    enc = state.enc.state_dict()
    enc = {k: (v.clone().fill_(float("nan")) if i == 0 else v) for i, (k, v) in enumerate(enc.items())}
    feats = [np.random.default_rng(0).standard_normal((70, hps.n_feat)).astype(np.float32)]
    kw = dict(gl_iters=2, device="cpu")
    with pytest.raises(FloatingPointError, match="conversion: non-finite encoder logits in batch rows \\[0\\]"):
        Converter(hps, acfg, enc, state.dec.state_dict(), check_numerics=True, **kw).encode_units(feats)
    units = Converter(hps, acfg, enc, state.dec.state_dict(), **kw).encode_units(feats)
    assert units[0].shape[0] == -(-70 // hps.downsample)
    fine = Converter(hps, acfg, state.enc.state_dict(), state.dec.state_dict(), check_numerics=True, **kw)
    assert fine.convert_features_multi(feats, [0])[0][0].shape == units[0].shape


def test_profile_writes_traces(corpus, tmp_path):
    root, common = corpus
    out = cli.main(_train_args(root, common, tmp_path / "ck", "--profile", str(tmp_path / "prof")))
    assert out["trace"] == tmp_path / "prof" / "train1.pt.trace.json"
    names = {e.get("name") for e in json.loads(out["trace"].read_text())["traceEvents"]}
    assert any("aten::" in str(n) for n in names)
    cli.main(["export", "-dataset_path", str(root / "ds"), "-ckpt_dir", str(tmp_path / "ck"),
              "--out", str(tmp_path / "b"), *common])
    cv = cli.main(["convert", "--from-export", str(tmp_path / "b"), "--from-wavs", str(root / "wavs" / "test"),
                   "-result_dir", str(tmp_path / "out"), "--gl-iters", "2", "--device", "cpu",
                   "--profile", str(tmp_path / "prof")])
    assert cv["trace"] == tmp_path / "prof" / "convert.pt.trace.json" and cv["trace"].exists()
    assert cli.main(_train_args(root, common, tmp_path / "ck2"))["trace"] is None  # no flag, no trace


@pytest.fixture
def restore_matmul_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
    torch.set_float32_matmul_precision(saved[2])


@pytest.mark.parametrize("choice,tf32,precision", [
    ("float32", False, "highest"), ("highest", False, "highest"),
    ("tensorfloat32", True, "high"), ("bfloat16", False, "medium"),
])
def test_matmul_precision_sets_the_stated_flags(tmp_path, restore_matmul_flags, choice, tf32, precision):
    assert not torch.backends.cudnn.allow_tf32  # the package's pin at import
    write_units(tmp_path / "u" / "a.txt", np.zeros((4, 8), np.int32))
    cli.main(["eval", "--units", str(tmp_path / "u"), "--matmul-precision", choice])
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.get_float32_matmul_precision() == precision
    assert torch.backends.cuda.matmul.allow_tf32 is (precision != "highest")


VERBS = {
    "preprocess": ["--corpus", "c", "-dataset_path", "d", "-index_path", "i"],
    "train1": ["-dataset_path", "d", "-index_path", "i", "-ckpt_dir", "c"],
    "train2": ["-dataset_path", "d", "-index_path", "i", "-ckpt_dir", "c"],
    "export": ["-dataset_path", "d", "-ckpt_dir", "c", "--out", "o"],
    "convert": ["-result_dir", "r"],
    "convert-single": ["-result_dir", "r", "--source", "s.wav", "--target", "V001"],
    "serve": [],
    "eval": [],
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_every_common_verb_takes_the_flags(verb):
    args = cli.build_parser().parse_args([verb, *VERBS[verb], "--profile", "p", "--check-numerics",
                                          "--matmul-precision", "tensorfloat32"])
    assert (args.profile, args.check_numerics, args.matmul_precision) == ("p", True, "tensorfloat32")
    with pytest.raises(SystemExit):  # submission has none of them, as in JAX
        cli.build_parser().parse_args(["submission", "--check-numerics"])
