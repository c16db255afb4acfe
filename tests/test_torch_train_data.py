"""PyTorch port, the training data and loop: build_corpus against the JAX
build_corpus on the same wav corpus, the on-device sampler's invariants,
checkpoint resume (bit for bit on the CPU) and its guards, and the CLI
``preprocess -> train1 -> train2 -> export -> convert`` at tiny geometry
with ``--device cpu``."""

import dataclasses
import json

import h5py
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.data.corpus import build_corpus as jax_build_corpus
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.data.corpus import build_corpus, load_split, speaker_of
from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset, check_speaker_ids
from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.train import CheckpointManager, Solver, init_state

torch.set_num_threads(1)


def _write_corpus(root, speakers=("S01", "S02", "V001"), n_utts=2, seconds=1.0):
    """ZeroSpeech layout: train/unit/<spk>_<i>.wav, train/voice/V*.wav, test/."""
    for si, spk in enumerate(speakers):
        for i in range(n_utts):
            n = int(16000 * seconds) + 1600 * i
            t = np.arange(n) / 16000
            rng = np.random.default_rng(10 * si + i)
            y = 0.3 * np.sin(2 * np.pi * (180 + 40 * si + 15 * i) * t) + 0.05 * rng.standard_normal(n)
            sub = "voice" if spk.startswith("V") else "unit"
            save_wav(root / "train" / sub / f"{spk}_{i}.wav", y.astype(np.float32), 16000)
    # noise-rich, as every wav here: a pure tone's near-floor bins differ
    # by up to 4.4e-4 between the two f32 frontends (test_torch_frontend.py)
    y = 0.2 * np.sin(np.arange(12000) * 0.07) + 0.05 * np.random.default_rng(99).standard_normal(12000)
    save_wav(root / "test" / "S09_0.wav", y.astype(np.float32), 16000)


def test_build_corpus_matches_jax(tmp_path):
    """Features within 1e-4 (the frontend's bar; both sides f32 on the CPU)
    and stats within 1e-4 absolute (means of features that differ by up to
    1e-4); the same speaker map and utterance order. The lin DC bin is
    held to 2e-3 instead: the window sum of a zero-mean signal cancels there
    to near the 1e-5 floor, where JAX's FFT and the port's DFT round apart
    by up to 2.3e-4 (measured; the pure-tone bar in test_torch_frontend.py)."""
    _write_corpus(tmp_path / "corpus")
    cfg = AudioConfig()
    jax_build_corpus(tmp_path / "corpus", tmp_path / "ref.h5", cfg)
    out = build_corpus(tmp_path / "corpus", tmp_path / "ds", cfg, device="cpu")
    assert out["counts"] == {"train": 6, "test": 1}
    with h5py.File(tmp_path / "ref.h5", "r") as f:
        assert json.loads(f.attrs["speakers"]) == out["speakers"]
        for split in ("train", "test"):
            for feat in ("mel", "lin"):
                arena, index = load_split(tmp_path / "ds", split, feat)
                for name, spk, s0, n in zip(index["names"], index["speakers"], index["starts"],
                                            index["lengths"]):
                    ref = f[f"{split}/{spk}/{name}/{feat}"][:]
                    assert ref.shape == (n, arena.shape[1])
                    got = np.asarray(arena[s0 : s0 + n])
                    dc = 1 if feat == "lin" else 0
                    np.testing.assert_allclose(got[:, dc:], ref[:, dc:], atol=1e-4, rtol=0)
                    np.testing.assert_allclose(got[:, :dc], ref[:, :dc], atol=2e-3, rtol=0)
        for feat in ("mel", "lin"):
            st = SpeakerStats.load_corpus(tmp_path / "ds", feat)
            assert set(st.mean) == set(f["stats"])
            for spk in f["stats"]:
                np.testing.assert_allclose(st.mean[spk], f[f"stats/{spk}/{feat}_mean"][:], atol=1e-4)
                np.testing.assert_allclose(
                    st.std[spk], np.maximum(f[f"stats/{spk}/{feat}_std"][:], 1e-4), atol=1e-4)
    assert speaker_of(tmp_path / "x" / "V001_3.wav") == "V001"
    assert speaker_of(tmp_path / "S07" / "take1.wav") == "S07"


def _frame_corpus(root, lens, spks, n_feat):
    """A corpus dir whose feature value is the global frame index, so a
    segment's first value locates it."""
    root.mkdir(parents=True, exist_ok=True)
    total = sum(lens)
    arena = np.tile(np.arange(total, dtype=np.float32)[:, None], (1, n_feat))
    (root / "train").mkdir()
    np.save(root / "train" / "lin.npy", arena)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).tolist()
    (root / "train" / "index.json").write_text(json.dumps(
        {"names": [f"u{i}" for i in range(len(lens))], "speakers": spks, "starts": starts,
         "lengths": list(lens)}))
    names = sorted(set(spks), key=spks.index)
    (root / "speakers.json").write_text(json.dumps({s: i for i, s in enumerate(names)}))
    return starts


def test_sampler_invariants(tmp_path, tiny_hps):
    """Segments lie inside their utterance, pair offsets are on the
    downsample grid within +-seg_len and point into the same utterance,
    reals come only from the targets; too-short utterances are skipped."""
    h = tiny_hps.replace(batch_size=256, seg_len=16)
    lens = [40, 17, 90, 16, 60]  # the 16-frame one has no valid segment (needs seg_len + 1)
    spks = ["S01", "S01", "S02", "V001", "V001"]
    starts = _frame_corpus(tmp_path / "ds", lens, spks, h.n_feat)
    ds = DeviceDataset.from_corpus(tmp_path / "ds", h, target_speakers=["V001"], device="cpu")
    assert ds.lens.tolist() == [40, 17, 90, 60]
    b = ds.sample_batch(torch.Generator().manual_seed(0))
    orig = [0, 1, 2, 4]  # arena utterance -> corpus utterance
    for x, dt, x2 in zip(b["x"], b["pair_dt"], b["x2"]):
        v0 = int(x[0, 0])
        u = max(i for i in orig if starts[i] <= v0)
        assert v0 + h.seg_len <= starts[u] + lens[u]  # inside its utterance
        assert int(dt) % h.downsample == 0 and abs(int(dt)) <= h.seg_len
        w0 = int(x2[0, 0])
        assert w0 - v0 == int(dt) and starts[u] <= w0 and w0 + h.seg_len <= starts[u] + lens[u]
        assert torch.equal(x[:, 0], torch.arange(v0, v0 + h.seg_len, dtype=torch.float32))
    assert set(b["spk_real"].tolist()) == {2}  # V001 only
    assert (b["pair_dt"] != 0).any() and b["x"].shape == (256, 16, h.n_feat)
    for xr in b["x_real"]:
        assert int(xr[0, 0]) >= starts[4]
    assert "x2" not in ds.sample_batch(torch.Generator().manual_seed(1), pairs=False)
    # no targets named: every utterance counts as real
    ds_all = DeviceDataset.from_corpus(tmp_path / "ds", h, device="cpu")
    assert len(set(ds_all.sample_batch(torch.Generator().manual_seed(2))["spk_real"].tolist())) == 3


def test_dataset_guards(tmp_path, tiny_hps):
    _frame_corpus(tmp_path / "ds", [40, 40], ["S01", "S02"], tiny_hps.n_feat)
    with pytest.raises(ValueError, match="n_feat"):
        DeviceDataset.from_corpus(tmp_path / "ds", tiny_hps.replace(n_feat=7), device="cpu")
    with pytest.raises(ValueError, match="n_speakers"):
        check_speaker_ids({"a": 0, "b": 4}, tiny_hps)


@pytest.fixture()
def small(tmp_path, tiny_hps):
    h = tiny_hps.replace(seg_len=16, batch_size=2, log_interval=1, save_interval=2, n_critic=2)
    _frame_corpus(tmp_path / "ds", [40, 50, 45], ["S01", "S02", "V001"], h.n_feat)
    return h, DeviceDataset.from_corpus(tmp_path / "ds", h, device="cpu")


def test_checkpoint_resume_is_bit_exact(tmp_path, small):
    """2 steps + save + restore into a fresh state + 2 steps equals 4
    straight steps, bit for bit (generator and Adam state included); a
    saved step is overwritten; retention keeps the newest steps."""
    h, ds = small
    sol = Solver(h)
    straight = init_state(h, device="cpu")
    sol.train(straight, ds, "pretrain_AE", 2)
    sol.train(straight, ds, "train", 2)

    first = init_state(h, device="cpu")
    ck = CheckpointManager(tmp_path / "ck", max_to_keep=2, hps=h)
    sol.train(first, ds, "pretrain_AE", 2, ckpt=ck)  # saves at step 2
    assert ck.all_steps() == [2]
    resumed = ck.restore(init_state(h, seed=7, device="cpu"))
    assert resumed.step == 2
    sol.train(resumed, ds, "train", 2, ckpt=ck)
    assert resumed.train_start == straight.train_start == 2
    for n in straight.modules:
        for (k, a), b in zip(straight.modules[n].state_dict().items(), resumed.modules[n].state_dict().values()):
            assert torch.equal(a, b), (n, k)
    sol.train(resumed, ds, "patchGAN", 2, ckpt=ck)  # steps 7, 10 (n_critic + 1 each)
    assert resumed.step == 10 and ck.all_steps() == [4, 10]
    ck.save(resumed)  # overwrite in place
    assert ck.latest_step() == 10
    with pytest.raises(FileNotFoundError, match="available"):
        ck.restore(init_state(h, device="cpu"), step=3)


def test_checkpoint_guards(tmp_path, tiny_hps):
    CheckpointManager(tmp_path / "ck", hps=tiny_hps)
    with pytest.raises(ValueError, match="data-space hps"):
        CheckpointManager(tmp_path / "ck", hps=tiny_hps.replace(n_feat=777))
    CheckpointManager(tmp_path / "ck", hps=tiny_hps.replace(lr=1.0))  # not a critical field
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "nope", read_only=True)
    assert not (tmp_path / "nope").exists()
    (tmp_path / "src").mkdir()
    ro = CheckpointManager(tmp_path / "src", hps=tiny_hps, read_only=True)
    assert not (tmp_path / "src" / "hps.json").exists()  # a pure load writes nothing
    with pytest.raises(RuntimeError, match="read-only"):
        ro.save(init_state(tiny_hps, device="cpu"))
    ck = CheckpointManager(tmp_path / "arch")
    ck.save(init_state(tiny_hps, device="cpu"))
    with pytest.raises(RuntimeError):  # another architecture does not load
        ck.restore(init_state(tiny_hps.replace(emb_size=64), device="cpu"))


def test_cli_training_pipeline_cpu(tmp_path):
    """preprocess -> train1 (3 phases) -> resumed train1 -> train2 (one GAN
    cycle) -> export -> convert, all with --device cpu at tiny geometry."""
    _write_corpus(tmp_path / "corpus", speakers=("S01", "S02", "V001", "V002"), seconds=1.5)
    hps = Hps().replace(batch_size=2, seg_len=32, emb_size=16, spk_emb_size=8, n_speakers=6,
                        bank_size=2, bank_channels=4, conv_channels=8, n_critic=2,
                        log_interval=1, save_interval=100)
    cfg = json.loads(json.dumps(dataclasses.asdict(hps)))
    cfg["audio"] = dataclasses.asdict(AudioConfig())
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    ds, ck = str(tmp_path / "ds"), str(tmp_path / "ck")
    common = ["--hps", str(tmp_path / "tiny.json"), "--device", "cpu"]
    idx = ["-index_path", str(tmp_path / "idx.json")]
    pre = cli.main(["preprocess", "--corpus", str(tmp_path / "corpus"), "-dataset_path", ds, *idx,
                    "--n-samples", "64", *common])
    assert pre["counts"] == {"train": 8, "test": 1} and pre["index_entries"] == 64
    train = [*common, *idx, "--device-data"]  # the arena on the device (the loader: test_torch_loader.py)
    r1 = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "2", *train])
    assert r1["step"] == 6 and set(r1["phases"]) == {"pretrain_AE", "pretrain_C", "train"}
    assert r1["resumed_from"] is None
    r1b = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "3", *train])
    assert r1b["resumed_from"] == 6 and r1b["step"] == 9 and set(r1b["phases"]) == {"train"}
    r2 = cli.main(["train2", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "1",
                   "--targets", "V001", "V002", *train])
    assert r2["step"] == 9 + hps.n_critic + 1
    for p in r2["state"].enc.parameters():
        assert torch.isfinite(p).all()
    lines = [json.loads(x) for x in (tmp_path / "ck" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert {x["mode"] for x in lines} == {"pretrain_AE", "pretrain_C", "train", "patchGAN"}
    assert all(np.isfinite(v) for x in lines for k, v in x.items() if k != "mode")
    ex = cli.main(["export", "-dataset_path", ds, "-ckpt_dir", ck, "--out", str(tmp_path / "b"), *common])
    assert ex["step"] == r2["step"]
    out = cli.main(["convert", "--from-export", str(tmp_path / "b"), "--from-wavs",
                    str(tmp_path / "corpus" / "test"), "-result_dir", str(tmp_path / "out"),
                    "--gl-iters", "2", "--device", "cpu"])
    assert out["n_wavs"] == 2
    sr, pcm = scipy.io.wavfile.read(tmp_path / "out" / "V002" / "S09_0.wav")
    assert sr == 16000 and pcm.dtype == np.int16 and len(pcm) > 0
    with pytest.raises(SystemExit):  # stage 2 needs a stage-1 checkpoint
        cli.main(["train2", "-dataset_path", ds, "-ckpt_dir", str(tmp_path / "empty"), *train])
