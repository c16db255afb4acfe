"""PyTorch port, sharded and native preprocess: ``preprocess --shard I/N``
then ``--merge-shards``, and ``--workers 2``, give the corpus of a
single-process build (arenas and index equal, stats within 1e-10 (float64
sums reassociated), the speaker map in sorted-name order, as JAX's
``merge_corpus_shards`` assigns it) and the same segment index; the merge's
refusals; the native wav decoder (data/native.py) equals the port's wavio
path."""

import dataclasses
import json

import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.data.corpus import build_corpus as jax_build_corpus
from zerospeech_tts_tpu.data.corpus import merge_corpus_shards as jax_merge_corpus_shards
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, AudioConfig, load_configs
from zerospeech_tts_tpu_torch.data import native
from zerospeech_tts_tpu_torch.data.corpus import FEATS, build_corpus, merge_corpus_shards
from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, save_wav, trim_silence
from zerospeech_tts_tpu_torch.ops.build import BUILD_DIR

torch.set_num_threads(1)


def _write_corpus(root):
    """5 speakers in three folders, one wav too short for a frame (skipped,
    its speaker still mapped), a test split."""
    for si, spk in enumerate(("V002", "S03", "S01", "V001", "S02")):
        for i in range(2 + si % 2):
            rng = np.random.default_rng(10 * si + i)
            n = 9000 + 1700 * i + 500 * si
            t = np.arange(n) / 16000
            y = 0.3 * np.sin(2 * np.pi * (160 + 30 * si + 25 * i) * t) + 0.05 * rng.standard_normal(n)
            sub = ("voice", "unit", "parallel")[si % 3]
            save_wav(root / "train" / sub / f"{spk}_{i}.wav", y.astype(np.float32), 16000)
    save_wav(root / "train" / "unit" / "S04_0.wav", np.zeros(100, np.float32), 16000)
    for i in range(3):
        y = 0.2 * np.sin(np.arange(6000 + 900 * i) * 0.05) + 0.05 * np.random.default_rng(99 + i).standard_normal(
            6000 + 900 * i)
        save_wav(root / "test" / f"S09_{i}.wav", y.astype(np.float32), 16000)
    return root


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    _write_corpus(root / "wavs")
    hps, acfg = load_configs(DEFAULT_HPS_PATH)
    d = dataclasses.asdict(hps.replace(seg_len=32))
    d["audio"] = dataclasses.asdict(acfg)
    hps_path = root / "hps.json"
    hps_path.write_text(json.dumps(d))
    common = ["--corpus", str(root / "wavs"), "--hps", str(hps_path), "--device", "cpu", "--n-samples", "100"]
    single = cli.main(["preprocess", "-dataset_path", str(root / "one"), "-index_path", str(root / "one.json"),
                       *common])
    return root, common, single


def _same_corpus(a, b):
    """Arenas and index equal, stats within 1e-10, speaker maps: b's is
    a's in sorted-name order."""
    sa = json.loads((a / "speakers.json").read_text())
    sb = json.loads((b / "speakers.json").read_text())
    assert sb == {s: i for i, s in enumerate(sorted(sa))}
    for split in ("train", "test"):
        assert json.loads((a / split / "index.json").read_text()) == json.loads((b / split / "index.json").read_text())
        for feat in FEATS:
            np.testing.assert_array_equal(np.load(b / split / f"{feat}.npy"), np.load(a / split / f"{feat}.npy"))
    with np.load(a / "stats.npz") as za, np.load(b / "stats.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_allclose(zb[k], za[k], rtol=0, atol=1e-10)
    assert (a / "audio_config.json").read_text() == (b / "audio_config.json").read_text()


def test_shard_then_merge_equals_one_process(work):
    root, common, single = work
    shards = [str(root / f"sh{i}") for i in range(3)]
    for i, sd in enumerate(shards):
        out = cli.main(["preprocess", "-dataset_path", sd, "-index_path", str(root / "unused.json"),
                        "--shard", f"{i}/3", *common])
        assert json.loads((root / f"sh{i}" / "shard.json").read_text()) == {"index": i, "of": 3}
        assert not (root / f"sh{i}" / "stats.npz").exists() and (root / f"sh{i}" / "stats_raw.npz").exists()
        assert out["counts"]["train"] < single["counts"]["train"]
    assert not (root / "unused.json").exists()  # a shard run writes no index
    merged = cli.main(["preprocess", "-dataset_path", str(root / "merged"), "-index_path",
                       str(root / "merged.json"), "--merge-shards", *shards, *common])
    assert merged["counts"] == single["counts"] and merged["frames"] == single["frames"]
    _same_corpus(root / "one", root / "merged")
    assert json.loads((root / "merged.json").read_text()) == json.loads((root / "one.json").read_text())


def test_workers_equal_one_process(work, monkeypatch):
    """The workers run one CPU thread each, as this process does: the
    plain frontend's f32 sums then follow the same order (with other
    thread counts the arenas differ by ~6e-8)."""
    root, common, single = work
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = cli.main(["preprocess", "-dataset_path", str(root / "w2"), "-index_path", str(root / "w2.json"),
                    "--workers", "2", *common])
    assert out["counts"] == single["counts"] and out["worker_launches"]["frontend"] == 0  # the CPU launches none
    assert not list(root.glob("w2.shard*"))  # the shard directories are removed
    _same_corpus(root / "one", root / "w2")
    assert json.loads((root / "w2.json").read_text()) == json.loads((root / "one.json").read_text())


def test_speaker_map_matches_jax_merge(work, tmp_path):
    root, _, _ = work
    cfg = AudioConfig()
    ref = []
    for i in range(2):
        jax_build_corpus(root / "wavs", tmp_path / f"j{i}.h5", cfg, n_shards=2, shard_index=i)
        ref.append(tmp_path / f"j{i}.h5")
        build_corpus(root / "wavs", tmp_path / f"p{i}", cfg, device="cpu", n_shards=2, shard_index=i)
    jm = jax_merge_corpus_shards(ref, tmp_path / "j.h5")
    pm = merge_corpus_shards([tmp_path / "p0", tmp_path / "p1"], tmp_path / "p")
    assert pm["speakers"] == jm["speakers"] and pm["counts"] == jm["counts"]
    assert "S04" in pm["speakers"]  # mapped though its only wav is too short for a frame


def test_merge_refusals(work, tmp_path):
    root, _, _ = work
    cfg = AudioConfig()
    for name in ("a", "b"):  # the same slice twice
        build_corpus(root / "wavs", tmp_path / name, cfg, device="cpu", n_shards=2, shard_index=0)
    with pytest.raises(ValueError, match="duplicate utterance"):
        merge_corpus_shards([tmp_path / "a", tmp_path / "b"], tmp_path / "m")
    with pytest.raises(ValueError, match="not a shard directory"):
        merge_corpus_shards([root / "one"], tmp_path / "m2")
    with pytest.raises(ValueError, match="shard_index"):
        build_corpus(root / "wavs", tmp_path / "c", cfg, device="cpu", n_shards=2, shard_index=2)


def test_native_load_and_trim_equals_wavio(tmp_path):
    """Decode and trim through native/wav_reader.cpp (built into the
    port's build directory) against load_wav + trim_silence: equal, bit for
    bit, on PCM16 mono with silent edges; float stereo within 1e-6 (the
    two average the channels in other orders); a file it cannot decode
    raises."""
    rng = np.random.default_rng(0)
    y = np.concatenate([np.zeros(4000), 0.5 * np.sin(np.arange(8000) * 0.06), 1e-4 * rng.standard_normal(3000)])
    save_wav(tmp_path / "a.wav", y.astype(np.float32), 16000)
    for top_db in (15.0, 20.0, None):
        ref = load_wav(tmp_path / "a.wav", 16000)
        ref = ref if top_db is None else trim_silence(ref, top_db)
        np.testing.assert_array_equal(native.load_and_trim(tmp_path / "a.wav", 16000, top_db), ref)
    assert 0 < len(native.load_and_trim(tmp_path / "a.wav", 16000, 15.0)) < len(y)
    st = rng.uniform(-0.5, 0.5, (4000, 2)).astype(np.float32)
    scipy.io.wavfile.write(str(tmp_path / "st.wav"), 16000, st)
    np.testing.assert_allclose(native.load_wav_native(tmp_path / "st.wav", 16000),
                               load_wav(tmp_path / "st.wav", 16000), atol=1e-6, rtol=0)
    (tmp_path / "bad.wav").write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError, match="native wav decode failed"):
        native.load_and_trim(tmp_path / "bad.wav", 16000, 15.0)
    so = native.build()
    assert so.parent == BUILD_DIR and so.name.startswith("wav_reader-")
