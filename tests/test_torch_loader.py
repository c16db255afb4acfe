"""PyTorch port, the host data loader (data/loader.py): SegmentLoader
batches against the JAX package's SegmentLoader over the same segment
index (corpora built from the same wavs by each package), with prefetch
off and on; reseed; its refusals; a prefetch thread's exception reaching
the consumer; and ``train1`` from the loader on the CPU, resumed with a
reseed."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.data.corpus import build_corpus as jax_build_corpus
from zerospeech_tts_tpu.data.loader import SegmentLoader as JaxSegmentLoader
from zerospeech_tts_tpu.data.segments import make_segment_index as jax_make_segment_index
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.data.corpus import build_corpus
from zerospeech_tts_tpu_torch.data.loader import SegmentLoader
from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav

torch.set_num_threads(1)

FRONTEND_ATOL = 1e-4  # the frontend's bar on dB-normalised features (test_torch_frontend.py)


def _write_corpus(root, speakers=("S01", "S02", "V001", "V002"), n_utts=2, seconds=1.5):
    for si, spk in enumerate(speakers):
        for i in range(n_utts):
            rng = np.random.default_rng(10 * si + i)
            n = int(16000 * seconds) + 1600 * i
            t = np.arange(n) / 16000
            y = 0.3 * np.sin(2 * np.pi * (180 + 40 * si + 15 * i) * t) + 0.05 * rng.standard_normal(n)
            sub = "voice" if spk.startswith("V") else "unit"
            save_wav(root / "train" / sub / f"{spk}_{i}.wav", y.astype(np.float32), 16000)
    return root


@pytest.fixture(scope="module")
def corpora(tmp_path_factory, tiny_hps):
    """The same wavs through each package's build_corpus, and one segment
    index (JAX's; the port's equals it, test_torch_segments.py)."""
    root = tmp_path_factory.mktemp("loader")
    _write_corpus(root / "wavs")
    cfg = AudioConfig()
    hps = tiny_hps.replace(speaker_norm=True, n_feat=cfg.n_mels, n_speakers=4, batch_size=6)
    jax_build_corpus(root / "wavs", root / "ref.h5", cfg)
    build_corpus(root / "wavs", root / "ds", cfg, device="cpu")
    jax_make_segment_index(root / "ref.h5", root / "idx.json", hps.seg_len, 300, seed=0,
                           pair_grid=hps.downsample)
    return root, hps


def _bound(ds, speakers, spk_ids, ref):
    """FRONTEND_ATOL carried through the speaker norm (x - m) / s, element
    by element: the feature's and the mean's differences over the row's
    speaker's std of that bin, and the std's difference times the
    normalised value, |ref|. (Measured: at most 5.1e-5.)"""
    st = SpeakerStats.load_corpus(ds, "mel")
    names = {i: n for n, i in speakers.items()}
    s = np.stack([st.get(names[int(i)])[1] for i in spk_ids])[:, None, :]
    return FRONTEND_ATOL * (2.0 + np.abs(ref)) / s


@pytest.mark.parametrize("prefetch", [0, 2])
def test_batches_match_jax(corpora, prefetch):
    root, hps = corpora
    kw = dict(feat="mel", target_speakers=["V001"], seed=3, prefetch=prefetch, pairs=True)
    with JaxSegmentLoader(root / "ref.h5", root / "idx.json", hps, **kw) as ref, \
            SegmentLoader(root / "ds", root / "idx.json", hps, device="cpu", **kw) as got:
        assert got.speakers == ref.speakers
        for b_ref, b_got in zip([next(iter(ref)) for _ in range(3)], [next(iter(got)) for _ in range(3)]):
            assert set(b_got) == set(b_ref) == {"x", "spk", "x_real", "spk_real", "x2", "pair_dt"}
            for k in ("spk", "spk_real", "pair_dt"):
                assert b_got[k].dtype == torch.int64
                np.testing.assert_array_equal(b_got[k].numpy(), b_ref[k])
            for k, ids in (("x", "spk"), ("x_real", "spk_real"), ("x2", "spk")):
                assert b_got[k].dtype == torch.float32 and b_got[k].shape == (6, hps.seg_len, hps.n_feat)
                diff = np.abs(b_got[k].numpy() - b_ref[k])
                assert (diff <= _bound(root / "ds", got.speakers, b_ref[ids], b_ref[k])).all(), diff.max()
            assert set(b_got["spk_real"].tolist()) == {ref.speakers["V001"]}


def test_reseed_matches_jax_and_moves_the_stream(corpora):
    root, hps = corpora
    with JaxSegmentLoader(root / "ref.h5", root / "idx.json", hps, feat="mel", prefetch=0) as ref, \
            SegmentLoader(root / "ds", root / "idx.json", hps, feat="mel", device="cpu", prefetch=0) as got:
        first = next(iter(got))["spk"].tolist()
        ref.reseed(12)
        got.reseed(12)
        b_ref, b_got = next(iter(ref)), next(iter(got))
        np.testing.assert_array_equal(b_got["spk"].numpy(), b_ref["spk"])
        assert "x2" not in b_got
    with SegmentLoader(root / "ds", root / "idx.json", hps, feat="mel", device="cpu", prefetch=0) as again:
        assert next(iter(again))["spk"].tolist() == first  # the same seed replays the same stream


def test_refusals(corpora, tmp_path):
    root, hps = corpora
    entries = json.loads((root / "idx.json").read_text())
    off = [dict(e, t1=e["t0"] + 1) for e in entries[:4]]
    (tmp_path / "off.json").write_text(json.dumps(off))
    with pytest.raises(ValueError, match="off the downsample"):
        SegmentLoader(root / "ds", tmp_path / "off.json", hps, feat="mel", device="cpu", pairs=True)
    SegmentLoader(root / "ds", tmp_path / "off.json", hps, feat="mel", device="cpu").close()  # no pairs: fine
    with pytest.raises(ValueError, match="n_speakers"):
        SegmentLoader(root / "ds", root / "idx.json", hps.replace(n_speakers=2), feat="mel", device="cpu")
    with pytest.raises(ValueError, match="n_feat"):
        SegmentLoader(root / "ds", root / "idx.json", hps, feat="lin", device="cpu")
    (tmp_path / "empty.json").write_text("[]")
    with pytest.raises(ValueError, match="empty segment index"):
        SegmentLoader(root / "ds", tmp_path / "empty.json", hps, feat="mel", device="cpu")


def test_prefetch_thread_hands_its_error_to_the_consumer(corpora, tmp_path):
    root, hps = corpora
    entries = [dict(e, utt="missing") for e in json.loads((root / "idx.json").read_text())[:4]]
    (tmp_path / "bad.json").write_text(json.dumps(entries))
    loader = SegmentLoader(root / "ds", tmp_path / "bad.json", hps, feat="mel", device="cpu", prefetch=2)
    with loader, pytest.raises(KeyError, match="missing"):
        next(iter(loader))
    assert loader._thread is None


def test_train1_from_the_loader_resumes_with_reseed(tmp_path, monkeypatch):
    """preprocess -> train1 (three phases from the SegmentLoader) -> train1
    resumed: the resumed run reseeds the loader with the restored step;
    train2 reseeds too and draws its batches from the loader."""
    _write_corpus(tmp_path / "wavs")
    hps = Hps().replace(batch_size=2, seg_len=32, emb_size=16, spk_emb_size=8, n_speakers=6, bank_size=2,
                        bank_channels=4, conv_channels=8, n_critic=2, log_interval=1, save_interval=100)
    cfg = dataclasses.asdict(hps)
    cfg["audio"] = dataclasses.asdict(AudioConfig())
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    ds, ck, idx = str(tmp_path / "ds"), str(tmp_path / "ck"), str(tmp_path / "idx.json")
    common = ["--hps", str(tmp_path / "tiny.json"), "--device", "cpu"]
    cli.main(["preprocess", "--corpus", str(tmp_path / "wavs"), "-dataset_path", ds, "-index_path", idx,
              "--n-samples", "200", *common])
    seeds, drawn = [], []
    orig_reseed, orig_assemble = SegmentLoader.reseed, SegmentLoader._assemble
    monkeypatch.setattr(SegmentLoader, "reseed", lambda self, k: (seeds.append(k), orig_reseed(self, k))[1])
    monkeypatch.setattr(SegmentLoader, "_assemble",
                        lambda self: (drawn.append(self.pairs), orig_assemble(self))[1])
    train = ["-dataset_path", ds, "-index_path", idx, "-ckpt_dir", ck, *common]
    r1 = cli.main(["train1", *train, "--iters-override", "2"])
    assert r1["step"] == 6 and r1["resumed_from"] is None and seeds == []
    assert len(drawn) >= 6 and all(drawn)  # stage 1 takes the pair
    r1b = cli.main(["train1", *train, "--iters-override", "3"])
    assert r1b["resumed_from"] == 6 and r1b["step"] == 9 and seeds == [6]
    drawn.clear()
    r2 = cli.main(["train2", *train, "--iters-override", "1", "--targets", "V001", "V002"])
    assert r2["step"] == 9 + hps.n_critic + 1 and seeds == [6, 9]
    assert len(drawn) >= hps.n_critic + 1 and not any(drawn)
    for k, v in {**r1["phases"]["train"]["last"], **r2["phases"]["patchGAN"]["last"]}.items():
        assert np.isfinite(v), k
