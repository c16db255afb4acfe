"""PyTorch port, the segment index (data/segments.py): the same wavs through
the JAX package's ``build_corpus`` + ``make_segment_index`` (an h5) and
through the port's (a corpus directory), with the same seed, give the same
index entries, bit for bit; the port's refusal of a corpus with no long
enough utterance."""

import json

import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.data.corpus import build_corpus as jax_build_corpus
from zerospeech_tts_tpu.data.segments import make_segment_index as jax_make_segment_index
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.data.corpus import build_corpus
from zerospeech_tts_tpu_torch.data.segments import make_segment_index, utterance_lengths
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav

torch.set_num_threads(1)


def write_corpus(root, speakers=("V001", "S02", "S01"), n_utts=3):
    """Noise-rich tones with silent edges (so trimming acts), of unequal
    lengths; wav paths whose sorted order is not the (speaker, utterance)
    name order."""
    for si, spk in enumerate(speakers):
        for i in range(n_utts):
            rng = np.random.default_rng(10 * si + i)
            n = 12000 + 2400 * i + 800 * si
            t = np.arange(n) / 16000
            y = 0.3 * np.sin(2 * np.pi * (170 + 35 * si + 20 * i) * t) + 0.05 * rng.standard_normal(n)
            y = np.concatenate([np.zeros(3000), y, 1e-4 * rng.standard_normal(2500)])
            sub = "a_voice" if spk.startswith("V") else "b_unit"  # V001 first in path order
            save_wav(root / "train" / sub / f"{spk}_{(n_utts - i) * 7:03d}.wav", y.astype(np.float32), 16000)
    return root


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("segments")
    write_corpus(root / "wavs")
    cfg = AudioConfig()
    jax_build_corpus(root / "wavs", root / "ref.h5", cfg)
    build_corpus(root / "wavs", root / "ds", cfg, device="cpu")
    return root


@pytest.mark.parametrize("seed,seg_len,pair_grid,offset_max", [(0, 32, 4, None), (3, 64, 8, 40), (7, 90, 1, None)])
def test_index_entries_equal_jax(corpora, seed, seg_len, pair_grid, offset_max):
    ref = jax_make_segment_index(corpora / "ref.h5", corpora / "ref_idx.json", seg_len, 500, seed=seed,
                                 pair_offset_max=offset_max, pair_grid=pair_grid)
    got = make_segment_index(corpora / "ds", corpora / "idx.json", seg_len, 500, seed=seed,
                             pair_offset_max=offset_max, pair_grid=pair_grid)
    assert got == ref
    assert json.loads((corpora / "idx.json").read_text()) == ref
    assert all((e["t1"] - e["t0"]) % pair_grid == 0 for e in got)
    assert len({e["speaker"] for e in got}) > 1


def test_walk_is_in_name_order(corpora):
    """The port walks (speaker, utterance) by name, as the h5 lists them,
    whatever order the corpus directory holds them in."""
    import h5py

    walk = utterance_lengths(corpora / "ds")
    with h5py.File(corpora / "ref.h5", "r") as f:
        ref = [(s, u, f[f"train/{s}/{u}/mel"].shape[0]) for s in f["train"] for u in f["train"][s]]
    assert walk == ref
    index = json.loads((corpora / "ds" / "train" / "index.json").read_text())
    assert list(zip(index["speakers"], index["names"])) != [(s, u) for s, u, _ in walk]


def test_refuses_a_corpus_of_short_utterances(corpora, tmp_path):
    longest = max(t for _, _, t in utterance_lengths(corpora / "ds"))
    with pytest.raises(ValueError, match=f">= {longest + 1} frames"):
        make_segment_index(corpora / "ds", tmp_path / "idx.json", longest, 10)
    with pytest.raises(ValueError, match="split 'test'"):
        make_segment_index(corpora / "ds", tmp_path / "idx.json", 8, 10, split="test")
