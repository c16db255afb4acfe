"""Corpus builder of the PyTorch port (counterpart of
``zerospeech_tts_tpu/data/corpus.py``; ref make_datasets.py / preprocess.py).

Walks the ZeroSpeech'19 layout::

    <corpus>/train/unit/*.wav      # unit-discovery speakers
    <corpus>/train/voice/*.wav     # target voices (V001, V002)
    <corpus>/train/parallel/**     # optional parallel data
    <corpus>/test/*.wav

Speaker identity comes from the filename prefix (``S015_0361841101.wav`` ->
``S015``), or from the parent directory. Each wav is decoded, trimmed and
run through the frontend (kernel 1 on a CUDA device, one launch per wav).
Per-speaker statistics (plus ``__global__``) of the train split are summed
in float64 in one pass, as the JAX builder does.

The output is a directory that numpy alone reads (no HDF5)::

    <out>/speakers.json               # name -> id, in encounter order
    <out>/audio_config.json
    <out>/<split>/mel.npy, lin.npy    # frame arenas [total_frames, F] f32
                                      #   (np.load(mmap_mode="r") opens them)
    <out>/<split>/index.json          # {"names", "speakers", "starts", "lengths"}
    <out>/stats.npz                   # "<spk>|<feat>_mean" / "<spk>|<feat>_std"
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, trim_silence

_SPK_RE = re.compile(r"^([A-Za-z]+\d+)[_-]")
FEATS = ("mel", "lin")


def speaker_of(path: Path) -> str:
    """Speaker id: filename prefix (challenge layout) or parent dir name."""
    m = _SPK_RE.match(path.stem)
    return m.group(1) if m else path.parent.name


def discover_wavs(corpus_dir: str | Path) -> dict[str, list[Path]]:
    """Map split name -> sorted wav paths: train (unit + voice + parallel
    merged) and test; a flat directory of wavs is a train split."""
    corpus = Path(corpus_dir)
    train = sorted((corpus / "train").rglob("*.wav")) if (corpus / "train").exists() else []
    test = sorted((corpus / "test").rglob("*.wav")) if (corpus / "test").exists() else []
    if not train and not test:
        train = sorted(corpus.rglob("*.wav"))
    return {k: v for k, v in (("train", train), ("test", test)) if v}


class _SpeakerStats:
    """Single-pass mean/std accumulator over feature frames (float64 sums)."""

    def __init__(self):
        self.n = 0
        self.s1: np.ndarray | None = None
        self.s2: np.ndarray | None = None

    def update(self, feats: np.ndarray) -> None:
        if self.s1 is None:
            self.s1 = np.zeros(feats.shape[1], np.float64)
            self.s2 = np.zeros(feats.shape[1], np.float64)
        self.n += feats.shape[0]
        self.s1 += feats.sum(axis=0, dtype=np.float64)
        self.s2 += (feats.astype(np.float64) ** 2).sum(axis=0)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        mean = self.s1 / max(self.n, 1)
        var = np.maximum(self.s2 / max(self.n, 1) - mean**2, 1e-12)
        return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


def build_corpus(
    corpus_dir: str | Path,
    out_dir: str | Path,
    cfg: AudioConfig,
    trim: bool = True,
    device: str | torch.device = "cuda",
) -> dict:
    """Extract features for every wav and write the corpus directory.
    Returns {"speakers", "counts", "frames", "path"}."""
    found = discover_wavs(corpus_dir)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    speakers: dict[str, int] = {}
    counts: dict[str, int] = {}
    frames: dict[str, int] = {}
    stats = {feat: {} for feat in FEATS}
    for split in ("train", "test"):
        paths = found.get(split, [])
        arenas: dict[str, list[np.ndarray]] = {feat: [] for feat in FEATS}
        index = {"names": [], "speakers": [], "starts": [], "lengths": []}
        pos = 0
        for path in paths:
            y = load_wav(path, cfg.sr)
            if trim:
                y = trim_silence(y, cfg.top_db)
            spk = speaker_of(path)
            speakers.setdefault(spk, len(speakers))
            if len(y) < cfg.hop_length:
                continue
            mel_d, lin_d = dsp_audio.wav_to_features(torch.from_numpy(y).to(device), cfg)
            feats = {"mel": mel_d.cpu().numpy(), "lin": lin_d.cpu().numpy()}
            for feat in FEATS:
                arenas[feat].append(feats[feat])
                if split == "train":
                    for key in (spk, "__global__"):
                        stats[feat].setdefault(key, _SpeakerStats()).update(feats[feat])
            t = feats["mel"].shape[0]
            index["names"].append(path.stem)
            index["speakers"].append(spk)
            index["starts"].append(pos)
            index["lengths"].append(t)
            pos += t
        if not index["names"]:
            continue
        (out / split).mkdir(exist_ok=True)
        for feat in FEATS:
            np.save(out / split / f"{feat}.npy", np.concatenate(arenas[feat]).astype(np.float32))
        (out / split / "index.json").write_text(json.dumps(index) + "\n")
        counts[split] = len(index["names"])
        frames[split] = pos
    arrs = {}
    for feat in FEATS:
        for spk, st in stats[feat].items():
            arrs[f"{spk}|{feat}_mean"], arrs[f"{spk}|{feat}_std"] = st.finalize()
    np.savez(out / "stats.npz", **arrs)
    (out / "speakers.json").write_text(json.dumps(speakers, indent=2) + "\n")
    (out / "audio_config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2) + "\n")
    return {"speakers": speakers, "counts": counts, "frames": frames, "path": str(out)}


def load_speaker_map(corpus: str | Path) -> dict[str, int]:
    return json.loads((Path(corpus) / "speakers.json").read_text())


def load_split(corpus: str | Path, split: str, feat: str = "lin"):
    """(arena [total_frames, F] memory-mapped, index dict) of one split."""
    d = Path(corpus) / split
    if not (d / "index.json").exists():
        raise FileNotFoundError(f"{d} has no index.json: not a corpus split (run preprocess)")
    arena = np.load(d / f"{feat}.npy", mmap_mode="r")
    return arena, json.loads((d / "index.json").read_text())
