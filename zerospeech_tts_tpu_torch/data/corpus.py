"""Corpus builder of the PyTorch port (counterpart of
``zerospeech_tts_tpu/data/corpus.py``; ref make_datasets.py / preprocess.py).

Walks the ZeroSpeech'19 layout::

    <corpus>/train/unit/*.wav      # unit-discovery speakers
    <corpus>/train/voice/*.wav     # target voices (V001, V002)
    <corpus>/train/parallel/**     # optional parallel data
    <corpus>/test/*.wav

Speaker identity comes from the filename prefix (``S015_0361841101.wav`` ->
``S015``), or from the parent directory. Each wav is decoded and trimmed
by the native decoder (data/native.py) and run through the frontend
(kernel 1 on a CUDA device, one launch per wav). Per-speaker statistics
(plus ``__global__``) of the train split are summed in float64 in one pass,
as the JAX builder does.

The output is a directory that numpy alone reads (no HDF5)::

    <out>/speakers.json               # name -> id, in encounter order
    <out>/audio_config.json
    <out>/<split>/mel.npy, lin.npy    # frame arenas [total_frames, F] f32
                                      #   (np.load(mmap_mode="r") opens them)
    <out>/<split>/index.json          # {"names", "speakers", "starts", "lengths"}
    <out>/stats.npz                   # "<spk>|<feat>_mean" / "<spk>|<feat>_std"

Sharded build (``n_shards > 1``): one process handles the slice
``paths[shard_index::n_shards]`` of every split and writes, in place of
``stats.npz``, the raw float64 partials ``stats_raw.npz`` (``"<spk>|<feat>_n"``,
``_s1``, ``_s2``) and ``shard.json``; its ``index.json`` also lists each
utterance's ``ranks`` (its place in the split's sorted wav list).
:func:`merge_corpus_shards` combines the shards exactly: utterances in rank
order (the single-process build's order, so its arenas come out equal),
statistics from the summed partials, the speaker map in sorted-name order.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.data import native
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio

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
        return _finalize(self.n, self.s1, self.s2)


def _finalize(n: int, s1: np.ndarray, s2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) in float32 of n frames with float64 sums s1 and s2."""
    mean = s1 / max(n, 1)
    var = np.maximum(s2 / max(n, 1) - mean**2, 1e-12)
    return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


def _write_meta(out: Path, speakers: dict, cfg_json: str) -> None:
    (out / "speakers.json").write_text(json.dumps(speakers, indent=2) + "\n")
    (out / "audio_config.json").write_text(cfg_json)


def build_corpus(
    corpus_dir: str | Path,
    out_dir: str | Path,
    cfg: AudioConfig,
    trim: bool = True,
    device: str | torch.device = "cuda",
    n_shards: int = 1,
    shard_index: int = 0,
) -> dict:
    """Extract features for every wav (or, with ``n_shards > 1``, for the
    slice ``shard_index::n_shards`` of each split) and write the corpus
    directory. Returns {"speakers", "counts", "frames", "path"}."""
    if not 0 <= shard_index < n_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {n_shards})")
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
        ranks = []
        pos = 0
        for rank in range(shard_index, len(paths), n_shards):
            path = paths[rank]
            y = native.load_and_trim(path, cfg.sr, cfg.top_db if trim else None)
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
            ranks.append(rank)
            pos += t
        if not index["names"]:
            continue
        if n_shards > 1:
            index["ranks"] = ranks
        (out / split).mkdir(exist_ok=True)
        for feat in FEATS:
            np.save(out / split / f"{feat}.npy", np.concatenate(arenas[feat]).astype(np.float32))
        (out / split / "index.json").write_text(json.dumps(index) + "\n")
        counts[split] = len(index["names"])
        frames[split] = pos
    arrs = {}
    for feat in FEATS:
        for spk, st in stats[feat].items():
            if n_shards > 1:  # the merge's exact reduction needs the sums, not the moments
                arrs[f"{spk}|{feat}_n"] = np.int64(st.n)
                arrs[f"{spk}|{feat}_s1"], arrs[f"{spk}|{feat}_s2"] = st.s1, st.s2
            else:
                arrs[f"{spk}|{feat}_mean"], arrs[f"{spk}|{feat}_std"] = st.finalize()
    if n_shards > 1:
        np.savez(out / "stats_raw.npz", **arrs)
        (out / "shard.json").write_text(json.dumps({"index": shard_index, "of": n_shards}) + "\n")
    else:
        np.savez(out / "stats.npz", **arrs)
    _write_meta(out, speakers, json.dumps(dataclasses.asdict(cfg), indent=2) + "\n")
    return {"speakers": speakers, "counts": counts, "frames": frames, "path": str(out)}


def merge_corpus_shards(shard_dirs, out_dir: str | Path) -> dict:
    """Combine the shard directories of a sharded :func:`build_corpus` into
    one corpus directory. Each split's utterances are laid out in rank
    order, which is the single-process build's order, so the arenas equal
    its arenas; the per-speaker statistics come from the exact reduction
    over the shards' raw (n, s1, s2) partials (equal to a single-process
    build's up to float64 sum reassociation); the speaker map is assigned
    in sorted-name order, whatever the partition. Returns {"speakers",
    "counts", "frames", "path"}."""
    shard_dirs = [Path(p) for p in shard_dirs]
    if not shard_dirs:
        raise ValueError("no shard directories given")
    cfg_json = None
    seen: set[str] = set()
    utts: dict[str, list] = {}  # split -> [(rank, name, speaker, shard, start, length)]
    raw: dict[str, list] = {}  # "<spk>|<feat>" -> [n, s1, s2]
    for k, sd in enumerate(shard_dirs):
        if not (sd / "shard.json").exists():
            raise ValueError(f"{sd} is not a shard directory (built with n_shards > 1)")
        cj = (sd / "audio_config.json").read_text()
        if cfg_json is None:
            cfg_json = cj
        elif cj != cfg_json:
            raise ValueError(f"{sd}: audio_config differs across shards")
        seen.update(load_speaker_map(sd))
        for split in ("train", "test"):
            if not (sd / split / "index.json").exists():
                continue
            idx = json.loads((sd / split / "index.json").read_text())
            utts.setdefault(split, []).extend(
                zip(idx["ranks"], idx["names"], idx["speakers"], [k] * len(idx["names"]), idx["starts"],
                    idx["lengths"]))
        with np.load(sd / "stats_raw.npz") as z:
            for key in z.files:
                what, part = key.rsplit("_", 1)
                acc = raw.setdefault(what, [0, 0.0, 0.0])
                acc[{"n": 0, "s1": 1, "s2": 2}[part]] += z[key].astype(np.int64 if part == "n" else np.float64)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    counts, frames = {}, {}
    for split, rows in utts.items():
        rows.sort()
        if len({r[0] for r in rows}) != len(rows) or len({(r[2], r[1]) for r in rows}) != len(rows):
            raise ValueError(f"duplicate utterance in {split} across shards (overlapping partitions?)")
        (out / split).mkdir(exist_ok=True)
        index = {"names": [r[1] for r in rows], "speakers": [r[2] for r in rows], "starts": [], "lengths": []}
        pos = 0
        for r in rows:
            index["starts"].append(pos)
            index["lengths"].append(r[5])
            pos += r[5]
        for feat in FEATS:
            arenas = [np.load(sd / split / f"{feat}.npy", mmap_mode="r") if (sd / split).exists() else None
                      for sd in shard_dirs]
            np.save(out / split / f"{feat}.npy",
                    np.concatenate([arenas[r[3]][r[4] : r[4] + r[5]] for r in rows]).astype(np.float32))
        (out / split / "index.json").write_text(json.dumps(index) + "\n")
        counts[split], frames[split] = len(rows), pos
    arrs = {}
    for what, (n, s1, s2) in raw.items():
        spk, feat = what.rsplit("|", 1)
        arrs[f"{spk}|{feat}_mean"], arrs[f"{spk}|{feat}_std"] = _finalize(int(n), s1, s2)
    np.savez(out / "stats.npz", **arrs)
    speakers = {s: i for i, s in enumerate(sorted(seen))}
    _write_meta(out, speakers, cfg_json)
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
