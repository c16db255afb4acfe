"""Segment sampler / index of the PyTorch port (a copy of
``zerospeech_tts_tpu/data/segments.py``'s ``make_segment_index`` over the
port's corpus directory; ref make_single_samples.py).

Pre-samples N fixed-length (seg_len) training windows ``(speaker, utt, t0,
t1)`` into a JSON index, so the host loader (data/loader.py) draws O(1)
random segments. The utterance lengths come from ``<split>/index.json``;
the walk over (speaker, utterance) is in name order, the order in which
the JAX package's h5 lists its groups, so the same corpus and seed give the
same entries.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def utterance_lengths(corpus: str | Path, split: str = "train") -> list[tuple[str, str, int]]:
    """(speaker, utterance, frames) of a corpus split, sorted by speaker,
    then utterance name."""
    path = Path(corpus) / split / "index.json"
    if not path.exists():
        raise ValueError(f"split {split!r} not in {corpus} (no {path})")
    index = json.loads(path.read_text())
    return sorted(zip(index["speakers"], index["names"], index["lengths"]))


def make_segment_index(
    corpus: str | Path,
    index_path: str | Path,
    seg_len: int,
    n_samples: int,
    split: str = "train",
    seed: int = 0,
    pair_offset_max: int | None = None,
    pair_grid: int = 1,
) -> list[dict]:
    """Sample n_samples segments uniformly over utterances long enough for a
    (segment, paired-segment) draw. Each entry carries the same-utterance
    pair offset t1 used by stage 1. ``pair_grid`` snaps t1 - t0 to a
    multiple (pass hps.downsample so the pair's latent frames align exactly
    on the overlap, as the solver's pair objective needs)."""
    rng = np.random.default_rng(seed)
    pair_offset_max = pair_offset_max if pair_offset_max is not None else seg_len
    utts = [(spk, utt, t) for spk, utt, t in utterance_lengths(corpus, split) if t >= seg_len + 1]
    if not utts:
        raise ValueError(f"no utterance in {corpus}:{split} is >= {seg_len + 1} frames")

    entries = []
    choice = rng.integers(0, len(utts), n_samples)
    for i in choice:
        spk, utt, t = utts[i]
        t0 = int(rng.integers(0, t - seg_len + 1))
        lo = max(0, t0 - pair_offset_max)
        hi = min(t - seg_len, t0 + pair_offset_max)
        dmin = -((t0 - lo) // pair_grid)
        dmax = (hi - t0) // pair_grid
        t1 = t0 + pair_grid * int(rng.integers(dmin, dmax + 1))
        entries.append({"speaker": spk, "utt": utt, "t0": t0, "t1": t1})

    Path(index_path).parent.mkdir(parents=True, exist_ok=True)
    Path(index_path).write_text(json.dumps(entries))
    return entries
