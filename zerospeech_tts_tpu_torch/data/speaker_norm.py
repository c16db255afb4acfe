"""Per-speaker feature normalization (SURVEY.md §2 "Per-speaker
normalization"; port of ``zerospeech_tts_tpu/data/speaker_norm.py``).

Conversion z-scores the source features with the source speaker's (or the
global) statistics and denormalizes the decoder output with the TARGET
speaker's statistics before Griffin-Lim. Unseen speakers fall back to the
global train statistics. The port's corpus directory (data/corpus.py) and
export bundles carry them in ``stats.npz`` (:meth:`load_corpus`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

GLOBAL_KEY = "__global__"


class SpeakerStats:
    """mean/std per speaker (+ global fallback) for one feature kind."""

    def __init__(self, mean: dict[str, np.ndarray], std: dict[str, np.ndarray]):
        self.mean = mean
        self.std = std
        assert GLOBAL_KEY in mean, "global fallback stats missing"

    @classmethod
    def load_corpus(cls, corpus_dir: str | Path, feat: str = "lin") -> "SpeakerStats":
        """Statistics of one feature from a port corpus directory's
        ``stats.npz`` (std floored at 1e-4, as the JAX package's h5 loader
        floors it)."""
        path = Path(corpus_dir) / "stats.npz"
        if not path.exists():
            raise FileNotFoundError(f"{path} missing: rebuild the corpus (preprocess)")
        mean, std = {}, {}
        with np.load(path) as z:
            for key in z.files:
                spk, kind = key.rsplit("|", 1)
                if kind == f"{feat}_mean":
                    mean[spk] = z[key]
                elif kind == f"{feat}_std":
                    std[spk] = np.maximum(z[key], 1e-4)
        return cls(mean, std)

    def normalize(self, feats: np.ndarray, speaker: str) -> np.ndarray:
        m, s = self.get(speaker)
        return (feats - m) / s

    def get(self, speaker: str) -> tuple[np.ndarray, np.ndarray]:
        if speaker in self.mean:
            return self.mean[speaker], self.std[speaker]
        return self.mean[GLOBAL_KEY], self.std[GLOBAL_KEY]

    def arrays_for(self, speakers: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """Stacked [n, F] mean/std for a speaker list."""
        ms = [self.get(s) for s in speakers]
        return (
            np.stack([m for m, _ in ms]).astype(np.float32),
            np.stack([s for _, s in ms]).astype(np.float32),
        )
