"""Per-speaker feature normalization (SURVEY.md §2 "Per-speaker
normalization"; port of ``zerospeech_tts_tpu/data/speaker_norm.py``).

Conversion z-scores the source features with the source speaker's (or the
global) statistics and denormalizes the decoder output with the TARGET
speaker's statistics before Griffin-Lim. Unseen speakers fall back to the
global train statistics. ``h5py`` is imported inside :meth:`load` only:
export bundles carry their statistics in ``stats.npz``, and a serving host
needs no HDF5 stack.
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
    def load(cls, h5_path: str | Path, feat: str = "lin") -> "SpeakerStats":
        import h5py

        mean, std = {}, {}
        with h5py.File(h5_path, "r") as f:
            if "stats" not in f:
                raise ValueError(f"no stats group in {h5_path}; rebuild the corpus")
            for spk in f["stats"]:
                mean[spk] = f[f"stats/{spk}/{feat}_mean"][:]
                std[spk] = np.maximum(f[f"stats/{spk}/{feat}_std"][:], 1e-4)
        if GLOBAL_KEY not in mean:
            # derive a fallback from the speaker average (older corpora)
            mean[GLOBAL_KEY] = np.mean(list(mean.values()), axis=0)
            std[GLOBAL_KEY] = np.mean(list(std.values()), axis=0)
        return cls(mean, std)

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
