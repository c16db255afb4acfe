"""The one traffic generator: every mix is a data file
(``benchmark/traffic/<mix>.json``) of parameters that this module reads.

Every seed gets the same set of sizes and gaps, in another order, so runs
with different seeds do the same work: utterance durations are the
quantiles of a log-normal at evenly spaced probabilities (clipped), and
inter-arrival gaps the quantiles of an exponential; the seed permutes
them, draws each utterance's content and assigns speakers and targets in
balanced sets. Wavs are synthesised speech-like signals (a copy of the
port's ``tools/workload.py speechlike`` with its pitch drawn from the
seed): loud throughout, so trimming keeps every sample.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ndtri


def rng(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for each (seed, stream...)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, stream)]))


def durations(spec: dict, n: int) -> np.ndarray:
    """n durations in seconds: log-normal quantiles at (i + 0.5) / n with
    spec's median and sigma, clipped to [min, max], longest first."""
    z = ndtri((np.arange(n) + 0.5) / n)
    d = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(d, spec["min"], spec["max"])[::-1].copy()


def gaps(n: int, rate: float) -> np.ndarray:
    """n inter-arrival gaps (s): exponential quantiles at (i + 0.5) / n
    of mean 1 / rate (a Poisson process's)."""
    return -np.log1p(-(np.arange(n) + 0.5) / n) / rate


def balanced(n: int, k: int, g: np.random.Generator) -> np.ndarray:
    """n labels from range(k), each as often as n allows, in seeded order."""
    return g.permutation(np.arange(n) % k)


def speechlike(n: int, g: np.random.Generator) -> np.ndarray:
    """A harmonic 'voice' of n samples at 16 kHz: eight harmonics of a
    pitch from 90 to 260 Hz at 0.3 / k, random phases, a 2.5 Hz amplitude
    swing of +-25%, noise at 0.05."""
    f0 = g.uniform(90.0, 260.0)
    t = np.arange(n) / 16000.0
    ph = np.mod(2.0 * np.pi * f0 * t, 2.0 * np.pi).astype(np.float32)
    y = np.zeros(n, np.float32)
    for k in range(1, 9):
        y += np.float32(0.3 / k) * np.sin(np.float32(k) * ph + np.float32(g.uniform(0.0, 6.28)))
    y *= 0.75 + 0.25 * np.sin(np.float32(2.0 * np.pi * 2.5) * t.astype(np.float32))
    return y + np.float32(0.05) * g.standard_normal(n, dtype=np.float32)


def utterances(spec: dict, n: int, seed: int, sr: int, stream: int = 0) -> list[np.ndarray]:
    """n synthesised wavs whose durations are ``durations(spec, n)`` in an
    order drawn from the seed."""
    order = rng(seed, stream, 0).permutation(n)
    d = durations(spec, n)[order]
    return [speechlike(int(round(s * sr)), rng(seed, stream, 1, i)) for i, s in enumerate(d)]
