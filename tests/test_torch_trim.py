"""The port's silence trim: ``_frame_rms``'s block path against the gather
formula (kept here as the plain version), bit for bit, and the counter of
the path each call took."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.core import traffic
from zerospeech_tts_tpu_torch.dsp import wavio

FRAME, HOP, SR = 2048, 512, 16000
LENGTHS = [0, 1, 100, HOP - 1, HOP, HOP + 1, 4 * HOP, 4 * HOP + 1, 37 * HOP, 37 * HOP + 1,
           FRAME + 3, 48000, 12 * SR]


def plain_rms(y, frame_length=FRAME, hop_length=HOP):
    """Center-padded frame RMS through an index array of every frame."""
    pad = frame_length // 2
    ypad = np.pad(y, (pad, pad), mode="constant")
    n = 1 + len(y) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(ypad[idx] ** 2, axis=1))


def plain_trim(y, top_db, frame_length=FRAME, hop_length=HOP):
    if len(y) == 0:
        return y
    rms = plain_rms(y, frame_length, hop_length)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(np.max(rms), 1e-10))
    keep = np.flatnonzero(db > -top_db)
    if keep.size == 0:
        return y[:0]
    return y[int(keep[0]) * hop_length:min(len(y), int(keep[-1] + 1) * hop_length)]


def signal(kind, n, dtype, seed=0):
    g = np.random.default_rng(seed)
    if kind == "silence":
        return np.zeros(n, dtype)
    if kind == "speechlike":
        return traffic.speechlike(n, traffic.rng(seed, n)).astype(dtype)
    y = g.standard_normal(n) * 0.3
    if kind == "padded":  # leading and trailing silence, a quiet tail before it
        a, b = n // 5, n - n // 4
        y[:a] = 0.0
        y[b:] = 0.0
        y[b - n // 10:b] *= 1e-3
    return y.astype(dtype)


def assert_same_trim(y, top_db, frame_length=FRAME, hop_length=HOP):
    ours, ref = wavio.trim_silence(y, top_db, frame_length, hop_length), plain_trim(y, top_db, frame_length, hop_length)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)
    if len(ours):  # the same view of y
        assert np.shares_memory(ours, y) and ours.ctypes.data == ref.ctypes.data


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["noise", "padded", "silence", "speechlike"])
def test_frame_rms_equals_the_gather_formula(kind, dtype):
    for n in LENGTHS:
        y = signal(kind, n, dtype, seed=n)
        ours, ref = wavio._frame_rms(y, FRAME, HOP), plain_rms(y)
        assert ours.dtype == ref.dtype and np.array_equal(ours, ref), n


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["noise", "padded", "silence", "speechlike"])
def test_trim_silence_equals_the_plain_version(kind, dtype):
    for n in LENGTHS:
        for top_db in (15.0, 20.0, 60.0):
            assert_same_trim(signal(kind, n, dtype, seed=n + 1), top_db)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_random_lengths_equal_the_plain_version(dtype):
    g = np.random.default_rng(7)
    for n in g.integers(1, 12 * SR, 60):
        y = signal("padded", int(n), dtype, seed=int(n))
        assert np.array_equal(wavio._frame_rms(y, FRAME, HOP), plain_rms(y)), n
        assert_same_trim(y, 15.0)


@pytest.mark.parametrize("seed", [1, 2_147_483_659])
def test_a_pass_of_the_conversion_traffic_trims_as_before(seed):
    """Every utterance of a pass of the conversion cells' traffic, as the
    Converter trims them (float32, the configuration's top_db)."""
    spec = json.loads((Path(__file__).parents[1] / "benchmark/traffic/convert-corpus.json").read_text())
    wavs = traffic.utterances(spec["duration_s"], spec["utterances"], seed, SR)
    for y in wavs:
        assert_same_trim(y, 15.0)


def test_defaults_take_the_block_path():
    before = wavio.trim_counts()
    y = signal("speechlike", 3 * SR, np.float32)
    wavio.trim_silence(y)
    wavio.trim_silence(y.astype(np.float64), 20.0)
    after = wavio.trim_counts()
    assert after["blocks"] - before["blocks"] == 2 and after["gather"] == before["gather"]


@pytest.mark.parametrize("frame_length,hop_length,dtype,path", [
    (2000, 512, np.float32, "gather"),  # not a whole number of hops
    (256, 64, np.float32, "gather"),  # a hop under 128: numpy sums it in one unrolled loop
    (1536, 512, np.float64, "gather"),  # three hops: numpy's halves cut a block
    (2048, 512, np.float16, "gather"),  # np.mean sums float16 in float32
    (512, 512, np.float32, "blocks"),  # one hop a frame
    (1024, 128, np.float64, "blocks"),
    (4096, 512, np.float32, "blocks"),
    (544, 136, np.float32, "blocks"),  # a count that is no power of two: np.mean's division
])
def test_other_arguments_take_their_path(frame_length, hop_length, dtype, path):
    before = wavio.trim_counts()
    for n in (0, 1, hop_length + 1, 5 * frame_length + 7, 40000):
        y = signal("padded", n, dtype, seed=n)
        assert np.array_equal(wavio._frame_rms(y, frame_length, hop_length), plain_rms(y, frame_length, hop_length))
        assert_same_trim(y, 15.0, frame_length, hop_length)
    after = wavio.trim_counts()
    other = "blocks" if path == "gather" else "gather"
    assert after[path] - before[path] == 9 and after[other] == before[other]  # trim_silence skips length 0
