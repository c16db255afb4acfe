"""A run with the timed path broken underneath must come out not
correct: the harness's look for a card skipped, the rest of a run driven
on the CPU at the tests' geometry, one fault planted in the port for each
kind of fault the cell can have. (No cell spans chips, so none has an
exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_cell

torch.set_num_threads(1)


def _run(name: str, **traffic) -> dict:
    c = tiny_cell(name)
    c["traffic"].update(traffic)
    return run.run(name, 2**31 + 7, 0.3, False, "cpu", c)


def test_sound_runs_are_correct():
    for name in ("convert-corpus.lin-f32", "train-patchgan.lin-f32"):
        assert _run(name)["correct"]


@pytest.mark.parametrize("name", ["convert-corpus.lin-f32", "convert-corpus.lin-bf16", "serve-open.lin-f32"])
def test_a_unit_altered_where_it_is_made(name, monkeypatch):
    from zerospeech_tts_tpu_torch import convert

    made = convert.unit_bits

    def flipped(logits, mode="binary"):
        u = made(logits, mode).clone()
        u[:, 0] ^= 1  # the first unit (frame) of every utterance
        return u

    monkeypatch.setattr(convert, "unit_bits", flipped)
    res = _run(name)
    assert not res["correct"] and res["checks"]["units_differ_share"]["value"] > 0


@pytest.mark.parametrize("name", ["convert-corpus.lin-f32", "serve-open.lin-f32"])
def test_audio_altered_where_it_is_made(name, monkeypatch):
    from zerospeech_tts_tpu_torch.dsp import audio

    made = audio.spectrogram2wav
    monkeypatch.setattr(audio, "spectrogram2wav", lambda *a, **k: 0.5 * made(*a, **k))
    res = _run(name)
    assert not res["correct"] and res["checks"]["consistency_gap"]["value"] > res["checks"]["consistency_gap"]["limit"]


def test_answers_given_to_other_requests(monkeypatch):
    from zerospeech_tts_tpu_torch.convert import Converter

    made = Converter.convert_wavs_multi

    def rolled(self, wavs, *a, **k):
        units, pcm = made(self, wavs, *a, **k)
        return units[1:] + units[:1], [w[1:] + w[:1] for w in pcm]

    monkeypatch.setattr(Converter, "convert_wavs_multi", rolled)
    res = _run("serve-open.lin-f32", rate_per_s=400.0, window_ms=20.0)
    assert not res["correct"]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = _run("train-patchgan.lin-f32")
    assert not res["correct"] and res["checks"]["change_gap"]["value"] >= 0.99


def test_half_of_the_batch_left_out(monkeypatch):
    from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset

    made = DeviceDataset.sample_batch

    def half(self, gen, pairs=True):
        return {k: v[: v.shape[0] // 2] for k, v in made(self, gen, pairs).items()}

    monkeypatch.setattr(DeviceDataset, "sample_batch", half)
    assert not _run("train-patchgan.lin-f32")["correct"]
