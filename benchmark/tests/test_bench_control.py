"""Each cell's control, at a size a test run holds: the reference one
precision below the configuration's (TF32 under float32, float8 e4m3
under bfloat16), put in the program's place, must fail at least one of
the cell's numbers by the cell's own limits. On the card the same
controls were read at each cell's own size (tools/calibrate.py, PERF.md);
here the geometry is wider than the other tests' so that rounding has
sums long enough to show."""

from __future__ import annotations

import pytest
import torch

from benchmark.core import manifest
from benchmark.tests.tiny import CELLS, tiny_cell

torch.set_num_threads(2)
WIDER = dict(n_feat=129, emb_size=128, conv_channels=64, bank_channels=16, spk_emb_size=16)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_a_number(name):
    c = tiny_cell(name)
    c["config"]["hps"].update(WIDER)
    c["config"]["audio"].update(n_fft=256, win_length=128, hop_length=32)
    if c["traffic"]["driver"] == "convert":
        c["traffic"].update(utterances=12, duration_s={"median": 0.4, "sigma": 0.3, "min": 0.2, "max": 0.6})
    if c["traffic"]["driver"] == "serve":
        c["traffic"].update(check_sample=8, pool=8)
    cell = manifest.driver(c["traffic"]["driver"]).Cell(c, 2**31 + 3, "cpu")
    cell.setup()
    cell.window(0.2)
    cell.release()
    sound, control = cell.check(), cell.control("precision")
    lim = c["limits"]
    assert all(sound[k] <= lim[k] for k in lim), sound
    assert any(control[k] > lim[k] for k in control), (control, lim)
