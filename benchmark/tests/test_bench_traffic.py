"""The traffic generator and the yardstick's arithmetic: the same seed
gives the same traffic; other seeds the same sizes and gaps in another
order; the least-work counts match shapes worked by hand."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark.core import counts, traffic

SPEC = {"median": 3.0, "sigma": 0.5, "min": 1.0, "max": 12.0}
BIG = 2**31 + 12345


def test_same_seed_same_utterances():
    a = traffic.utterances(SPEC, 6, BIG, 16000)
    b = traffic.utterances(SPEC, 6, BIG, 16000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_other_seeds_same_sizes_other_order_and_content():
    a = traffic.utterances(SPEC, 12, 5, 16000)
    b = traffic.utterances(SPEC, 12, 6, 16000)
    assert sorted(map(len, a)) == sorted(map(len, b))
    assert [len(x) for x in a] != [len(x) for x in b]
    assert not np.array_equal(a[0][:1000], b[0][:1000])


def test_pass_of_the_corpus_cell():
    d = traffic.durations(SPEC, 128)
    assert d.min() == 1.0 and d.max() <= 12.0
    assert 430 < d.sum() < 440  # ~435 s of audio a pass
    assert abs(np.median(d) - 3.0) < 0.05


def test_gaps_are_a_poisson_processes_quantiles():
    g = traffic.gaps(10000, 50.0)
    assert abs(g.mean() - 1 / 50.0) < 1e-3 and (g > 0).all()


def test_balanced_labels():
    lab = traffic.balanced(102 * 3, 102, traffic.rng(1, 2))
    assert (np.bincount(lab) == 3).all()


def test_speechlike_is_loud_throughout():
    from benchmark.reference.dsp import trim_silence

    y = traffic.speechlike(48000, traffic.rng(3, 1))
    assert len(trim_silence(y, 15.0)) == len(y) and np.abs(y).max() < 1.0


def test_rfft_and_bound():
    assert counts.rfft_flops(1024) == 2.5 * 1024 * 10
    assert counts.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert counts.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)


def test_gru_counts_by_hand():
    # b=2, t=3, h=4: 2 x 6 row-steps x 4 x 12 products; xw 72 + ys 24 + wh 48 + bh 12 floats
    assert counts.gru_fwd(2, 3, 4) == (576.0, 4 * 156)
    assert counts.gru_fwd(2, 3, 4, "bfloat16") == (576.0, 2 * 156)
    assert counts.gru_fwd(2, 3, 4, steps=5)[0] == 2.0 * 5 * 4 * 12
    # backward: three products; xw, dxw 2 x 72, ys, dys 2 x 24, wh, dwh 2 x 48, bh, dbh 2 x 12
    assert counts.gru_bwd(2, 3, 4) == (1728.0, 4 * 312)


def test_griffin_lim_counts_by_hand():
    ac = {"gl_iters": 2, "win_length": 8, "hop_length": 2, "n_fft": 16}
    r = 2.5 * 16 * 4
    syn, ana = r + 16 + 2, 8 + r + 8 * 9
    fl, by = counts.griffin_lim(1, 5, ac)
    assert fl == pytest.approx(5 * (syn + 3 * (ana + syn) + 2 * 3 * 2))
    assert by == 4 * (5 * 9 + 4 * 2)


def test_least_work_of_a_conversion():
    from benchmark.core.conversion import least_s

    hp = {"downsample": 8, "emb_size": 1024, "conv_channels": 512}
    ac = {"gl_iters": 100, "win_length": 800, "hop_length": 200, "n_fft": 1024}
    dt = {"encoder": "float32", "decoder": "float32"}
    gl = least_s("griffin_lim", [240], 2, hp, ac, dt)
    assert gl == pytest.approx(counts.griffin_lim(2, 240, ac)[0] / 67e12)
    gru = least_s("gru_fwd", [240], 2, hp, ac, dt)
    enc, dec = counts.gru_fwd(1, 30, 512), counts.gru_fwd(2, 240, 512)
    assert enc[1] / 3.35e12 > enc[0] / 67e12  # one row: reading wh bounds the scan
    assert gru == pytest.approx(2 * enc[1] / 3.35e12 + dec[0] / 67e12)
    assert math.isfinite(least_s("gru_fwd", [81], 1, hp, ac, {"encoder": "bfloat16", "decoder": "bfloat16"}))
