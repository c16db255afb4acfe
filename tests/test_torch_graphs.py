"""PyTorch port, the Converter's one dispatcher (``convert._Graphs``) on the
CPU: the bookkeeping that runs each dispatch shape as a CUDA graph on the
card (static inputs filled from a staging ring, a capture on the second
dispatch of a shape, replays after, outputs copied out at once), with the
capture emulated (the function run in place of a replay). Every route's
units and PCM are held bit-equal to the default CPU Converter, whose
dispatcher does not capture, calls with three and more dispatches of one
shape included (where a replay overwrites the static outputs of the one
before)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zerospeech_tts_tpu_torch import convert, ops
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.convert import Converter, _Graphs, _Staging
from zerospeech_tts_tpu_torch.data.speaker_norm import GLOBAL_KEY, SpeakerStats
from zerospeech_tts_tpu_torch.dsp.audio import n_frames_for
from zerospeech_tts_tpu_torch.dsp.wavio import trim_silence
from zerospeech_tts_tpu_torch.params import from_flax, init_params

torch.set_num_threads(1)

ACFG = AudioConfig(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
HPS = Hps(speaker_norm=True, n_feat=129, emb_size=16, spk_emb_size=4, n_speakers=3,
          bank_size=2, bank_channels=4, conv_channels=8)
TGTS = ["V001", "V002"]


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = sum(0.25 / k * np.sin(2 * np.pi * k * (140 + 30 * seed) * t) for k in range(1, 6))
    return (y * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t)) + 0.02 * rng.standard_normal(n)).astype(np.float32)


# at batch 2 and 32-frame buckets: 8 utterances in the 32-frame bucket (four
# full dispatches of one shape), 3 in the 64-frame one (a full and a tail),
# 1 alone in the 96-frame one
WAVS = ([_speechlike(1500 + 23 * i, i) for i in range(8)] + [_speechlike(3300 + 61 * i, 8 + i) for i in range(3)]
        + [_speechlike(5200, 11)])
FEATS = [np.random.default_rng(i).uniform(0, 1, (n, HPS.n_feat)).astype(np.float32)
         for i, n in enumerate((20, 23, 27, 21, 25, 30, 45, 60, 58, 90))]


def _stats():
    g = np.random.default_rng(7)
    names = [GLOBAL_KEY, *TGTS, "S0", "S1"]
    mean = {n: g.uniform(0.3, 0.6, HPS.n_feat).astype(np.float32) for n in names}
    std = {n: g.uniform(0.05, 0.2, HPS.n_feat).astype(np.float32) for n in names}
    return SpeakerStats(mean, std)


STATS = _stats()
SD = from_flax(init_params(HPS))


def _converter(**kw):
    return Converter(HPS, ACFG, *SD, batch_size=2, bucket_frames=32, stats=STATS, device="cpu", **kw)


def _pair(**kw):
    """(the default CPU Converter, run operator by operator; the same with
    its dispatcher's capture emulated)."""
    eager, graphs = _converter(**kw), _converter(**kw)
    assert not eager._graphs.capture  # the CPU does not capture
    graphs._graphs.capture = True
    return eager, graphs


def _same(a, b):
    """Entry points' returns bit-equal: (units, PCM per target) or units."""
    if isinstance(a, tuple):
        (ua, pa), (ub, pb) = a, b
        assert len(pa) == len(pb)
        for ta, tb in zip(pa, pb):
            for x, y in zip(ta, tb):
                assert x.dtype == y.dtype == np.int16 and np.array_equal(x, y)
    else:
        ua, ub = a, b
    assert len(ua) == len(ub)
    for x, y in zip(ua, ub):
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)


def _shapes(conv, frames, sizes):
    """[(bucket frames, batch rows)] of a call's dispatches, in order."""
    return [(tb, rows) for tb, _, rows in conv._dispatches(frames, sizes)]


def _wav_shapes(conv, wavs):
    trimmed = [trim_silence(w, conv.acfg.top_db) for w in wavs]
    return _shapes(conv, [n_frames_for(len(w), conv.acfg) for w in trimmed], [len(w) for w in trimmed])


ROUTES = {
    "int16": (dict(), lambda c: c.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)),
    "mulaw": (dict(pcm_wire="mulaw"), lambda c: c.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)),
    "bf16_features": (dict(), lambda c: c.convert_features_multi(FEATS, [2], tgt_names=["V002"],
                                                                  src_speakers=["S0", "S1"] * 5)),
    "uint8_features": (dict(wire="uint8"), lambda c: c.convert_features_multi(
        FEATS, [1, 2], tgt_names=TGTS, src_speakers=["S1", "S0"] * 5)),
    "units_from_wavs": (dict(), lambda c: c.encode_units_from_wavs(WAVS)),
    "units_mulaw": (dict(pcm_wire="mulaw"), lambda c: c.encode_units_from_wavs(WAVS)),
    "units_from_features": (dict(wire="uint8"), lambda c: c.encode_units(FEATS, src_speakers=["S0"] * 10)),
    "split": (dict(devices=["cpu", "cpu"]), lambda c: c.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)),
    "split_units": (dict(devices=["cpu", "cpu"]), lambda c: c.encode_units_from_wavs(WAVS)),
    "bf16_compute": (dict(compute_dtype="bfloat16"), lambda c: c.convert_wavs_multi(WAVS, [2], tgt_names=["V002"])),
}


@pytest.mark.parametrize("route", ROUTES.values(), ids=ROUTES.keys())
def test_every_route_is_bit_equal_to_eager_over_three_calls(route):
    """Three calls of the same route: the first runs each shape eagerly
    and captures the shapes it meets again, the later ones replay; every
    call returns what the eager Converter returns."""
    kw, call = route
    eager, graphs = _pair(**kw)
    want = call(eager)
    before = convert.graph_counts()
    for _ in range(3):
        _same(call(graphs), want)
    after = convert.graph_counts()
    n_shapes = len(graphs._graphs.entries)
    assert n_shapes >= 2
    assert after["captured"] - before["captured"] == n_shapes
    assert after["eager"] - before["eager"] == n_shapes


@pytest.mark.parametrize("route", ROUTES.values(), ids=ROUTES.keys())
def test_default_cpu_converter_dispatches_through_graphs_eagerly(route, monkeypatch):
    """A default CPU Converter sends every dispatch slice through
    ``_Graphs.run``, which keeps one entry a shape, captures none and
    counts every slice eager."""
    kw, call = route
    conv = _converter(**kw)
    keys = []
    run = _Graphs.run
    monkeypatch.setattr(_Graphs, "run", lambda self, key, *a: keys.append(key) or run(self, key, *a))
    before = convert.graph_counts()
    for _ in range(2):
        call(conv)
    after = convert.graph_counts()
    assert keys and {k: after[k] - before[k] for k in after} == {"eager": len(keys), "captured": 0, "replayed": 0}
    assert set(conv._graphs.entries) == set(keys) and len(keys) > len(set(keys))
    assert all(e.graph is None and not e.outs for e in conv._graphs.entries.values())


def test_three_dispatches_of_one_shape_each_get_their_own_outputs():
    """The 32-frame bucket's four dispatches share one graph. The emulated
    replay writes the static outputs as a replay does, so they end holding
    the last dispatch's rows; each utterance still gets its own."""
    eager, graphs = _pair()
    shapes = _wav_shapes(graphs, WAVS)
    assert shapes.count((32, 2)) == 4
    want = eager.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
    before = convert.graph_counts()
    _same(graphs.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS), want)
    after = convert.graph_counts()
    assert after["replayed"] - before["replayed"] == sum(shapes.count(s) - 1 for s in set(shapes))
    assert after["captured"] - before["captured"] == sum(1 for s in set(shapes) if shapes.count(s) > 1)
    frames = [n_frames_for(len(trim_silence(w, ACFG.top_db)), ACFG) for w in WAVS]
    chunks = [chunk for tb, chunk, rows in graphs._dispatches(frames, [len(w) for w in WAVS]) if tb == 32]
    (entry,) = [e for e in graphs._graphs.entries.values() if tuple(e.ins[0].shape) == (2, 32 * ACFG.hop_length - 1)]
    units = entry.outs[0].numpy()  # [2, latent frames, emb]
    for r, (first, last) in enumerate(zip(chunks[0], chunks[-1])):
        n = want[0][last].shape[0]
        assert np.array_equal(units[r, :n], want[0][last])
    assert any(not np.array_equal(units[r, : want[0][i].shape[0]], want[0][i]) for r, i in enumerate(chunks[0]))


def test_graph_key_counts_each_distinct_shape_once():
    """Keys: one a (route, rows, frames, targets) shape; the same shape on
    another route or with another number of targets is a key of its own."""
    _, graphs = _pair()
    shapes = _wav_shapes(graphs, WAVS)
    for _ in range(2):
        graphs.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
    assert len(graphs._graphs.entries) == len(set(shapes))
    graphs.convert_wavs_multi(WAVS, [2], tgt_names=["V002"])  # one target: new keys
    assert len(graphs._graphs.entries) == 2 * len(set(shapes))
    graphs.encode_units_from_wavs(WAVS)  # units only: new keys
    assert len(graphs._graphs.entries) == 3 * len(set(shapes))
    graphs.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)  # nothing new
    assert len(graphs._graphs.entries) == 3 * len(set(shapes))
    graphs.gl_iters = 3  # another vocoder: new keys
    graphs.convert_wavs_multi(WAVS[:1], [1, 2], tgt_names=TGTS)
    assert len(graphs._graphs.entries) == 3 * len(set(shapes)) + 1


def test_speaker_ids_and_statistics_follow_each_call():
    """A graph's speaker ids and target statistics are its own inputs,
    refilled by every dispatch: swapping the targets between calls swaps
    the PCM, as the eager Converter's."""
    eager, graphs = _pair()
    for tgts, ids in ((TGTS, [1, 2]), (TGTS[::-1], [2, 1]), (TGTS, [1, 2])):
        _same(graphs.convert_wavs_multi(WAVS, ids, tgt_names=tgts),
              eager.convert_wavs_multi(WAVS, ids, tgt_names=tgts))


def test_check_numerics_stays_eager():
    """check_numerics reads the logits back inside the path, which a
    capture cannot hold: its dispatches go through the one dispatcher,
    which captures none of them."""
    eager, checked = _converter(), _converter(check_numerics=True)
    assert not checked._graphs.capture
    before = convert.graph_counts()
    for _ in range(2):
        _same(checked.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS),
              eager.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS))
    after = convert.graph_counts()
    assert checked._graphs.entries and all(e.graph is None for e in checked._graphs.entries.values())
    assert after["captured"] == before["captured"] and after["replayed"] == before["replayed"]
    assert after["eager"] - before["eager"] == 4 * len(_wav_shapes(checked, WAVS))


def test_graph_counts_is_a_copy():
    counts = convert.graph_counts()
    assert set(counts) == {"eager", "captured", "replayed"}
    counts["captured"] += 100
    assert convert.graph_counts()["captured"] == counts["captured"] - 100


def test_capture_span_once_per_capture():
    _, graphs = _pair()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graphs.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
        graphs.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("convert.capture") == len(graphs._graphs.entries)
    assert names.count("convert.launch") == 2 * len(_wav_shapes(graphs, WAVS))


def test_add_launches_adds_and_takes_back():
    before = ops.launch_counts()
    ops.add_launches({"gru": 3, "griffin_lim": 1})
    assert ops.launch_counts() == {**before, "gru": before["gru"] + 3, "griffin_lim": before["griffin_lim"] + 1}
    ops.add_launches({"gru": 3, "griffin_lim": 1}, -1)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.int16, torch.uint8, torch.float32, torch.int64, torch.bfloat16])
def test_staging_views_hold_the_arrays(dtype):
    """Each array in a slot gets an aligned view of its own dtype and shape
    holding its values; the ring hands the slots out in turn and grows a
    slot to the largest dispatch."""
    g = torch.Generator().manual_seed(0)
    ring = _Staging(slots=2)
    dev = torch.device("cpu")
    seen = []
    for rows in (2, 8, 3):
        arrays = [(torch.rand(rows, 37, generator=g) * 100).to(dtype), torch.arange(rows * 5).reshape(rows, 5),
                  (torch.rand(rows, generator=g) * 100).to(dtype)]
        views, slot = ring.put(dev, arrays)
        seen.append(slot)
        for v, a in zip(views, arrays):
            assert v.dtype == a.dtype and v.shape == a.shape and torch.equal(v, a)
            assert v.data_ptr() % _Staging._ALIGN == slot[0].data_ptr() % _Staging._ALIGN
        assert slot[1] is None  # no event pending on the slot handed out
    assert seen[0] is seen[2] and seen[0] is not seen[1]
