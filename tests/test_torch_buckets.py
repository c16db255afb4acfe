"""PyTorch port, the bucket planner and the feature / units-only paths of
the Converter against the JAX package on the same parameters: plan_buckets,
_round_rows, _chunk_rows, _bucket_cap, _bucket_stats and fit_buckets equal
(exact); encode_units, encode_units_from_wavs and convert_features_multi
give JAX's units except for flips within a 1e-4 JAX logit margin, also with
fitted edges and a frame budget that regroups the rows; units-only equals
the full conversion's units bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu import convert as jax_convert
from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.data.speaker_norm import SpeakerStats as JaxSpeakerStats
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import convert as port_convert
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.data.speaker_norm import GLOBAL_KEY, SpeakerStats
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.params import from_flax, init_params

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
MARGIN = 1e-4  # a flipped unit must sit within this JAX logit margin
# STFT-magnitude rel-L2 of the port's PCM against JAX's: the two vocoders
# share the fast-GL recurrence but not its edges (tests/test_torch_convert.py
# states the measurement behind this bar).
PCM_REL_L2 = 0.25
SPEAKERS = ("S01", "S02")
TARGETS = ("V001", "V002")
# frame counts: buckets of 32 (pad 0, 12) and 64 (pad 4, 17, 30)
FRAMES = [32, 20, 60, 47, 34]


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(n_feat=129, speaker_norm=True)


@pytest.fixture(scope="module")
def params(hps):
    """Seeded flax variables ({"params": ...}) that both packages load."""
    return {k: {"params": v} for k, v in init_params(hps, seed=0).items()}


@pytest.fixture(scope="module")
def stats(hps):
    rng = np.random.default_rng(0)
    names = (GLOBAL_KEY, *SPEAKERS, *TARGETS)
    mean = {s: rng.uniform(0.2, 0.5, hps.n_feat).astype(np.float32) for s in names}
    std = {s: rng.uniform(0.05, 0.2, hps.n_feat).astype(np.float32) for s in names}
    return mean, std


@pytest.fixture(scope="module")
def feats(hps):
    rng = np.random.default_rng(3)
    return [rng.uniform(0.0, 1.0, (t, hps.n_feat)).astype(np.float32) for t in FRAMES]


def _pair(hps, params, stats, **kw):
    """JAX and port Converters on the same parameters and statistics."""
    j = jax_convert.Converter(hps, JaxAudioConfig(**ACFG), params["enc"], params["dec"],
                              stats=JaxSpeakerStats(*stats), gru_impl="scan", **kw)
    p = port_convert.Converter(hps, AudioConfig(**ACFG), *from_flax(params),
                               stats=SpeakerStats(*stats), device="cpu", **kw)
    return j, p


@pytest.fixture(scope="module")
def feature_pair(hps, params, stats):
    """One JAX/port pair for the feature paths, so JAX's programs compile
    once for both bucket plans."""
    return _pair(hps, params, stats, batch_size=2, bucket_frames=32)


def _margin(hps, params, x):
    """|logit 0 - logit 1| of the JAX encoder at the input's exact length."""
    logits = np.asarray(JaxEncoder(hps).apply(params["enc"], jnp.asarray(x)[None]))[0]
    return np.abs(logits[..., 0] - logits[..., 1])


def _feature_input(stats, f, spk):
    """A feature array as the JAX feature path encodes it: normalised, then
    rounded to bf16 on its wire."""
    x = JaxSpeakerStats(*stats).normalize(f, spk)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _assert_units(units, ref_units, input_of, hps, params):
    """Equal units, or flips within MARGIN of the JAX logits (computed only
    for an utterance with a flip: ``input_of(i)`` is its encoder input)."""
    assert len(units) == len(ref_units)
    for i, (u, r) in enumerate(zip(units, ref_units)):
        assert u.shape == r.shape and u.dtype == np.int32
        if (u != r).any():
            m = _margin(hps, params, input_of(i))
            assert (m[u != r] < MARGIN).all(), m[u != r]


def _pcm_rel_l2(a, b, cfg):
    def mag(p):
        re, im = port_audio.stft(torch.from_numpy(p.astype(np.float32) / 32768.0)[None], cfg)
        return torch.sqrt(re * re + im * im)[0].numpy()

    ma, mb = mag(a), mag(b)
    return float(np.linalg.norm(ma - mb) / np.linalg.norm(mb))


def _length_sets():
    rng = np.random.default_rng(7)
    return [rng.integers(20, 700, size=n).tolist() for n in (1, 9, 40)] + [
        [64, 64, 128, 60, 124, 126, 300],  # exact edges and 1..3-pad bumps
    ]


@pytest.mark.parametrize("cost", ["frames", "executed", "executed_dispatch"])
@pytest.mark.parametrize("target", [None, 0.05])
def test_plan_buckets_equals_jax(cost, target):
    """The planner's edges equal JAX's (exact) on seeded length multisets,
    in both cost models (and with a dispatch cost), with and without a
    padding target."""
    def cap_fn(tb):
        return max(1, 4096 // tb)

    kw = dict(target_overhead=target)
    if cost != "frames":
        kw.update(cap_fn=cap_fn, dispatch_cost=500.0 if cost == "executed_dispatch" else 0.0)
    for lengths in _length_sets():
        for k in (1, 2, 4, 8):
            assert port_convert.plan_buckets(lengths, k, 64, **kw) == \
                jax_convert.plan_buckets(lengths, k, 64, **kw)
    assert port_convert.plan_buckets([], 3, 64) == jax_convert.plan_buckets([], 3, 64) == []
    with pytest.raises(ValueError, match=">= 1"):
        port_convert.plan_buckets([10], 0, 64)


def test_round_and_chunk_rows_equal_jax():
    for cap in (1, 2, 3, 8, 12, 64, 128):
        for k in range(0, 300):
            assert port_convert._round_rows(k, cap) == jax_convert._round_rows(k, cap)
            assert port_convert._chunk_rows(k, cap) == jax_convert._chunk_rows(k, cap)


@pytest.mark.parametrize("budget", [None, 256, 8192])
def test_bucket_state_equals_jax(hps, params, stats, budget):
    """_bucket_cap, _bucket_of, fit_buckets (both cost models, with a
    padding target) and _bucket_stats equal the JAX Converter's."""
    j, p = _pair(hps, params, stats, batch_size=2, bucket_frames=32, frame_budget=budget)
    for tb in range(32, 2049, 32):
        assert p._bucket_cap(tb) == j._bucket_cap(tb)
    for k in range(1, 40):
        assert p._chunk_batch(k, 8) == j._chunk_batch(k, 8)
    for lengths in _length_sets():
        for cost in ("frames", "executed"):
            for target in (None, 0.1):
                assert p.fit_buckets(lengths, 3, target, cost) == \
                    j.fit_buckets(lengths, 3, target, cost)
                for t in range(1, 800, 7):
                    assert p._bucket_of(t) == j._bucket_of(t)
                assert port_convert._bucket_stats(p, lengths) == jax_convert._bucket_stats(j, lengths)
        p.bucket_edges = j.bucket_edges = None
        assert port_convert._bucket_stats(p, lengths) == jax_convert._bucket_stats(j, lengths)
    with pytest.raises(ValueError, match="cost_model"):
        p.fit_buckets([40], 2, cost_model="rows")


@pytest.mark.parametrize("fitted", [False, True])
def test_feature_paths_match_jax(hps, params, stats, feats, feature_pair, fitted):
    """encode_units and convert_features_multi against the JAX Converter:
    uniform buckets, then fitted edges with a frame budget whose caps
    exceed batch_size (the rows regroup: 4 to a 64-frame dispatch)."""
    j, p = feature_pair
    for conv in feature_pair:
        conv.frame_budget, conv.bucket_edges = (256 if fitted else None), None
    if fitted:
        edges = p.fit_buckets(FRAMES, 2, cost_model="executed")
        assert edges == j.fit_buckets(FRAMES, 2, cost_model="executed")
        assert max(p._bucket_cap(tb) for tb in edges) > p.batch_size
    srcs = [SPEAKERS[i % 2] for i in range(len(feats))]
    def input_of(i):
        return _feature_input(stats, feats[i], srcs[i])

    pu = p.encode_units(feats, src_speakers=srcs)
    _assert_units(pu, j.encode_units(feats, src_speakers=srcs), input_of, hps, params)
    with pytest.raises(ValueError, match="src_speakers"):
        p.encode_units(feats)

    ids = [2, 3]
    pcu, pw = p.convert_features_multi(feats, ids, tgt_names=list(TARGETS), src_speakers=srcs)
    jcu, jw = j.convert_features_multi(feats, ids, tgt_names=list(TARGETS), src_speakers=srcs)
    _assert_units(pcu, jcu, input_of, hps, params)
    for u, uo in zip(pcu, pu):  # units-only = full conversion, bit for bit
        np.testing.assert_array_equal(u, uo)
    acfg = AudioConfig(**ACFG)
    for k in range(len(ids)):
        for i, t in enumerate(FRAMES):
            assert pw[k][i].dtype == np.int16 and pw[k][i].shape == ((t - 1) * acfg.hop_length,)
            assert pw[k][i].shape == jw[k][i].shape
            assert _pcm_rel_l2(pw[k][i], jw[k][i], acfg) < PCM_REL_L2
    for missing in ("src_speakers", "tgt_names"):
        kwargs = dict(tgt_names=list(TARGETS), src_speakers=srcs)
        kwargs[missing] = None
        with pytest.raises(ValueError, match=missing):
            p.convert_features_multi(feats, ids, **kwargs)


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * seed
    y = sum(0.25 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
    y = y * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (y + 0.02 * rng.standard_normal(n)).astype(np.float32)


def test_encode_units_from_wavs_matches_jax(hps, params, stats):
    """Units straight from wavs (kernels 1 and 2 without the decoder or
    Griffin-Lim) against JAX, with a fitted edge under a frame budget that
    puts all three wavs in one dispatch (uniform buckets would take two);
    equal bit for bit to the port's own full conversion of the same wavs."""
    wavs = [_speechlike(n, s) for s, n in enumerate((4032, 3000, 2600))]  # 64, 47, 41 frames
    acfg = AudioConfig(**ACFG)

    def input_of(i):
        _, mag = jax_audio.wav_to_features(jnp.asarray(wavs[i]), JaxAudioConfig(**ACFG), method="fused")
        return JaxSpeakerStats(*stats).normalize(np.asarray(mag), GLOBAL_KEY)

    j, p = _pair(hps, params, stats, batch_size=2, bucket_frames=32, frame_budget=256)
    frames = [port_audio.n_frames_for(len(w), acfg) for w in wavs]
    assert p.fit_buckets(frames, 1) == j.fit_buckets(frames, 1) == [64]
    assert [len(c) for _, c, _ in p._dispatches(frames, frames)] == [3]
    pu = p.encode_units_from_wavs(wavs)
    _assert_units(pu, j.encode_units_from_wavs(wavs), input_of, hps, params)
    full, _ = p.convert_wavs_multi(wavs, [2], tgt_names=["V001"])
    for u, uf in zip(pu, full):
        np.testing.assert_array_equal(u, uf)


# frame counts whose executed plan changes with the dispatch cost (batch 2
# or 8, with and without a frame budget): 2 edges at N = 0, 1 at N = 400
DISPATCH_FRAMES = [20, 30, 45, 60, 90, 120]
DISPATCH_COSTS = (0.0, 100.0, 400.0, 1e4)


@pytest.mark.parametrize("batch", [2, 8])
def test_fit_buckets_dispatch_cost_equals_jax(hps, params, stats, batch):
    """fit_buckets(cost_model="executed", dispatch_cost_frames=N) and the
    plan's _bucket_stats equal the JAX Converter's (exact) at four N, with
    and without a frame budget; N changes the plan."""
    changed = 0
    for budget in (None, 1024):
        j, p = _pair(hps, params, stats, batch_size=batch, bucket_frames=64, frame_budget=budget)
        for lengths in _length_sets() + [DISPATCH_FRAMES]:
            plans = []
            for n in DISPATCH_COSTS:
                edges = p.fit_buckets(lengths, 3, cost_model="executed", dispatch_cost_frames=n)
                assert edges == j.fit_buckets(lengths, 3, cost_model="executed", dispatch_cost_frames=n)
                assert port_convert._bucket_stats(p, lengths) == jax_convert._bucket_stats(j, lengths)
                plans.append(edges)
            changed += any(e != plans[0] for e in plans)
    assert changed > 0


def test_cli_dispatch_cost_frames_plans_as_jax(tmp_path, hps, params, stats):
    """convert --units-only --adaptive-buckets 3 --bucket-cost-model executed
    --frame-budget 1024 --dispatch-cost-frames N from a directory of wavs:
    the CLI's bucket stats show the edges the JAX Converter fits to the same
    trimmed lengths (its default batch 8, bucket 64), at N = 0, 100 and 400,
    and 400 gives fewer edges."""
    from zerospeech_tts_tpu_torch import cli
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, save_wav, trim_silence
    from zerospeech_tts_tpu_torch.export import save_export

    acfg = AudioConfig(**ACFG)
    save_export(tmp_path / "bundle", hps, acfg, params["enc"]["params"], params["dec"]["params"],
                {"S01": 0, "V001": 2}, stats=SpeakerStats(*stats))
    for i, t in enumerate(DISPATCH_FRAMES):
        save_wav(tmp_path / "wavs" / f"u{i}.wav", _speechlike((t - 1) * acfg.hop_length, i), 16000)
    frames = [port_audio.n_frames_for(len(trim_silence(load_wav(p, 16000), acfg.top_db)), acfg)
              for p in sorted((tmp_path / "wavs").glob("*.wav"))]
    j = jax_convert.Converter(hps, JaxAudioConfig(**ACFG), params["enc"], params["dec"], frame_budget=1024,
                              stats=JaxSpeakerStats(*stats), gru_impl="scan")
    edges = {}
    for n in (0, 100, 400):
        out = cli.main(["convert", "--from-export", str(tmp_path / "bundle"), "--from-wavs", str(tmp_path / "wavs"),
                        "-result_dir", str(tmp_path / f"o{n}"), "--units-only", "--adaptive-buckets", "3",
                        "--bucket-cost-model", "executed", "--frame-budget", "1024",
                        "--dispatch-cost-frames", str(n), "--device", "cpu"])
        edges[n] = out["bucket_edges"]
        assert edges[n] == j.fit_buckets(frames, 3, cost_model="executed", dispatch_cost_frames=n)
        assert out["n_dispatches"] == jax_convert._bucket_stats(j, frames)["n_dispatches"]
    assert len(edges[400]) < len(edges[0]), edges
