"""PyTorch port, the mu-law PCM wire (dsp/mulaw.py, ``Converter(pcm_wire=
"mulaw")``, ``--wire-mulaw``) against the JAX package's.

Tolerances: the host lookup tables equal JAX's bit for bit; the torch
device codec's codes equal JAX's except where the float64 f * 127 lies
within BOUNDARY of a .5 rounding boundary (there the two f32 log1p may
round apart, by one code), its expansions within 1e-6; the Converter's
units equal JAX's mu-law Converter's except where JAX's logit margin (of
the mu-law-expanded input) is < MARGIN, its PCM within the STFT-magnitude
rel-L2 PCM_REL_L2 (tests/test_torch_convert.py states the measurement
behind that bar); the down-wire alone, on identical features, keeps an SNR
above 30 dB against the int16 wire (JAX's bar in tests/test_parallel.py)."""

import base64
import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.data.speaker_norm import SpeakerStats as JaxSpeakerStats
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.dsp import mulaw as jax_mulaw
from zerospeech_tts_tpu.models import Decoder as JaxDecoder
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch import convert as port_convert
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter
from zerospeech_tts_tpu_torch.data.speaker_norm import GLOBAL_KEY, SpeakerStats
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.dsp import mulaw
from zerospeech_tts_tpu_torch.params import from_flax
from zerospeech_tts_tpu_torch.serve import ConversionService, serve_http

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
MARGIN = 1e-4
PCM_REL_L2 = 0.25
BOUNDARY = 1e-5
SNR_DB = 30.0
PCM16 = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)  # every int16 sample
CODES = np.arange(256, dtype=np.uint8)  # every code


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * seed
    y = sum(0.25 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
    y = y * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (y + 0.02 * rng.standard_normal(n)).astype(np.float32)


# 4032 samples -> 64 frames (pad 0 at a 32/64 bucket); 3000 -> 47 (pad 17)
WAVS = [_speechlike(4032, 0), _speechlike(3000, 1)]
TGTS = ["V001", "V002"]


# ------------------------------------------------------------- the codec


def test_host_luts_equal_jax_bit_for_bit():
    np.testing.assert_array_equal(mulaw._encode_lut(), jax_mulaw._encode_lut())
    np.testing.assert_array_equal(mulaw._decode_lut(), jax_mulaw._decode_lut())
    np.testing.assert_array_equal(mulaw.mulaw_compress_host(PCM16), jax_mulaw.mulaw_compress_host(PCM16))
    np.testing.assert_array_equal(mulaw.mulaw_expand_host(CODES), jax_mulaw.mulaw_expand_host(CODES))
    assert mulaw.mulaw_compress_host(PCM16).dtype == np.uint8 and mulaw.mulaw_expand_host(CODES).dtype == np.int16
    assert mulaw.MU == jax_mulaw.MU and mulaw._LN1P_MU == jax_mulaw._LN1P_MU


def test_device_codec_equals_jax():
    y = PCM16.astype(np.float32) / 32768.0
    got = mulaw.mulaw_compress_device(torch.from_numpy(y)).numpy()
    ref = np.asarray(jax_mulaw.mulaw_compress_device(jnp.asarray(y)))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    y64 = y.astype(np.float64)
    f127 = np.sign(y64) * np.log1p(mulaw.MU * np.abs(y64)) / np.log1p(mulaw.MU) * 127.0
    near_half = np.abs(np.abs(f127 - np.floor(f127)) - 0.5) < BOUNDARY
    differ = got != ref
    assert not (differ & ~near_half).any(), np.flatnonzero(differ & ~near_half)[:10]
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1
    e_got = mulaw.mulaw_expand_device(torch.from_numpy(CODES)).numpy()
    e_ref = np.asarray(jax_mulaw.mulaw_expand_device(jnp.asarray(CODES)))
    assert e_got.dtype == np.float32 and np.abs(e_got - e_ref).max() <= 1e-6
    # the device codec agrees with the host tables to a code / an int16 step at full scale
    host = mulaw.mulaw_compress_host(PCM16)
    assert np.abs(got.astype(np.int32) - host.astype(np.int32)).max() <= 1
    assert np.abs(e_got * 32768.0 - mulaw.mulaw_expand_host(CODES)).max() <= 1.0


def test_silence_round_trips():
    assert mulaw.mulaw_compress_host(np.zeros(4, np.int16)).tolist() == [128] * 4
    assert mulaw.mulaw_expand_host(np.full(4, 128, np.uint8)).tolist() == [0] * 4
    assert mulaw.mulaw_compress_device(torch.zeros(4)).tolist() == [128] * 4
    assert mulaw.mulaw_expand_device(torch.full((4,), 128, dtype=torch.uint8)).tolist() == [0.0] * 4
    # the out-of-protocol code 0 stays in range, and full scale stays within [-1, 1]
    assert mulaw.mulaw_expand_device(torch.tensor([0, 1, 255], dtype=torch.uint8)).tolist() == [-1.0, -1.0, 1.0]
    assert mulaw.mulaw_compress_device(torch.tensor([-1.0, 1.0])).tolist() == [1, 255]


# --------------------------------------------------------- the Converter


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(n_feat=129, speaker_norm=True)


@pytest.fixture(scope="module")
def jax_params(hps):
    enc = JaxEncoder(hps).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, hps.n_feat)))
    dec = JaxDecoder(hps).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, hps.emb_size)), jnp.zeros((1,), jnp.int32)
    )
    return jax.tree.map(np.asarray, {"enc": enc, "dec": dec})


@pytest.fixture(scope="module")
def stats(hps):
    rng = np.random.default_rng(0)
    names = (GLOBAL_KEY, "V001", "V002")
    mean = {s: rng.uniform(0.2, 0.5, hps.n_feat).astype(np.float32) for s in names}
    std = {s: rng.uniform(0.05, 0.2, hps.n_feat).astype(np.float32) for s in names}
    return mean, std


def _port(hps, jax_params, stats, **kw):
    return Converter(hps, AudioConfig(**ACFG), *from_flax(jax_params), batch_size=2, bucket_frames=32,
                     stats=SpeakerStats(*stats), device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_mu(hps, jax_params, stats):
    return JaxConverter(hps, JaxAudioConfig(**ACFG), jax_params["enc"], jax_params["dec"], batch_size=2,
                        bucket_frames=32, stats=JaxSpeakerStats(*stats), gru_impl="scan", pcm_wire="mulaw")


def _mulaw_margin(hps, params, stats, wav):
    """JAX's logit margin of one utterance at exact length, from the input
    its mu-law up-wire gives the frontend."""
    codes = jax_mulaw.mulaw_compress_host(np.clip(np.rint(wav * 32768.0), -32768, 32767).astype(np.int16))
    y = jax_mulaw.mulaw_expand_device(jnp.asarray(codes))
    _, mag = jax_audio.wav_to_features(y, JaxAudioConfig(**ACFG), method="fused")
    x = JaxSpeakerStats(*stats).normalize(np.asarray(mag), GLOBAL_KEY)
    logits = np.asarray(JaxEncoder(hps).apply(params["enc"], jnp.asarray(x)[None]))[0]
    return np.abs(logits[..., 0] - logits[..., 1])


def _pcm_rel_l2(a, b, cfg):
    def mag(p):
        re, im = port_audio.stft(torch.from_numpy(p.astype(np.float32) / 32768.0)[None], cfg)
        return torch.sqrt(re * re + im * im)[0].numpy()

    ma, mb = mag(a), mag(b)
    return float(np.linalg.norm(ma - mb) / np.linalg.norm(mb))


def _snr_db(ref16, got16):
    ref = ref16.astype(np.float64) / 32768.0
    err = ref - got16.astype(np.float64) / 32768.0
    return 10 * np.log10(np.mean(ref**2) / max(np.mean(err**2), 1e-12))


def test_mulaw_converter_matches_jax(hps, jax_params, stats, jax_mu):
    """Wavs, full route: both wires of the mu-law Converter against JAX's;
    wavs come back int16 at the int16 wire's lengths."""
    acfg = AudioConfig(**ACFG)
    ju, jw = jax_mu.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
    conv = _port(hps, jax_params, stats, pcm_wire="mulaw")
    pu, pw = conv.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
    _, w16 = _port(hps, jax_params, stats).convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS)
    for i, wav in enumerate(WAVS):
        assert pu[i].shape == ju[i].shape
        flipped = pu[i] != ju[i]
        if flipped.any():
            m = _mulaw_margin(hps, jax_params, stats, wav)
            assert (m[flipped] < MARGIN).all(), m[flipped]
        for k in range(len(TGTS)):
            t = port_audio.n_frames_for(len(wav), acfg)
            assert pw[k][i].dtype == np.int16 and pw[k][i].shape == jw[k][i].shape == w16[k][i].shape
            assert pw[k][i].shape == ((t - 1) * acfg.hop_length,)
            assert set(np.unique(pw[k][i])) <= set(mulaw._decode_lut().tolist())  # codes, expanded on the host
            assert _pcm_rel_l2(pw[k][i], jw[k][i], acfg) < PCM_REL_L2


@pytest.fixture(scope="module")
def solver_setup(tiny_hps):
    """tests/test_parallel.py's _wav_test_setup, which JAX's down-wire bar
    was set on: no speaker norm, the JAX Solver's init from PRNGKey(0), two
    tones of 0.5 amplitude over a little noise."""
    from zerospeech_tts_tpu.train import Solver as JaxSolver

    h = tiny_hps.replace(n_feat=129)
    st = JaxSolver(h).init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, {"enc": st.enc, "dec": st.dec})
    rng = np.random.default_rng(7)
    wavs = [(0.5 * np.sin(2 * np.pi * (200 + 60 * i) * np.arange(n) / 16000.0)
             + 0.01 * rng.standard_normal(n)).astype(np.float32) for i, n in enumerate((3000, 5200))]
    return h, params, wavs


def test_down_wire_alone_keeps_30_db(solver_setup):
    """Features route (down-wire only), identical features through the
    port's int16 and mu-law wires: the only difference is the companding
    of the synthesised audio."""
    h, params, wavs = solver_setup
    acfg = AudioConfig(**ACFG)
    feats = [port_audio.wav_to_features(torch.from_numpy(w)[None], acfg)[1][0].numpy() for w in wavs]
    convs = [Converter(h, acfg, *from_flax(params), batch_size=2, bucket_frames=32, device="cpu", pcm_wire=pw)
             for pw in ("int16", "mulaw")]
    (u0, w0), (u1, w1) = (c.convert_features_multi(feats, [0]) for c in convs)
    for a, b in zip(u0, u1):
        np.testing.assert_array_equal(a, b)  # no up-wire on this route
    for a, b in zip(w0[0], w1[0]):
        assert a.shape == b.shape and b.dtype == np.int16
        assert _snr_db(a, b) > SNR_DB, _snr_db(a, b)


def test_units_only_from_wavs_takes_the_up_wire(hps, jax_params, stats, jax_mu, monkeypatch):
    """encode_units_from_wavs on the mu-law wire expands the codes on the
    device (counted), equals the mu-law full conversion's units bit for bit
    and JAX's mu-law units-only route within the margin."""
    conv = _port(hps, jax_params, stats, pcm_wire="mulaw")
    calls = []
    orig = port_convert.mulaw_expand_device
    monkeypatch.setattr(port_convert, "mulaw_expand_device", lambda u: calls.append(u.dtype) or orig(u))
    pu = conv.encode_units_from_wavs(WAVS)
    assert calls and set(calls) == {torch.uint8}
    full, _ = conv.convert_wavs_multi(WAVS, [1], tgt_names=TGTS[:1])
    ju = jax_mu.encode_units_from_wavs(WAVS)
    for i, wav in enumerate(WAVS):
        np.testing.assert_array_equal(pu[i], full[i])
        if (pu[i] != ju[i]).any():
            m = _mulaw_margin(hps, jax_params, stats, wav)
            assert (m[pu[i] != ju[i]] < MARGIN).all()


def test_split_over_devices_carries_the_wire(hps, jax_params, stats):
    """devices=["cpu", "cpu"] on the mu-law wire: the single device's units
    bit for bit and its PCM within one mu-law code (read back as int16)."""
    one = _port(hps, jax_params, stats, pcm_wire="mulaw")
    split = _port(hps, jax_params, stats, pcm_wire="mulaw", devices=["cpu", "cpu"])
    (u0, w0), (u1, w1) = (c.convert_wavs_multi(WAVS, [1, 2], tgt_names=TGTS) for c in (one, split))
    lut = mulaw._encode_lut()
    for a, b in zip(u0, u1):
        np.testing.assert_array_equal(a, b)
    for t0, t1 in zip(w0, w1):
        for a, b in zip(t0, t1):
            ca, cb = (lut[x.astype(np.int32) + 32768].astype(np.int32) for x in (a, b))
            assert a.shape == b.shape and np.abs(ca - cb).max() <= 1


def test_serve_answers_pcm16_on_the_mulaw_wire(hps, jax_params, stats):
    """A ConversionService over a mu-law Converter behind serve_http: one
    /convert request answers a 16 kHz PCM16 wav of the int16 wire's length
    and the Converter's units."""
    conv = _port(hps, jax_params, stats, pcm_wire="mulaw")
    svc = ConversionService(conv, {"V001": 1, "V002": 2}, window_ms=5.0)
    httpd = serve_http(svc, host="127.0.0.1", port=0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        buf = io.BytesIO()
        scipy.io.wavfile.write(buf, 16000, np.clip(np.rint(WAVS[1] * 32768.0), -32768, 32767).astype(np.int16))
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/convert?targets=V001&trim=0",
                                     data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(base64.b64decode(body["wavs"]["V001"])))
    _, w16 = _port(hps, jax_params, stats).convert_wavs_multi([WAVS[1]], [1], tgt_names=["V001"], trim=False)
    assert sr == 16000 and pcm.dtype == np.int16 and pcm.shape == w16[0][0].shape


def test_cli_wire_mulaw_on_convert_and_serve(tmp_path):
    """The parsers: convert takes --wire-mulaw and --wire-uint8, serve
    --wire-mulaw alone (as JAX's), convert-single neither."""
    p = cli.build_parser()
    a = p.parse_args(["convert", "-result_dir", "o", "--wire-mulaw", "--wire-uint8"])
    assert a.wire_mulaw and a.wire_uint8 and a.dispatch_cost_frames == 0.0
    assert p.parse_args(["serve", "--wire-mulaw"]).wire_mulaw
    for argv in (["serve", "--wire-uint8"], ["convert-single", "-result_dir", "o", "--source", "x.wav",
                                             "--target", "V001", "--wire-mulaw"]):
        with pytest.raises(SystemExit):
            p.parse_args(argv)
    with pytest.raises(ValueError, match="pcm_wire"):
        Converter(None, None, {}, {}, pcm_wire="alaw")  # refused before anything is built
