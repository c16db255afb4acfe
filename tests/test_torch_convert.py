"""PyTorch port, the whole slice: wav -> units -> wav conversion in the
challenge-exact configuration against the JAX Converter on the same
parameters (``Converter.convert_wavs_multi`` and ``convert_wav_dir`` through
the port's CLI and export bundle), plus the CLI's refusals."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.convert import convert_wav_dir as jax_convert_wav_dir
from zerospeech_tts_tpu.data.speaker_norm import SpeakerStats as JaxSpeakerStats
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.models import Decoder as JaxDecoder
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter, read_units, units_text
from zerospeech_tts_tpu_torch.data.speaker_norm import GLOBAL_KEY, SpeakerStats
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.export import load_export, save_export
from zerospeech_tts_tpu_torch.params import from_flax

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
MARGIN = 1e-4  # a flipped unit must sit within this JAX logit margin
# Relative L2 distance between the STFT magnitudes of the port's and the
# JAX package's PCM. The two vocoders share the fast-GL recurrence but not
# its edges (the port follows the Pallas kernel's overlap-add tails, the
# JAX CPU program the XLA path's reflect re-pad), and GL-2 leaves those
# differences in the audio. Measured on these inputs: 0.040 to 0.157 over
# the 2 utterances x 2 targets; the units agree on every bit (1.0).
PCM_REL_L2 = 0.25


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    f0 = 140 + 40 * seed
    y = sum(0.25 / k * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 6))
    y = y * (0.7 + 0.3 * np.sin(2 * np.pi * 3 * t))
    return (y + 0.02 * rng.standard_normal(n)).astype(np.float32)


# 4032 samples -> 64 frames (pad 0 at a 32/64 bucket); 3000 -> 47 (pad 17)
WAVS = [_speechlike(4032, 0), _speechlike(3000, 1)]


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
    """Seeded per-speaker statistics (mean, std dicts)."""
    rng = np.random.default_rng(0)
    names = (GLOBAL_KEY, "V001", "V002")
    mean = {s: rng.uniform(0.2, 0.5, hps.n_feat).astype(np.float32) for s in names}
    std = {s: rng.uniform(0.05, 0.2, hps.n_feat).astype(np.float32) for s in names}
    return mean, std


@pytest.fixture(scope="module")
def jax_conv(hps, jax_params, stats):
    """The JAX reference, shared so its bucket program compiles once: both
    wavs land in the 64-frame bucket (pad 0 and pad 17) at bucket_frames 32
    and at the CLI's 64 alike."""
    return JaxConverter(
        hps, JaxAudioConfig(**ACFG), jax_params["enc"], jax_params["dec"],
        batch_size=2, bucket_frames=32, stats=JaxSpeakerStats(*stats), gru_impl="scan",
    )


def _jax_logits(hps, params, wav, stats=None):
    """JAX encoder logits of one utterance at exact length (the margins)."""
    _, mag = jax_audio.wav_to_features(jnp.asarray(wav), JaxAudioConfig(**ACFG), method="fused")
    x = np.asarray(mag)
    if stats is not None:
        x = stats.normalize(x, GLOBAL_KEY)
    return np.asarray(JaxEncoder(hps).apply(params["enc"], jnp.asarray(x)[None]))[0]


def _assert_units(units, ref_units, ref_logits):
    assert units.shape == ref_units.shape
    flipped = units != ref_units
    margin = np.abs(ref_logits[..., 0] - ref_logits[..., 1])
    assert (margin[flipped] < MARGIN).all(), margin[flipped]


def _pcm_rel_l2(a, b, cfg):
    def mag(p):
        re, im = port_audio.stft(torch.from_numpy(p.astype(np.float32) / 32768.0)[None], cfg)
        return torch.sqrt(re * re + im * im)[0].numpy()

    ma, mb = mag(a), mag(b)
    return float(np.linalg.norm(ma - mb) / np.linalg.norm(mb))


def test_convert_wavs_multi_matches_jax(hps, jax_params, stats, jax_conv):
    acfg = AudioConfig(**ACFG)
    tgts = ["V001", "V002"]
    ju, jw = jax_conv.convert_wavs_multi(WAVS, [1, 2], tgt_names=tgts)
    pconv = Converter(hps, acfg, *from_flax(jax_params), batch_size=2, bucket_frames=32,
                      stats=SpeakerStats(*stats))
    pu, pw = pconv.convert_wavs_multi(WAVS, [1, 2], tgt_names=tgts)
    for i, wav in enumerate(WAVS):
        t = port_audio.n_frames_for(len(wav), acfg)
        assert pu[i].shape == (-(-t // hps.downsample), hps.emb_size)
        _assert_units(pu[i], ju[i], _jax_logits(hps, jax_params, wav, jax_conv.stats))
        for k in range(2):
            assert pw[k][i].dtype == np.int16 and pw[k][i].shape == jw[k][i].shape
            assert pw[k][i].shape == ((t - 1) * acfg.hop_length,)
            assert _pcm_rel_l2(pw[k][i], jw[k][i], acfg) < PCM_REL_L2


def test_cli_convert_matches_jax_convert_wav_dir(tmp_path, hps, jax_params, stats, jax_conv):
    """Export bundle (model.npz + stats.npz) -> the port's CLI vs the JAX
    convert_wav_dir on the same parameters and statistics."""
    speakers = {"S01": 0, "V001": 1, "V002": 2}
    save_export(tmp_path / "bundle", hps, AudioConfig(**ACFG), jax_params["enc"],
                jax_params["dec"], speakers, stats=SpeakerStats(*stats))
    b = load_export(tmp_path / "bundle")
    assert dataclasses.asdict(b.hps) == dataclasses.asdict(hps) and b.speakers == speakers
    np.testing.assert_array_equal(b.stats.std["V002"], stats[1]["V002"])
    for i, wav in enumerate(WAVS):
        save_wav(tmp_path / "wavs" / f"utt{i}.wav", wav, 16000)

    jax_convert_wav_dir(jax_conv, tmp_path / "wavs", tmp_path / "jax", {"V001": 1, "V002": 2})
    out = cli.main([
        "convert", "--from-export", str(tmp_path / "bundle"), "--from-wavs", str(tmp_path / "wavs"),
        "-result_dir", str(tmp_path / "port"), "--target", "V001", "V002",
        "--gl-iters", "2", "--batch-size", "2", "--device", "cpu",
    ])
    assert out["n_utterances"] == 2 and out["n_wavs"] == 4

    acfg = AudioConfig(**ACFG)
    for i in range(2):
        pu = read_units(tmp_path / "port" / "units" / f"utt{i}.txt")
        ju = read_units(tmp_path / "jax" / "units" / f"utt{i}.txt")
        wav = (scipy.io.wavfile.read(tmp_path / "wavs" / f"utt{i}.wav")[1] / 32768.0).astype(np.float32)
        logits = _jax_logits(hps, jax_params, wav, jax_conv.stats)
        _assert_units(pu, ju, logits)
        if (pu == ju).all():  # the text format itself, byte for byte
            assert (tmp_path / "port" / "units" / f"utt{i}.txt").read_bytes() == \
                (tmp_path / "jax" / "units" / f"utt{i}.txt").read_bytes()
        for tgt in ("V001", "V002"):
            sr_p, pw = scipy.io.wavfile.read(tmp_path / "port" / tgt / f"utt{i}.wav")
            sr_j, jw = scipy.io.wavfile.read(tmp_path / "jax" / tgt / f"utt{i}.wav")
            assert sr_p == sr_j == 16000 and pw.dtype == np.int16 and pw.shape == jw.shape
            assert _pcm_rel_l2(pw, jw, acfg) < PCM_REL_L2

    single = cli.main([
        "convert-single", "--from-export", str(tmp_path / "bundle"),
        "--source", str(tmp_path / "wavs" / "utt1.wav"), "--target", "V002",
        "-result_dir", str(tmp_path / "single"), "--gl-iters", "2", "--device", "cpu",
    ])
    _assert_units(read_units(single["units"]), ju, logits)  # ju, logits: utt1
    assert scipy.io.wavfile.read(single["wav"])[1].shape == (46 * acfg.hop_length,)


def test_units_text_format():
    u = np.array([[0, 1, 1], [1, 0, 0]], np.int32)
    assert units_text(u) == "0 1 1\n1 0 0"
    assert units_text(np.zeros((0, 3), np.int32)) == ""


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    (tmp_path / "b").mkdir()
    with pytest.raises(SystemExit) as e:
        cli.main(["convert", "--from-export", str(tmp_path / "b"), "--from-wavs", str(tmp_path),
                  "-result_dir", str(tmp_path / "o")])  # --device defaults to cuda
    assert "no CUDA device" in str(e.value)
    with pytest.raises(RuntimeError):
        Converter(*_tiny_converter_args(), device="cuda")


def _tiny_converter_args():
    from zerospeech_tts_tpu_torch.config import Hps
    from zerospeech_tts_tpu_torch.params import init_params

    h = Hps(speaker_norm=False, n_feat=129, emb_size=16, spk_emb_size=4, n_speakers=2,
            bank_size=2, bank_channels=4, conv_channels=8)
    return (h, AudioConfig(**ACFG), *from_flax(init_params(h)))


def test_load_export_refuses_orbax_bundle(tmp_path):
    (tmp_path / "model").mkdir()
    (tmp_path / "meta.json").write_text(json.dumps({"version": 1, "feat": "lin", "step": 0}))
    with pytest.raises(FileNotFoundError, match="orbax"):
        load_export(tmp_path)


def test_load_export_refuses_mel_bundle(tmp_path):
    (tmp_path / "meta.json").write_text(json.dumps({"version": 1, "feat": "mel", "step": 0}))
    with pytest.raises(NotImplementedError, match="feat='mel'"):
        load_export(tmp_path)
