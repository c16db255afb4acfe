"""PyTorch port, the bf16 configurations of the Converter (``--bf16``,
``--bf16 --enc-f32``) against the exact (all-f32) configuration and
against the JAX Converter's, to the JAX package's own bars
(tests/test_parallel.py ``test_bf16_converter_runs`` and
``test_enc_f32_units_exact_under_bf16``): the f32 encoder under a bf16
decoder gives the exact units wherever the logit margin is >= 1e-4; the
all-bf16 units agree with the exact ones at > 0.9; the PCM is int16 and
finite. Then the CLI's flags: --bf16, --enc-f32, and the refused wires."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter, read_units
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.export import save_export
from zerospeech_tts_tpu_torch.params import from_flax, init_params

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
MARGIN = 1e-4


@pytest.fixture(scope="module")
def setup(tiny_hps):
    """The JAX test's geometry (n_feat 129, tiny audio), seeded weights both
    packages load, and its two noisy tones of 3,000 and 5,200 samples."""
    h = tiny_hps.replace(n_feat=129)
    tree = init_params(h, seed=0)
    rng = np.random.default_rng(7)
    wavs = []
    for i, n in enumerate((3000, 5200)):
        t = np.arange(n) / 16000.0
        wavs.append((0.5 * np.sin(2 * np.pi * (200 + 60 * i) * t) + 0.01 * rng.standard_normal(n)).astype(np.float32))
    return h, tree, wavs


def _port(h, tree, **kw):
    enc, dec = from_flax(tree)
    return Converter(h, AudioConfig(**ACFG), enc, dec, batch_size=2, bucket_frames=32, device="cpu", **kw)


def _jax(h, tree, **kw):
    return JaxConverter(h, JaxAudioConfig(**ACFG), {"params": tree["enc"]}, {"params": tree["dec"]},
                        batch_size=2, bucket_frames=32, gru_impl="scan", **kw)


def _margins(h, tree, wav):
    """|logit 0 - logit 1| of the JAX f32 encoder at the utterance's exact
    length (the JAX frontend's features)."""
    _, mag = jax_audio.wav_to_features(jnp.asarray(wav), JaxAudioConfig(**ACFG), method="fused")
    lg = np.asarray(JaxEncoder(h).apply({"params": tree["enc"]}, mag[None]))[0]
    return np.abs(lg[..., 0] - lg[..., 1])


def _agree(us, ref):
    return float(np.mean([(a == b).mean() for a, b in zip(us, ref)]))


def test_enc_f32_units_exact_under_bf16(setup):
    """Exact, --bf16 --enc-f32 and --bf16 from wavs, port and JAX. The
    port's exact units equal JAX's exact units, and its enc-f32 units equal
    its exact units, wherever JAX's logit margin is >= 1e-4 (on the CPU
    eager PyTorch has no cross-program fusion: they are equal outright).
    All-bf16 agrees with exact at > 0.9. Read: port enc-f32 vs exact 1.0,
    port bf16 vs exact 0.9986, JAX bf16 vs JAX exact 1.0."""
    h, tree, wavs = setup
    u_exact, w_exact = _port(h, tree).convert_wavs_multi(wavs, [0, 1], trim=False)
    u_enc, w_enc = _port(h, tree, compute_dtype="bfloat16", encoder_dtype="float32").convert_wavs_multi(
        wavs, [0, 1], trim=False)
    u_fast, w_fast = _port(h, tree, compute_dtype="bfloat16").convert_wavs_multi(wavs, [0, 1], trim=False)
    j_exact, _ = _jax(h, tree).convert_wavs_multi(wavs, [0, 1], trim=False)
    j_fast, _ = _jax(h, tree, compute_dtype="bfloat16").convert_wavs_multi(wavs, [0, 1], trim=False)
    for i, wav in enumerate(wavs):
        m = _margins(h, tree, wav)
        for u in (u_exact[i], u_enc[i]):
            assert u.shape == j_exact[i].shape
            assert (m[u != j_exact[i]] < MARGIN).all(), m[u != j_exact[i]]
        assert (m[u_enc[i] != u_exact[i]] < MARGIN).all()
    agree_enc, agree_fast, agree_jax = _agree(u_enc, u_exact), _agree(u_fast, u_exact), _agree(j_fast, j_exact)
    print(f"units vs exact: port enc-f32 {agree_enc:.4f}, port bf16 {agree_fast:.4f}, JAX bf16 {agree_jax:.4f}")
    assert agree_enc >= 0.999 and agree_fast > 0.9
    for ws in (w_enc, w_fast):
        for k in range(2):
            for w, ref in zip(ws[k], w_exact[k]):
                assert w.dtype == np.int16 and w.shape == ref.shape
                assert np.isfinite(w.astype(np.float32)).all()


def test_bf16_converter_runs_on_features(setup):
    """JAX's test_bf16_converter_runs: uniform features [32, 129] through
    convert_features_multi, f32 and bf16: bf16 flips only a small fraction
    of the units (> 0.9 agreement; read 1.0) and its PCM is finite;
    the bf16 decoder's output reaches the vocoder in f32."""
    h, tree, _ = setup
    feats = [np.random.default_rng(0).uniform(0, 1, (32, 129)).astype(np.float32)]
    u32, _ = _port(h, tree).convert_features_multi(feats, [0])
    conv = _port(h, tree, compute_dtype="bfloat16")
    assert conv.decoder.dtype == torch.bfloat16 and conv.conv_encoder.dtype == torch.bfloat16
    assert conv.encoder.dtype == torch.float32  # units only: the JAX package's f32 programs
    u16, w16 = conv.convert_features_multi(feats, [0])
    assert np.isfinite(w16[0][0].astype(np.float32)).all() and w16[0][0].dtype == np.int16
    agree = float((u32[0] == u16[0]).mean())
    print(f"features: bf16 vs f32 unit agreement {agree:.4f}")
    assert agree > 0.9, agree


def test_units_only_is_the_f32_encoder_in_every_config(setup):
    """As in the JAX package, whose units-only programs run the uncast
    parameters: --units-only gives the exact config's units under --bf16."""
    h, tree, wavs = setup
    ref = _port(h, tree).encode_units_from_wavs(wavs, trim=False)
    got = _port(h, tree, compute_dtype="bfloat16").encode_units_from_wavs(wavs, trim=False)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_converter_refuses_other_dtypes_and_feats(setup):
    h, tree, _ = setup
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _port(h, tree, compute_dtype="float16")
    with pytest.raises(ValueError, match="lin or mel"):
        _port(h, tree, feat="wav")


def test_cli_bf16_flags_and_refused_wires(tmp_path, setup):
    """convert --bf16 [--enc-f32] and convert-single --bf16 through the CLI
    from a bundle: enc-f32's unit files equal the exact run's; the bf16
    runs write int16 wavs. The wire flags run: --wire-mulaw writes int16
    wavs of the exact run's lengths, and --wire-uint8 on the wav route (no
    feature wire there) writes the exact run's units."""
    h, tree, wavs = setup
    save_export(tmp_path / "bundle", h, AudioConfig(**ACFG), tree["enc"], tree["dec"], {"S01": 0, "V001": 1})
    for i, w in enumerate(wavs):
        save_wav(tmp_path / "wavs" / f"u{i}.wav", w, 16000)
    base = ["convert", "--from-export", str(tmp_path / "bundle"), "--from-wavs", str(tmp_path / "wavs"),
            "--target", "V001", "--device", "cpu"]
    for name, flags in (("exact", []), ("enc", ["--bf16", "--enc-f32"]), ("fast", ["--bf16"])):
        cli.main([*base, "-result_dir", str(tmp_path / name), *flags])
    for i in range(len(wavs)):
        ue = read_units(tmp_path / "exact" / "units" / f"u{i}.txt")
        assert np.array_equal(read_units(tmp_path / "enc" / "units" / f"u{i}.txt"), ue)
        assert read_units(tmp_path / "fast" / "units" / f"u{i}.txt").shape == ue.shape
        sr, pcm = scipy.io.wavfile.read(tmp_path / "fast" / "V001" / f"u{i}.wav")
        assert sr == 16000 and pcm.dtype == np.int16
    out = cli.main(["convert-single", "--from-export", str(tmp_path / "bundle"), "--source",
                    str(tmp_path / "wavs" / "u0.wav"), "--target", "V001", "-result_dir",
                    str(tmp_path / "single"), "--bf16", "--enc-f32", "--device", "cpu"])
    assert np.array_equal(read_units(out["units"]), read_units(tmp_path / "exact" / "units" / "u0.txt"))
    cli.main([*base, "-result_dir", str(tmp_path / "mulaw"), "--wire-mulaw"])
    cli.main([*base, "-result_dir", str(tmp_path / "uint8"), "--wire-uint8"])
    for i in range(len(wavs)):
        ue = read_units(tmp_path / "exact" / "units" / f"u{i}.txt")
        assert np.array_equal(read_units(tmp_path / "uint8" / "units" / f"u{i}.txt"), ue)
        assert read_units(tmp_path / "mulaw" / "units" / f"u{i}.txt").shape == ue.shape
        want = scipy.io.wavfile.read(tmp_path / "exact" / "V001" / f"u{i}.wav")[1]
        sr, pcm = scipy.io.wavfile.read(tmp_path / "mulaw" / "V001" / f"u{i}.wav")
        assert sr == 16000 and pcm.dtype == np.int16 and pcm.shape == want.shape
