"""PyTorch port, kernel 1 (fused frontend): the plain version against the
JAX frontend (XLA ``fused`` path and the Pallas kernel in interpret mode),
and the CPU dispatch of the kernel wrapper (the CUDA kernel itself:
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.ops.pallas_frontend import wav_to_features_pallas
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.ops import frontend

torch.set_num_threads(1)

SMALL = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20)
# Measured (this seed, CPU f32 on both sides): max |port - JAX| 5.6e-5
# (default config) and 2.5e-5 (small config) in normalised dB; the largest
# differences sit in the DC bin, where the zero-mean signal's window sum
# cancels and the two frameworks' f32 summation orders round differently.
ATOL = 1e-4
# A pure tone leaves the DC and far bins near the 1e-5 floor, where that
# cancellation reaches 4.4e-4 (measured); held to the JAX package's own
# Pallas-vs-XLA bar (tests/test_pallas.py).
ATOL_TONE = 2e-3


def _speechlike(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1330 * t)
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _jax_both(y, cfg_kw, length=None):
    jc = JaxAudioConfig(**cfg_kw)
    fused = jax_audio.wav_to_features(jnp.asarray(y), jc, method="fused", length=length)
    pallas = wav_to_features_pallas(jnp.asarray(y), jc, interpret=True, length=length)
    return [tuple(np.asarray(a) for a in out) for out in (fused, pallas)]


@pytest.mark.parametrize("cfg_kw", [{}, SMALL], ids=["default", "small"])
def test_frontend_plain_matches_jax_exact_length(cfg_kw):
    y = _speechlike(12800)
    mel, mag = port_audio.wav_to_features(torch.from_numpy(y), AudioConfig(**cfg_kw))
    for jmel, jmag in _jax_both(y, cfg_kw):
        assert mel.shape == jmel.shape and mag.shape == jmag.shape
        np.testing.assert_allclose(mel.numpy(), jmel, atol=ATOL, rtol=0)
        np.testing.assert_allclose(mag.numpy(), jmag, atol=ATOL, rtol=0)


@pytest.mark.parametrize("cfg_kw", [{}, SMALL], ids=["default", "small"])
def test_frontend_plain_matches_jax_bucket_padded(cfg_kw):
    cfg = AudioConfig(**cfg_kw)
    n_true = 9000
    y = _speechlike(12800, seed=1)
    y[n_true:] = 0.0  # zero bucket padding after the true samples
    t_true = port_audio.n_frames_for(n_true, cfg)
    mel, mag = port_audio.wav_to_features(torch.from_numpy(y), cfg, length=torch.tensor([n_true]))
    for jmel, jmag in _jax_both(y, cfg_kw, length=n_true):
        np.testing.assert_allclose(mel.numpy()[:t_true], jmel[:t_true], atol=ATOL, rtol=0)
        np.testing.assert_allclose(mag.numpy()[:t_true], jmag[:t_true], atol=ATOL, rtol=0)
    # the true frames equal the exact-length frontend of the true samples
    emel, emag = port_audio.wav_to_features(torch.from_numpy(y[:n_true]), cfg)
    np.testing.assert_array_equal(mag.numpy()[:t_true], emag.numpy())
    np.testing.assert_array_equal(mel.numpy()[:t_true], emel.numpy())


def test_frontend_plain_pure_tone_at_reference_bar():
    y = (0.5 * np.sin(np.arange(12800) * 0.13)).astype(np.float32)
    mel, mag = port_audio.wav_to_features(torch.from_numpy(y), AudioConfig())
    for jmel, jmag in _jax_both(y, {}):
        np.testing.assert_allclose(mel.numpy(), jmel, atol=ATOL_TONE, rtol=0)
        np.testing.assert_allclose(mag.numpy(), jmag, atol=ATOL_TONE, rtol=0)


def test_frontend_batched_rows_with_lengths():
    cfg = AudioConfig(**SMALL)
    rows = [_speechlike(6399, seed=s) for s in range(3)]
    lens = [6399, 5000, 3205]
    batch = np.zeros((3, 6399), np.float32)
    for i, (r, n) in enumerate(zip(rows, lens)):
        batch[i, :n] = r[:n]
    _, mag = port_audio.wav_to_features(torch.from_numpy(batch), cfg, length=torch.tensor(lens))
    for i, n in enumerate(lens):
        _, one = port_audio.wav_to_features(torch.from_numpy(rows[i][:n]), cfg)
        np.testing.assert_array_equal(mag[i, : one.shape[0]].numpy(), one.numpy())


def test_frontend_wrapper_cpu_takes_plain_path():
    cfg = AudioConfig(**SMALL)
    y = torch.from_numpy(_speechlike(3000))[None]
    ypad = port_audio.mirror_pad(port_audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2)
    t = port_audio.n_frames_for(3000, cfg)
    frontend.launches = 0
    mel, mag = frontend.fused_frontend(ypad, cfg, t)
    pmel, pmag = frontend.frontend_plain(ypad, cfg, t)
    assert frontend.launches == 0
    assert torch.equal(mel, pmel) and torch.equal(mag, pmag)
    assert mag.shape == (1, t, cfg.n_freq) and mel.shape == (1, t, cfg.n_mels)


# The card configs (tests/test_torch_cuda.py); "hop50": hop and win not
# multiples of 4.
KERNEL_CONFIGS = {"default": {}, "small": SMALL,
                  "hop50": dict(n_fft=256, hop_length=50, win_length=250, n_mels=20)}


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("cfg_kw", KERNEL_CONFIGS.values(), ids=KERNEL_CONFIGS.keys())
def test_frontend_fft_formulation_matches_dft_bases(cfg_kw):
    """What the kernel computes: frame t is ypad[t*hop : t*hop + n_fft]
    times the n_fft window (its support at lpad), and its rfft equals the
    plain version's segs @ ca and segs @ sa (rel-L2 1e-5)."""
    cfg = AudioConfig(**cfg_kw)
    n = 40 * cfg.hop_length + 17
    y = torch.from_numpy(np.stack([_speechlike(n, s) for s in range(2)]))
    ypad = port_audio.mirror_pad(port_audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2)
    t = port_audio.n_frames_for(n, cfg)
    ca, sa, _ = (a.double() for a in frontend._constants(cfg, "cpu"))
    segs = port_audio._fused_segments(ypad, cfg, t).double()
    window = torch.from_numpy(port_audio._window(cfg)).double()
    frames = torch.stack([ypad[:, i * cfg.hop_length : i * cfg.hop_length + cfg.n_fft] for i in range(t)], 1)
    assert frames.shape == (2, t, cfg.n_fft)  # the last frame ends inside ypad
    spec = torch.fft.rfft(frames.double() * window, n=cfg.n_fft)
    assert _rel(spec.real, segs @ ca) < 1e-5
    assert _rel(spec.imag, segs @ sa) < 1e-5


@pytest.mark.parametrize("cfg_kw", KERNEL_CONFIGS.values(), ids=KERNEL_CONFIGS.keys())
def test_frontend_mel_bands_cover_basis(cfg_kw):
    """The kernel's mel product: each band summed over its nonzero run
    [lo, hi) of _mel_basis (the host's tables) equals mag @ melT (rel-L2
    1e-6), and the runs hold every nonzero of the basis."""
    cfg = AudioConfig(**cfg_kw)
    basis = port_audio._mel_basis(cfg)
    bands, weights = frontend.mel_bands(cfg)
    assert bands.shape == (3, cfg.n_mels) and weights.size == int((bands[1] - bands[0]).sum())
    rebuilt = np.zeros_like(basis)
    for m, (lo, hi, off) in enumerate(bands.T):
        rebuilt[m, lo:hi] = weights[off : off + hi - lo]
    np.testing.assert_array_equal(rebuilt, basis)
    mag = torch.from_numpy(np.random.default_rng(0).uniform(0, 3, (2, 30, cfg.n_freq)).astype(np.float32))
    w = torch.from_numpy(weights)
    banded = torch.stack([mag[..., lo:hi] @ w[off : off + hi - lo] for lo, hi, off in bands.T], -1)
    assert _rel(banded, mag @ frontend._constants(cfg, "cpu")[2]) < 1e-6
