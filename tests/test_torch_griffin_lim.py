"""PyTorch port, kernel 4 (Griffin-Lim): the plain version against the JAX
vocoder (XLA ``griffin_lim`` and the Pallas kernel in interpret mode) by
magnitude consistency, the CPU dispatch of the wrapper and the vocoder
tail (de-emphasis); the CUDA kernel itself: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.ops.pallas_gl import griffin_lim_pallas
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.ops import griffin_lim as gl

torch.set_num_threads(1)


def _consistency(out, mag, cfg):
    """The JAX package's measure (tests/test_pallas.py): relative L2 misfit
    of the output's STFT magnitude to the target, edge frames excluded."""
    re, im = port_audio.stft(torch.tensor(out, dtype=torch.float32)[None], cfg)
    m2 = torch.sqrt(re * re + im * im)[0].numpy()
    return float(np.linalg.norm(m2[4:-4] - mag[4:-4]) / np.linalg.norm(mag[4:-4]))


def test_griffin_lim_plain_matches_jax_consistency():
    cfg = AudioConfig()
    y = (0.6 * np.sin(2 * np.pi * 440 * np.arange(12000) / 16000)).astype(np.float32)
    re, im = jax_audio.stft(jnp.asarray(y), JaxAudioConfig(), method="fused")
    mag = np.sqrt(np.asarray(re) ** 2 + np.asarray(im) ** 2)
    out_p = np.asarray(griffin_lim_pallas(jnp.asarray(mag), JaxAudioConfig(), n_iters=12, interpret=True))
    out_x = np.asarray(jax_audio.griffin_lim(jnp.asarray(mag), JaxAudioConfig(), n_iters=12))
    out_t = gl.griffin_lim_plain(torch.from_numpy(mag)[None], cfg, n_iters=12)[0].numpy()
    assert out_t.shape == out_x.shape == out_p.shape
    ct, cx, cp = (_consistency(o, mag, cfg) for o in (out_t, out_x, out_p))
    # bar of tests/test_pallas.py: within 0.02 (absolute) of each reference
    assert abs(ct - cx) < 0.02, (ct, cx)
    assert abs(ct - cp) < 0.02, (ct, cp)
    # Same recurrence as the Pallas kernel, whose bases and operands are
    # bf16. Signal rel-L2 against it, measured: 3.5e-2 with no iteration
    # (the bf16 rounding alone), 1.65e-1 after 12 (momentum 0.99 amplifies
    # the early rounding differences; the XLA path, whose edge frames
    # re-pad the trimmed signal, is 2.3e-1 away already at 0 iterations).
    rel = np.linalg.norm(out_t - out_p) / np.linalg.norm(out_p)
    assert rel < 0.25, rel
    out_p0 = np.asarray(griffin_lim_pallas(jnp.asarray(mag), JaxAudioConfig(), n_iters=0, interpret=True))
    out_t0 = gl.griffin_lim_plain(torch.from_numpy(mag)[None], cfg, n_iters=0)[0].numpy()
    rel0 = np.linalg.norm(out_t0 - out_p0) / np.linalg.norm(out_p0)
    assert rel0 < 0.05, rel0


def test_griffin_lim_plain_any_length_and_batch():
    """No t >= 2r floor (t=3 < 2r=8) and batch rows are independent."""
    cfg = AudioConfig(n_fft=256, hop_length=64, win_length=256, n_mels=20)
    rng = np.random.default_rng(0)
    mag = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 3, cfg.n_freq)).astype(np.float32))
    out = gl.griffin_lim_plain(mag, cfg, n_iters=3)
    assert out.shape == (2, 2 * cfg.hop_length) and torch.isfinite(out).all()
    one = gl.griffin_lim_plain(mag[1:], cfg, n_iters=3)
    torch.testing.assert_close(out[1:], one, atol=1e-6, rtol=0)


def test_griffin_lim_wrapper_cpu_takes_plain_path():
    cfg = AudioConfig(n_fft=256, hop_length=64, win_length=256, n_mels=20)
    mag = torch.rand(1, 20, cfg.n_freq, generator=torch.Generator().manual_seed(0))
    gl.launches = 0
    out = gl.griffin_lim(mag, cfg, n_iters=2)
    assert gl.launches == 0
    assert torch.equal(out, gl.griffin_lim_plain(mag, cfg, n_iters=2))


def test_de_emphasis_inverts_preemphasis_and_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5000)).astype(np.float32) * 0.1
    y = port_audio.de_emphasis(torch.from_numpy(x), 0.97)
    ref = np.stack([np.asarray(jax_audio.de_emphasis(jnp.asarray(r), 0.97)) for r in x])
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5, rtol=0)
    back = port_audio.preemphasis(y, 0.97)
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5, rtol=0)


# the card tests' configs (tests/test_torch_cuda.py CONFIGS)
FFT_CONFIGS = {"default": {}, "small": dict(n_fft=256, hop_length=64, win_length=256, n_mels=20),
               "hop50": dict(n_fft=256, hop_length=50, win_length=250, n_mels=20)}


@pytest.mark.parametrize("cfg_kw", FFT_CONFIGS.values(), ids=FFT_CONFIGS.keys())
def test_fft_formulation_matches_dft_bases(cfg_kw):
    """The offsets and scalings csrc/griffin_lim.cu mirrors: a windowed
    frame placed at lpad of an n_fft buffer through rfft gives frames @ ca
    and frames @ sa; irfft sliced to [lpad, lpad + win) and windowed gives
    sre @ cs + sim @ ss (irfft ignores the imaginary parts of DC and
    Nyquist, as the basis's zero ss rows do). f32 on both sides: rel-L2
    within 1e-5."""
    cfg = AudioConfig(**cfg_kw)
    ca, sa, cs, ss = (torch.from_numpy(a) for a in port_audio._fused_bases(cfg))
    lpad, win = (cfg.n_fft - cfg.win_length) // 2, cfg.win_length
    window = torch.from_numpy(port_audio._window(cfg)[lpad : lpad + win])
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((64, win)).astype(np.float32))
    buf = torch.zeros(64, cfg.n_fft)
    buf[:, lpad : lpad + win] = frames * window
    spec = torch.fft.rfft(buf, n=cfg.n_fft)

    def rel(a, b):
        return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()

    assert rel(spec.real, frames @ ca) < 1e-5
    assert rel(spec.imag, frames @ sa) < 1e-5
    sre, sim = (torch.from_numpy(rng.standard_normal((64, cfg.n_freq)).astype(np.float32)) for _ in range(2))
    back = torch.fft.irfft(torch.complex(sre, sim), n=cfg.n_fft)[:, lpad : lpad + win] * window
    assert rel(back, sre @ cs + sim @ ss) < 1e-5
