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


def _unit_round(xa, xb, ma, mb, lg, tw, init):
    """One frame pair through a unit of csrc/griffin_lim.cu, in float64 and
    in the kernel's order: its radix passes, the fused last radix-2 stage
    with the projection (each thread t's two groups of butterflies), the
    passes transposed. Returns the pair's time samples times n_fft."""
    n = 1 << lg
    h, tu = n // 2, n // 8
    passes = gl.gl_passes(lg)
    offs = np.cumsum([0] + [(r - 1) * ns for r, ns in passes[1:]])  # pass i >= 1 at offs[i - 1]

    def dft(v, inv):
        k = np.arange(len(v))
        return np.exp((2j if inv else -2j) * np.pi * np.outer(k, k) / len(v)) @ v

    def twid(i, r_, ns, m):
        return tw[offs[i - 1] + (r_ - 1) * ns + m] if i and r_ else 1.0

    def subdfts(i):
        r_, ns = passes[i]
        for t in range(tu):
            for q in range(8 // r_):
                j = t + q * tu
                yield r_, ns, j, j % ns, (j // ns) * ns * r_ + j % ns

    def project(z1, z2, fa, fb):
        xa_, xb_ = (z1 + np.conj(z2)) / 2, (z1 - np.conj(z2)) / 2j
        xa_ *= fa / max(abs(xa_), 1e-8)
        xb_ *= fb / max(abs(xb_), 1e-8)
        return xa_ + 1j * xb_, np.conj(xa_) + 1j * np.conj(xb_)

    z = (xa + 1j * xb).astype(complex)
    for i in range(len(passes)) if not init else ():
        out = np.full(n, np.nan, complex)
        for r_, ns, j, m, o in subdfts(i):
            v = np.array([z[j + r * (n // r_)] * twid(i, r, ns, m) for r in range(r_)])
            out[o + np.arange(r_) * ns] = dft(v, False)
        z = out
    twf = tw[offs[-1]:]
    out = np.full(n, np.nan, complex)
    for t in range(tu):
        e = n // 4 - t if t else n // 8
        for e1, e2, merged in ((t, h - t if t else n // 4, t == 0), (e, h - e, False)):
            w1, w2 = twf[e1], twf[e2]
            if init:  # zero phase
                za1, zb1, za2, zb2 = (ma[f] + 1j * mb[f] for f in (e1, h - e1, e2, h - e2))
            else:
                y1, y2, y3, y4 = z[e1], z[e1 + h] * w1, z[e2], z[e2 + h] * w2
                za1, zb2 = project(y1 + y2, y1 + y2 if merged else y3 - y4, ma[e1], mb[e1])
                zb1, za2 = project(y1 - y2, y1 - y2 if merged else y3 + y4, ma[h - e1], mb[h - e1])
                if merged:
                    za2, zb2 = project(y3 + y4, y3 - y4, ma[e2], mb[e2])
            out[[e1, e1 + h, e2, e2 + h]] = za1 + zb1, (za1 - zb1) * np.conj(w1), za2 + zb2, (za2 - zb2) * np.conj(w2)
    z = out
    for i in reversed(range(len(passes))):
        out = np.full(n, np.nan, complex)
        for r_, ns, j, m, o in subdfts(i):
            v = dft(z[o + np.arange(r_) * ns], True)
            out[j + np.arange(r_) * (n // r_)] = [v[r] * np.conj(twid(i, r, ns, m)) for r in range(r_)]
        z = out
    assert not np.isnan(z).any()
    return z


@pytest.mark.parametrize("mode", ["iter", "init"])
@pytest.mark.parametrize("lg", range(4, 11))
def test_gl_kernel_decomposition_matches_fft(lg, mode):
    """The kernel's pass plan and twiddle table (_gl_tables, gl_passes) in
    the kernel's order, in float64, against numpy's FFTs: a frame pair's
    projected spectra back to samples, zero phase in the init round. Every
    bin is written once (the fused groups cover all butterflies)."""
    cfg = AudioConfig(n_fft=1 << lg, hop_length=(1 << lg) // 4, win_length=1 << lg)
    _, tw, _ = gl._gl_tables(cfg, "cpu")
    tw = tw.double().numpy() @ np.array([1, 1j])
    n = cfg.n_fft
    rng = np.random.default_rng(lg)
    xa, xb = rng.standard_normal((2, n))
    ma, mb = rng.uniform(0.0, 2.0, (2, n // 2 + 1))
    got = _unit_round(xa, xb, ma, mb, lg, tw, mode == "init")
    full = lambda m: m[np.minimum(np.arange(n), n - np.arange(n))]  # noqa: E731
    if mode == "init":
        want = np.fft.ifft(full(ma) + 1j * full(mb)) * n
    else:
        sa, sb = np.fft.fft(xa), np.fft.fft(xb)
        want = np.fft.ifft(full(ma) * sa / np.maximum(abs(sa), 1e-8) + 1j * full(mb) * sb / np.maximum(abs(sb), 1e-8)) * n
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_gl_plan_waves_from_blocks_and_capacity():
    assert gl.plan_of([128, 400, 1, 132]) == gl.Plan(128, 400, 1, 4)
    assert gl.plan_of([128, 132, 1, 132]).waves == 1
    assert gl.plan_of([128, 133, 1, 132]).waves == 2
    assert gl.plan_of([32, 528, 4, 132]).waves == 1
    assert gl.plan_of([32, 529, 4, 132]).waves == 2
    with pytest.raises(RuntimeError):  # a block that fits no SM
        gl.plan_of([128, 10, 0, 132])


def test_gl_round_waves_accumulate_across_calls(monkeypatch):
    """The wrapper's bookkeeping on a stubbed C entry (meta tensors stand in
    for the card's): last_plan is the newest call's, round_waves the sum of
    every call's waves a round, launches one a call."""
    import contextlib
    import ctypes

    from zerospeech_tts_tpu_torch.ops import build

    cfg = AudioConfig()
    r = cfg.win_length // cfg.hop_length
    seen = []

    def entry(*args):
        b, t = args[10], args[11]
        blocks = b * -(-(t - 1 + r) // (16 - (r - 1)))
        (ctypes.c_int * 4).from_address(args[9])[:] = [128, blocks, 1, 132]
        seen.append(args[12:16])
        return 0

    monkeypatch.setattr(build, "load", lambda name: None)
    monkeypatch.setattr(build, "bind", lambda lib, fn, *counts: entry)
    monkeypatch.setattr(build, "require", lambda *a, **k: None)
    monkeypatch.setattr(build, "on_card", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream_of", lambda t: 0)
    monkeypatch.setattr(gl, "launches", 0)
    monkeypatch.setattr(gl, "round_waves", 0)
    monkeypatch.setattr(gl, "last_plan", None)
    waves = []
    for b, t in ((16, 448), (6, 192), (2, 960), (16, 448)):
        out = gl.griffin_lim(torch.empty(b, t, cfg.n_freq, device="meta"), cfg, n_iters=3)
        assert out.shape == (b, (t - 1) * cfg.hop_length)
        blocks = b * -(-(t - 1 + r) // 13)
        assert gl.last_plan == gl.Plan(128, blocks, 1, -(-blocks // 132))
        waves.append(gl.last_plan.waves)
    assert waves == [5, 1, 2, 5]
    assert gl.round_waves == sum(waves) and gl.launches == 4
    assert seen[0] == (10, cfg.win_length, cfg.hop_length, 3)  # lg, win, hop, n_iters
