"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version on the card. Every test skips where no CUDA device is visible.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a card and no JAX (where tests/conftest.py cannot load):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.dsp import audio
from zerospeech_tts_tpu_torch.ops import frontend, griffin_lim, gru
from zerospeech_tts_tpu_torch.tools.workload import fullscale, gru_scan_bf16_state

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _noisy_tones(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    y = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1330 * t)
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


# "hop50": hop and win not multiples of 4
CONFIGS = {"default": {}, "small": dict(n_fft=256, hop_length=64, win_length=256, n_mels=20),
           "hop50": dict(n_fft=256, hop_length=50, win_length=250, n_mels=20)}
# every other n_fft kernels 1 and 4 take: their FFTs are built per log2
# n_fft, n_fft = P x L with P = L (even) or P = 2L (odd: 32, 128, 512)
FFT_SIZES = {f"n{n}": dict(n_fft=n, hop_length=n // 4, win_length=n) for n in (16, 32, 64, 128, 512)}


@pytest.mark.parametrize("t", [500, 499], ids=["even", "odd"])  # odd: a ragged last frame pair
@pytest.mark.parametrize("cfg_kw", {**CONFIGS, **FFT_SIZES}.values(), ids={**CONFIGS, **FFT_SIZES}.keys())
def test_frontend_kernel_matches_plain(cuda, cfg_kw, t):
    cfg = AudioConfig(**cfg_kw)
    n = 512 * cfg.hop_length - 1  # 512 frames
    y = torch.from_numpy(np.stack([_noisy_tones(n, s) for s in range(8)])).to(cuda)
    lens = torch.tensor([n, n - 900, n // 2, n // 3, n, n - 1, 1000, n // 5], device=cuda)
    ypad = audio.mirror_pad(audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2, lens).contiguous()
    before = frontend.launches
    mel, mag = frontend.fused_frontend(ypad, cfg, t)
    torch.cuda.synchronize()
    assert frontend.launches == before + 1
    pmel, pmag = frontend.frontend_plain(ypad, cfg, t)
    torch.testing.assert_close(mag, pmag, atol=1e-4, rtol=0)
    torch.testing.assert_close(mel, pmel, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cfg_kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_frontend_kernel_matches_plain_on_loud_frames(cuda, cfg_kw):
    """Full-scale frames (a loud tone over a quiet one, a square wave,
    speech at full scale), whose quiet bins lie well above the fixed
    near-floor range while both sums' rounding grows with the frame."""
    cfg = AudioConfig(**cfg_kw)
    n = 128 * cfg.hop_length - 1  # 128 frames
    y = torch.from_numpy(np.stack([fullscale(n, s) for s in range(8)])).to(cuda)
    ypad = audio.mirror_pad(audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2).contiguous()
    mel, mag = frontend.fused_frontend(ypad, cfg, 128)
    torch.cuda.synchronize()
    pmel, pmag = frontend.frontend_plain(ypad, cfg, 128)
    torch.testing.assert_close(mag, pmag, atol=1e-4, rtol=0)
    torch.testing.assert_close(mel, pmel, atol=1e-4, rtol=0)


@pytest.mark.parametrize("t", [1, 7, 64, 512])
@pytest.mark.parametrize("b", [1, 2, 6, 16, 64, 128, 192, 256])
def test_gru_kernel_matches_plain(cuda, b, t):
    """Kernel 2 (one cooperative launch a scan) against gru_scan_plain at
    1e-4, for H = 40, 41 (3H not a multiple of 4: rows staged as floats)
    and 512, forward, reverse and reverse masked with ragged lengths. B =
    192 and 256: the decoder's and encoder's rows under a 128-row
    frame-budget cap."""
    for h in (40, 41, 512):
        for reverse, masked in ((False, False), (True, False), (True, True)):
            gen = torch.Generator().manual_seed(b * t + h)
            xw = torch.randn(b, t, 3 * h, generator=gen).to(cuda)
            wh = (torch.randn(h, 3 * h, generator=gen) / math.sqrt(h)).to(cuda)
            bh = (0.1 * torch.randn(3 * h, generator=gen)).to(cuda)
            lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda) if masked else None
            before = gru.launches
            out = gru.gru_scan(xw, wh, bh, lens, reverse=reverse)
            torch.cuda.synchronize()
            assert gru.launches == before + 1, (h, reverse, masked)
            ref = gru.gru_scan_plain(xw, wh, bh, lens, reverse=reverse)
            err = (out - ref).abs().max().item()
            assert err <= 1e-4, (h, reverse, masked, err)


def test_gru_kernel_slices_a_batch_too_large_for_one_launch(cuda):
    """B = 2,048 at H = 512 does not fit one cooperative launch on an H100
    (its blocks' xw rows outgrow the shared memory): kernel 2 runs it as
    two slices of 1,024 rows, a launch each, and still matches
    gru_scan_plain at 1e-4, forward and reverse masked."""
    b, t, h = 2048, 3, 512
    rows = gru.scan_plan(cuda, b, h)[6]
    assert rows == 1024, rows
    gen = torch.Generator().manual_seed(b)
    xw = torch.randn(b, t, 3 * h, generator=gen).to(cuda)
    wh = (torch.randn(h, 3 * h, generator=gen) / math.sqrt(h)).to(cuda)
    bh = (0.1 * torch.randn(3 * h, generator=gen)).to(cuda)
    lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda)
    for lengths, reverse in ((None, False), (lens, True)):
        before = gru.launches
        out = gru.gru_scan(xw, wh, bh, lengths, reverse=reverse)
        torch.cuda.synchronize()
        assert gru.launches == before + 2, reverse
        err = (out - gru.gru_scan_plain(xw, wh, bh, lengths, reverse=reverse)).abs().max().item()
        assert err <= 1e-4, (reverse, err)


BF16_ULP = 2.0**-8  # one bf16 ulp at |y| in [0.5, 1): the top of the GRU's output range


def _gru_inputs_typed(b, t, h, seed, device, dtype):
    gen = torch.Generator().manual_seed(seed)
    xw = torch.randn(b, t, 3 * h, generator=gen).to(device, dtype)
    wh = (torch.randn(h, 3 * h, generator=gen) / math.sqrt(h)).to(device, dtype)
    bh = (0.1 * torch.randn(3 * h, generator=gen)).to(device, dtype)
    return xw, wh, bh, gen


BF16_CONTROL_RATIO = 0.5  # mean |kernel - plain| against mean |bf16-state control - plain|


def _hold_bf16(out, xw, wh, bh, lens=None, reverse=False):
    """Kernel 2's bf16 output against the plain version: within one bf16
    ulp, and on average far nearer it than the control that rounds its
    state to bf16 between steps (a kernel doing that would sit near the
    control). Returns (max |diff|, mean |diff|, the control's mean)."""
    ref = gru.gru_scan_plain(xw, wh, bh, lens, reverse=reverse).float()
    diff = (out.float() - ref).abs()
    ctl = (gru_scan_bf16_state(xw, wh, bh, lens, reverse=reverse).float() - ref).abs()
    assert diff.max().item() <= BF16_ULP, diff.max().item()
    assert diff.mean().item() <= BF16_CONTROL_RATIO * ctl.mean().item(), (diff.mean().item(), ctl.mean().item())
    return diff.max().item(), diff.mean().item(), ctl.mean().item()


@pytest.mark.parametrize("t", [64, 512])
@pytest.mark.parametrize("b", [1, 16, 64])
def test_gru_bf16_kernel_matches_plain(cuda, b, t):
    """Kernel 2's bf16 mode (bf16 xw, wh, bh and ys; f32 state) against
    gru_scan_plain in bf16 at H = 512, forward and reverse masked with
    ragged lengths: every element within one bf16 ulp at the top of the
    GRU's range (2^-8), and the mean difference at most half the bf16-state
    control's. Not bit for bit: the two sum each step's product in other
    f32 orders, and once a state lying on a bf16 rounding boundary rounds
    apart for the next product (after some tens of steps), the two
    recurrences drift ~1e-4 apart and a share of ys rounds one ulp apart
    (88-98% of the elements were equal on an H100). One launch a scan,
    counted apart from the f32 mode's."""
    h = 512
    for reverse, masked in ((False, False), (True, True)):
        xw, wh, bh, gen = _gru_inputs_typed(b, t, h, b * t + 7, cuda, torch.bfloat16)
        lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda) if masked else None
        before, before32 = gru.bf16_launches, gru.launches
        out = gru.gru_scan(xw, wh, bh, lens, reverse=reverse)
        torch.cuda.synchronize()
        assert (gru.bf16_launches, gru.launches) == (before + 1, before32), (reverse, masked)
        assert out.dtype == torch.bfloat16 and out.shape == (b, t, h)
        got = _hold_bf16(out, xw, wh, bh, lens, reverse)
        print(f"B={b} T={t} reverse={reverse}: max |diff| {got[0]:.3e}, mean {got[1]:.3e}, control's {got[2]:.3e}")


def test_gru_wide_h_raises_in_f32_and_states_bf16(cuda):
    """H = 2,048: no spread of kernel 2 fits in f32 (a block's columns of wh
    outgrow its shared memory), nor of kernel 3; the wrappers and the GRU
    layer raise a ValueError that names H, with nothing launched. In bf16
    the columns take half the bytes: the test states whether kernel 2 fits
    there and, if it does, holds it against its plain version."""
    from zerospeech_tts_tpu_torch.models.layers import GRU

    b, t, h = 2, 8, 2048
    assert gru.scan_plan(cuda, b, h)[0] == 0 and gru.bwd_plan(cuda, b, h)[0] == 0
    xw, wh, bh, _ = _gru_inputs_typed(b, t, h, 5, cuda, torch.float32)
    launched, bwd = gru.launches, gru.bwd_launches
    with pytest.raises(ValueError, match="H=2048"):
        gru.gru_scan(xw, wh, bh)
    with pytest.raises(ValueError, match="H=2048"):
        gru.gru_bwd(xw, wh, bh, xw[..., :h].contiguous(), xw[..., :h].contiguous())
    with torch.no_grad(), pytest.raises(ValueError, match="H=2048"):
        GRU(64, h).to(cuda)(torch.zeros(b, t, 64, device=cuda))
    assert (gru.launches, gru.bwd_launches) == (launched, bwd)
    fits_bf16 = gru.scan_plan(cuda, b, h, torch.bfloat16)[0] > 0
    print(f"H=2048 bf16: kernel 2 fits: {fits_bf16}; plan {gru.scan_plan(cuda, b, h, torch.bfloat16)}")
    if fits_bf16:
        xw16, wh16, bh16, _ = _gru_inputs_typed(b, t, h, 5, cuda, torch.bfloat16)
        out = gru.gru_scan(xw16, wh16, bh16)
        torch.cuda.synchronize()
        _hold_bf16(out, xw16, wh16, bh16)


GL_CONFIGS = {**CONFIGS, **FFT_SIZES}


@pytest.mark.parametrize("b,t,cfg_name", [(4, 512, "default"), (1, 2500, "default"),
                                          (2, 2100, "default"),  # conversion-shaped, past 2,048 frames
                                          (2, 5, "default"), (3, 100, "hop50"),
                                          *((3, 100, f"n{n}") for n in (16, 32, 64, 128, 512))])
def test_griffin_lim_kernel_matches_plain(cuda, b, t, cfg_name):
    cfg = AudioConfig(**GL_CONFIGS[cfg_name])
    gen = torch.Generator().manual_seed(t)
    mag = (torch.rand(b, t, cfg.n_freq, generator=gen) ** 3).to(cuda)
    before = griffin_lim.launches
    out = griffin_lim.griffin_lim(mag, cfg, n_iters=8)
    torch.cuda.synchronize()
    assert griffin_lim.launches == before + 1
    ref = griffin_lim.griffin_lim_plain(mag, cfg, n_iters=8)
    assert out.shape == ref.shape == (b, (t - 1) * cfg.hop_length)
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    assert rel < 1e-3, rel
    # the worst row, and its first and last win_length samples alone
    # (untrimmed overlap-add tails, full wss envelope)
    e = min(cfg.win_length, out.shape[1])
    for a, b_ in ((out, ref), (torch.cat([out[:, :e], out[:, -e:]], -1),
                                torch.cat([ref[:, :e], ref[:, -e:]], -1))):
        row = (torch.linalg.norm(a - b_, dim=-1) / torch.linalg.norm(b_, dim=-1)).max().item()
        assert row < 1e-3, row


def _consistency(out, amp, cfg):
    re, im = audio.stft(out, cfg)
    m2 = torch.sqrt(re * re + im * im)[:, 4:-4]
    return (torch.linalg.norm(m2 - amp[:, 4:-4]) / torch.linalg.norm(amp[:, 4:-4])).item()


# The conversion path's Griffin-Lim calls (tools/workload.py, 8 wavs x 2
# targets): rows x bucket frames
CONVERSION_GL = [(6, 512), (2, 384), (2, 320), (4, 256), (2, 128)]


@pytest.mark.parametrize("b,t", CONVERSION_GL, ids=[f"{b}x{t}" for b, t in CONVERSION_GL])
def test_griffin_lim_kernel_gl100_conversion_shapes(cuda, b, t):
    """GL-100 at the conversion path's shapes: magnitude consistency within
    1e-3 of the plain version's. The signals' rel-L2 is printed, not
    barred: momentum 0.99 over 100 iterations amplifies rounding."""
    cfg = AudioConfig()
    n = t * cfg.hop_length - 1
    y = torch.from_numpy(np.stack([_noisy_tones(n, s) for s in range(b)])).to(cuda)
    _, mag = audio.wav_to_features(y, cfg)
    amp = (audio.db_norm_to_amp(mag, cfg) ** cfg.gl_power).contiguous()
    out = griffin_lim.griffin_lim(amp, cfg, n_iters=100)
    torch.cuda.synchronize()
    ref = griffin_lim.griffin_lim_plain(amp, cfg, n_iters=100)
    ck, cp = _consistency(out, amp, cfg), _consistency(ref, amp, cfg)
    print(f"GL-100 {b}x{t}: consistency kernel {ck:.5f} plain {cp:.5f}, signal rel-L2 {_rel(out, ref):.3e}")
    assert torch.isfinite(out).all() and abs(ck - cp) <= 1e-3, (ck, cp)


def _gru_inputs(b, t, h, seed, device):
    gen = torch.Generator().manual_seed(seed)
    xw = torch.randn(b, t, 3 * h, generator=gen)
    wh = torch.randn(h, 3 * h, generator=gen) / math.sqrt(h)
    bh = 0.1 * torch.randn(3 * h, generator=gen)
    return xw.to(device), wh.to(device), bh.to(device)


def _rel(a, b):
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


@pytest.mark.parametrize("b,t,h,reverse", [
    (32, 128, 512, False),  # decoder, training
    (64, 16, 512, False),   # encoder forward direction, training (pairs on)
    (64, 16, 512, True),    # encoder backward direction
    (128, 16, 512, False),  # encoder at --train-batch-size 64: rows staged in two chunks
    (128, 16, 512, True),
    (512, 4, 512, False),   # a large batch: seven chunks a step
    (3, 7, 40, False),      # ragged: B, H not multiples of the tiles
    (3, 7, 41, False),      # 3H not a multiple of 4: rows staged as floats
    (3, 7, 40, True),
    (5, 1, 40, False),      # T = 1: no step crosses the grid barrier
    (5, 1, 40, True),
])
def test_gru_bwd_kernel_matches_plain(cuda, b, t, h, reverse):
    """Kernel 3 (one cooperative launch for the whole recurrence) against
    gru_bwd_plain on the same card: dxw max abs <= 1e-4, dwh and dbh
    rel-L2 <= 1e-4 (f32 sums over B*T rows in another order). A reverse
    scan's backward pass walks time itself; it must also equal the
    forward-time pass on flipped tensors (the conjugation it replaces)."""
    xw, wh, bh = _gru_inputs(b, t, h, t + h, cuda)
    ys = gru.gru_scan(xw, wh, bh, reverse=reverse)
    dys = torch.randn(b, t, h, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = gru.bwd_launches
    dxw, dwh, dbh = gru.gru_bwd(xw, wh, bh, ys, dys, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.bwd_launches == before + 1
    rxw, rwh, rbh = gru.gru_bwd_plain(xw, wh, bh, ys, dys, reverse=reverse)
    assert (dxw - rxw).abs().max().item() <= 1e-4
    if t == 1:  # h_{t-1} = 0 at the only step: dwh vanishes
        assert not dwh.any() and not rwh.any()
    else:
        assert _rel(dwh, rwh) <= 1e-4
    assert _rel(dbh, rbh) <= 1e-4
    if reverse:
        fxw, fwh, fbh = gru.gru_bwd(*(a.flip(1).contiguous() if a.dim() == 3 else a
                                      for a in (xw, wh, bh, ys, dys)))
        assert (fxw.flip(1) - dxw).abs().max().item() <= 1e-4
        assert _rel(fbh, dbh) <= 1e-4 and (t == 1 or _rel(fwh, dwh) <= 1e-4)


def test_gru_scan_grads_match_cudnn_gru(cuda):
    """GRUScan (kernels 2 and 3) against cuDNN nn.GRU with the same weights
    (weight_ih = wi^T, weight_hh = wh^T, bias_ih = bi, bias_hh = bh; the
    same r, z, n gate math), decoder shape: rel-L2 <= 1e-4 on every
    gradient."""
    b, t, i, h = 32, 128, 640, 512
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, t, i, generator=gen).to(cuda)
    wi = (torch.randn(i, 3 * h, generator=gen) / math.sqrt(i)).to(cuda)
    bi = (0.1 * torch.randn(3 * h, generator=gen)).to(cuda)
    _, wh, bh = _gru_inputs(1, 1, h, 5, cuda)
    dys = torch.randn(b, t, h, generator=gen).to(cuda)
    ours = [a.clone().requires_grad_(True) for a in (x, wi, bi, wh, bh)]
    ys = gru.GRUScan.apply((ours[0] @ ours[1] + ours[2]).contiguous(), ours[3], ours[4], False)
    ys.backward(dys)
    ref = torch.nn.GRU(i, h, batch_first=True).to(cuda)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(wi.T)
        ref.weight_hh_l0.copy_(wh.T)
        ref.bias_ih_l0.copy_(bi)
        ref.bias_hh_l0.copy_(bh)
    xr = x.clone().requires_grad_(True)
    yr, _ = ref(xr)
    yr.backward(dys)
    assert _rel(ys.detach(), yr.detach()) <= 1e-4
    for g, r in ((ours[0].grad, xr.grad), (ours[1].grad, ref.weight_ih_l0.grad.T),
                 (ours[2].grad, ref.bias_ih_l0.grad), (ours[3].grad, ref.weight_hh_l0.grad.T),
                 (ours[4].grad, ref.bias_hh_l0.grad)):
        assert _rel(g, r) <= 1e-4


def test_wrappers_reject_bad_cuda_inputs(cuda):
    cfg = AudioConfig()
    with pytest.raises(ValueError):  # not contiguous
        griffin_lim.griffin_lim(torch.rand(1, cfg.n_freq, 20, device=cuda).transpose(1, 2), cfg, 1)
    with pytest.raises(ValueError):  # n_fft not a power of two: the kernel's FFTs need one
        odd = AudioConfig(n_fft=1000)
        griffin_lim.griffin_lim(torch.rand(1, 20, odd.n_freq, device=cuda), odd, 1)
    with pytest.raises(ValueError):  # the frontend's FFTs need one too
        odd = AudioConfig(n_fft=1000)
        frontend.fused_frontend(torch.rand(1, 30000, device=cuda), odd, 20)
    with pytest.raises(ValueError):  # kernel 2: a block's columns of wh beyond its shared memory
        h = 1600
        gru.gru_scan(torch.rand(1, 2, 3 * h, device=cuda), torch.rand(h, 3 * h, device=cuda),
                     torch.rand(3 * h, device=cuda))
    with pytest.raises(ValueError):  # kernel 3: wh rows of a block beyond its shared memory
        h = 1600
        gru.gru_bwd(torch.rand(1, 1, 3 * h, device=cuda), torch.rand(h, 3 * h, device=cuda),
                    torch.rand(3 * h, device=cuda), torch.rand(1, 1, h, device=cuda),
                    torch.rand(1, 1, h, device=cuda))
    with pytest.raises(ValueError):  # ys of the wrong shape
        gru.gru_bwd(*(torch.rand(2, 3, 12, device=cuda), torch.rand(4, 12, device=cuda),
                      torch.rand(12, device=cuda), torch.rand(2, 3, 5, device=cuda),
                      torch.rand(2, 3, 4, device=cuda)))
    with pytest.raises(ValueError):  # wrong dtype
        gru.gru_scan(torch.rand(2, 3, 12, device=cuda, dtype=torch.float64),
                     torch.rand(4, 12, device=cuda), torch.rand(12, device=cuda))
