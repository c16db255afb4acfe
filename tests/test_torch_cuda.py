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


# H = 200: K padded to 208 (a partial k-tile); H = 37: rows neither 16-byte
# nor 4-byte aligned (staged and copied element by element)
@pytest.mark.parametrize("h", [512, 200, 37])
@pytest.mark.parametrize("t", [64, 512])
@pytest.mark.parametrize("b", [1, 3, 16, 17, 33, 64])
def test_gru_bf16_kernel_matches_plain(cuda, b, t, h):
    """Kernel 2's bf16 mode (bf16 xw, wh, bh and ys; f32 state; the product
    on the tensor cores) against gru_scan_plain in bf16, forward and
    reverse masked with ragged lengths, at batches that pad the m-tiles of
    16 rows (1, 3, 17, 33) and an H that is not a multiple of 16: every
    element within one bf16 ulp at the top of the GRU's range (2^-8), and
    the mean difference at most half the bf16-state control's. Not bit for
    bit: the two sum each step's product in other f32 orders, and once a
    state lying on a bf16 rounding boundary rounds apart for the next
    product (after some tens of steps), the two recurrences drift ~1e-4
    apart and a share of ys rounds one ulp apart. One launch a scan,
    counted apart from the f32 mode's."""
    for reverse, masked in ((False, False), (True, True)):
        xw, wh, bh, gen = _gru_inputs_typed(b, t, h, b * t + h + 7, cuda, torch.bfloat16)
        lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda) if masked else None
        before, before32 = gru.bf16_launches, gru.launches
        out = gru.gru_scan(xw, wh, bh, lens, reverse=reverse)
        torch.cuda.synchronize()
        assert (gru.bf16_launches, gru.launches) == (before + 1, before32), (reverse, masked)
        assert out.dtype == torch.bfloat16 and out.shape == (b, t, h)
        got = _hold_bf16(out, xw, wh, bh, lens, reverse)
        print(f"B={b} T={t} H={h} reverse={reverse}: max |diff| {got[0]:.3e}, mean {got[1]:.3e}, "
              f"control's {got[2]:.3e}")


@pytest.mark.parametrize("b", [128, 256])
def test_gru_bf16_kernel_fragment_modes(cuda, b):
    """Kernel 2's bf16 mode where its spread leaves the registers-and-one-
    m-tile case of the conversion path (H = 512): at B = 128 the fragments
    of wh sit in shared memory (12 n-tiles a block: two passes of the
    accumulators), at B = 256 a block holds several m-tiles of 16 rows.
    Each holds against the plain version as above, forward and reverse
    masked, in one launch."""
    t, h = 64, 512
    kc, _, nb, _, _, _, rows, wreg = gru.scan_plan(cuda, b, h, torch.bfloat16)[:8]
    assert rows == b and (wreg == 0 and 3 * kc > 64 if b == 128 else nb > 16), (b, kc, nb, rows, wreg)
    for reverse, masked in ((False, False), (True, True)):
        xw, wh, bh, gen = _gru_inputs_typed(b, t, h, b + reverse, cuda, torch.bfloat16)
        lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda) if masked else None
        before = gru.bf16_launches
        out = gru.gru_scan(xw, wh, bh, lens, reverse=reverse)
        torch.cuda.synchronize()
        assert gru.bf16_launches == before + 1
        _hold_bf16(out, xw, wh, bh, lens, reverse)


WIDE_H = [(2048, torch.float32), (4096, torch.float32), (2304, torch.bfloat16)]


def test_gru_wide_h_raises_in_f32_and_states_bf16(cuda):
    """Wide H (the name is kept from when this test pinned the refusal of
    such an H): kernel 2 in f32 at H = 2,048 and 4,096 and in bf16 at
    2,304, B = 16, T = 64, forward and reverse masked, keeps only the first
    Hs < H rows of a block's columns of wh in shared memory and reads the
    rest from its packed copy; each run is one counted launch and holds
    against gru_scan_plain at the existing bars (f32 1e-4; bf16 one ulp and
    the control ratio). Kernel 3 at H = 2,048 (B = 16, T = 32) keeps Hs < H
    rows on chip and holds against gru_bwd_plain (dxw 1e-4 max abs, dwh and
    dbh 1e-4 rel-L2). The GRU layer at H = 2,048 runs on the card and
    matches its own run on the CPU (1e-4). Shapes that fit keep Hs = H."""
    from zerospeech_tts_tpu_torch.models.layers import GRU

    b, t = 16, 64
    for h, dt in WIDE_H:
        plan = gru.scan_plan(cuda, b, h, dt)
        assert 0 < plan[8] < h and plan[9] > 0, plan
        for reverse, masked in ((False, False), (True, True)):
            xw, wh, bh, gen = _gru_inputs_typed(b, t, h, h + reverse, cuda, dt)
            lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda) if masked else None
            counter = "launches" if dt == torch.float32 else "bf16_launches"
            before = getattr(gru, counter)
            out = gru.gru_scan(xw, wh, bh, lens, reverse=reverse)
            torch.cuda.synchronize()
            assert getattr(gru, counter) == before + 1, (h, reverse)
            if dt == torch.float32:
                err = (out - gru.gru_scan_plain(xw, wh, bh, lens, reverse=reverse)).abs().max().item()
                assert err <= 1e-4, (h, reverse, err)
            else:
                _hold_bf16(out, xw, wh, bh, lens, reverse)
    h, t = 2048, 32
    assert 0 < gru.bwd_plan(cuda, b, h)[6] < h, gru.bwd_plan(cuda, b, h)
    xw, wh, bh = _gru_inputs(b, t, h, 3, cuda)
    ys = gru.gru_scan(xw, wh, bh)
    dys = torch.randn(b, t, h, generator=torch.Generator().manual_seed(1)).to(cuda)
    before = gru.bwd_launches
    dxw, dwh, dbh = gru.gru_bwd(xw, wh, bh, ys, dys)
    torch.cuda.synchronize()
    assert gru.bwd_launches == before + 1
    rxw, rwh, rbh = gru.gru_bwd_plain(xw, wh, bh, ys, dys)
    assert (dxw - rxw).abs().max().item() <= 1e-4
    assert _rel(dwh, rwh) <= 1e-4 and _rel(dbh, rbh) <= 1e-4
    layer = GRU(64, h)
    with torch.no_grad():
        layer.wh.copy_(torch.randn(h, 3 * h, generator=torch.Generator().manual_seed(2)) / math.sqrt(h))
        x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(3))
        ref = layer(x)
        got = layer.to(cuda)(x.to(cuda))
    assert (got.cpu() - ref).abs().max().item() <= 1e-4
    for bb in (1, 16, 32, 64):  # the paths' shapes keep their columns whole
        assert gru.scan_plan(cuda, bb, 512)[8] == 512 and gru.bwd_plan(cuda, bb, 512)[6] == 512


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
    with pytest.raises(ValueError):  # kernel 2: wh of the wrong shape
        gru.gru_scan(torch.rand(1, 2, 12, device=cuda), torch.rand(4, 11, device=cuda),
                     torch.rand(12, device=cuda))
    with pytest.raises(ValueError):  # ys of the wrong shape
        gru.gru_bwd(*(torch.rand(2, 3, 12, device=cuda), torch.rand(4, 12, device=cuda),
                      torch.rand(12, device=cuda), torch.rand(2, 3, 5, device=cuda),
                      torch.rand(2, 3, 4, device=cuda)))
    with pytest.raises(ValueError):  # wrong dtype
        gru.gru_scan(torch.rand(2, 3, 12, device=cuda, dtype=torch.float64),
                     torch.rand(4, 12, device=cuda), torch.rand(12, device=cuda))


def _tiny_training(root):
    """A 6-speaker corpus (tools/workload.py) preprocessed on the card with
    its segment index, and tiny-width hps beside it."""
    import dataclasses
    import json

    from zerospeech_tts_tpu_torch import cli
    from zerospeech_tts_tpu_torch.config import Hps
    from zerospeech_tts_tpu_torch.tools.workload import write_train_corpus

    hps = Hps().replace(batch_size=4, seg_len=64, emb_size=32, spk_emb_size=8, bank_size=4, bank_channels=8,
                        conv_channels=16, n_critic=1, log_interval=1, save_interval=100)
    d = dataclasses.asdict(hps)
    d["audio"] = dataclasses.asdict(AudioConfig())
    (root / "tiny.json").write_text(json.dumps(d))
    common = ["--hps", str(root / "tiny.json"), "--device", "cuda"]
    cli.main(["preprocess", "--corpus", str(write_train_corpus(root, n_utts=2)), "-dataset_path",
              str(root / "ds"), "-index_path", str(root / "idx.json"), "--n-samples", "200", *common])
    return hps, common


def test_loader_batch_to_the_card_and_one_step(cuda, tmp_path):
    """SegmentLoader batches copied to the card (pinned buffers,
    non_blocking) equal the same loader's batches on the CPU, and a
    pretrain_AE step from one runs kernels 2 and 3 to a finite loss."""
    from zerospeech_tts_tpu_torch.data.loader import SegmentLoader
    from zerospeech_tts_tpu_torch.train import Solver, init_state

    hps, _ = _tiny_training(tmp_path)
    kw = dict(seed=5, pairs=True, target_speakers=["V001"])
    with SegmentLoader(tmp_path / "ds", tmp_path / "idx.json", hps, device=cuda, **kw) as on_card, \
            SegmentLoader(tmp_path / "ds", tmp_path / "idx.json", hps, device="cpu", **kw) as on_cpu:
        b_card, b_cpu = next(iter(on_card)), next(iter(on_cpu))
        torch.cuda.synchronize()
        for k, v in b_card.items():
            assert v.is_cuda and torch.equal(v.cpu(), b_cpu[k]), k
        state = init_state(hps, device=cuda)
        before = (gru.launches, gru.bwd_launches)
        m = Solver(hps, check_numerics=True).train(state, iter(on_card), "pretrain_AE", 1)
        torch.cuda.synchronize()
    assert gru.launches > before[0] and gru.bwd_launches > before[1]
    assert math.isfinite(float(m["loss_rec"])) and "loss_pair" in m


def test_profile_trace_names_kernels_2_and_3(cuda, tmp_path):
    """train1 --profile on the card: the Chrome trace holds device events
    of kernel 2 (gru_scan_kernel) and kernel 3 (gru_bwd_rec_kernel)."""
    from zerospeech_tts_tpu_torch import cli

    _, common = _tiny_training(tmp_path)
    out = cli.main(["train1", "-dataset_path", str(tmp_path / "ds"), "-index_path", str(tmp_path / "idx.json"),
                    "-ckpt_dir", str(tmp_path / "ck"), "--iters-override", "1", "--profile",
                    str(tmp_path / "prof"), "--check-numerics", *common])
    text = out["trace"].read_text()
    assert "gru_scan_kernel" in text and "gru_bwd_rec_kernel" in text


def test_converter_split_over_one_card_twice_matches_one_device(cuda, tmp_path):
    """Converter(devices=["cuda:0", "cuda:0"]) on the conversion workload
    (flagship width, GL-8): units equal the single-device Converter's, or
    differ only within a 1e-4 logit margin; PCM within 1 LSB; kernels 1, 2
    and 4 launch on the split route."""
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS, write_workload

    _, acfg, speakers, _ = write_workload(tmp_path, seed=1)
    b = load_export(tmp_path / "bundle")
    enc_sd, dec_sd = from_flax({"enc": b.enc, "dec": b.dec})
    wavs = [load_wav(p, acfg.sr) for p in sorted((tmp_path / "wavs").glob("*.wav"))]
    ids = [speakers[t] for t in TARGETS]
    out = {}
    for k, devices in (("one", None), ("split", ["cuda:0", "cuda:0"])):
        conv = Converter(b.hps, b.acfg, enc_sd, dec_sd, gl_iters=8, stats=b.stats, device=cuda, devices=devices)
        before = (frontend.launches, gru.launches, griffin_lim.launches)
        out[k] = conv.convert_wavs_multi(wavs, ids, tgt_names=list(TARGETS))
        torch.cuda.synchronize()
        after = (frontend.launches, gru.launches, griffin_lim.launches)
        assert all(a > c for a, c in zip(after, before)), (k, before, after)
    (u1, w1), (u2, w2) = out["one"], out["split"]
    for i, (a, c) in enumerate(zip(u1, u2)):
        assert a.shape == c.shape
        if (a != c).any():  # only where the single device's own logit margin is tiny
            one = Converter(b.hps, b.acfg, enc_sd, dec_sd, stats=b.stats, device=cuda)
            s_mean, s_std = one._src_stats(1, None)
            (_, _, arrays, to_dev), = one._pcm_chunks(one._trimmed([wavs[i]], True), s_mean, s_std)
            x, tlens = to_dev(one.device, *arrays)
            with torch.inference_mode():
                lg = one.encoder(x, lengths=tlens)[0, : a.shape[0]].float().cpu().numpy()
            assert (np.abs(lg[..., 0] - lg[..., 1])[a != c] < 1e-4).all()
    for t1, t2 in zip(w1, w2):
        for p, q in zip(t1, t2):
            assert p.shape == q.shape and np.abs(p.astype(np.int32) - q.astype(np.int32)).max() <= 1


def test_matmul_precision_arms_meet_their_bars(cuda, tmp_path):
    """--matmul-precision tensorfloat32 and bfloat16 against float32 on the
    card (cli.MATMUL_PRECISION_BARS): a convert of the conversion workload
    (flagship width, GL-100) and one train1 step a phase at flagship width
    (--fresh, --device-data, the same seed): unit agreement with the
    float32 arm's files, and each loss within its relative bar. The
    package's pin (TF32 off, precision 'highest') is restored after every
    arm and holds at the end."""
    from zerospeech_tts_tpu_torch import cli
    from zerospeech_tts_tpu_torch.convert import read_units
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS, write_train_corpus, write_workload

    def pin():
        return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision())

    assert pin() == (False, False, "highest")
    write_workload(tmp_path, seed=0)
    corpus = write_train_corpus(tmp_path / "train", n_utts=2)
    ds, idx = str(tmp_path / "ds"), str(tmp_path / "idx.json")
    cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", ds, "-index_path", idx, "--n-samples", "500"])
    units, losses = {}, {}
    for arm in ("float32", "tensorfloat32", "bfloat16"):
        try:
            cli.main(["convert", "--from-export", str(tmp_path / "bundle"), "--from-wavs", str(tmp_path / "wavs"),
                      "-result_dir", str(tmp_path / arm), "--target", *TARGETS, "--matmul-precision", arm])
            r = cli.main(["train1", "-dataset_path", ds, "-index_path", idx, "-ckpt_dir", str(tmp_path / f"ck_{arm}"),
                          "--iters-override", "1", "--fresh", "--device-data", "--matmul-precision", arm])
        finally:
            cli.apply_matmul_precision("float32")
        assert pin() == (False, False, "highest"), arm
        units[arm] = {p.name: read_units(p) for p in sorted((tmp_path / arm / "units").glob("*.txt"))}
        losses[arm] = {(ph, k): v for ph, d in r["phases"].items() for k, v in d["last"].items()
                       if k.startswith("loss_")}
    assert len(units["float32"]) == 8 and len(losses["float32"]) >= 6
    for arm, bars in cli.MATMUL_PRECISION_BARS.items():
        same = sum(int((units[arm][n] == u).sum()) for n, u in units["float32"].items())
        bits = sum(u.size for u in units["float32"].values())
        assert same / bits >= bars["units"], (arm, same / bits)
        for key, v in losses[arm].items():
            ref = losses["float32"][key]
            assert math.isfinite(v) and abs(v - ref) <= bars["loss_rel"] * abs(ref), (arm, key, v, ref)


def test_dp_parity_two_ranks_on_one_card_over_gloo(cuda):
    """tools/dp_parity.py at world 2 on cuda:0 over gloo, tiny width, from
    Adam moments that are not zero: every step meets dp_parity.failures'
    bars (ranks bit-equal; parameters, gradients and pre-clip gradient
    norms within 1e-5 relative of the single-process step; metrics within
    1e-4), and with the planted fault (the gradient all_reduce undivided by
    the world size) every step misses its gradient-norm bar."""
    from zerospeech_tts_tpu_torch.config import Hps
    from zerospeech_tts_tpu_torch.tools import dp_parity

    h = Hps(speaker_norm=False, batch_size=8, seg_len=32, n_feat=64, emb_size=32, spk_emb_size=8, n_speakers=4,
            bank_size=4, bank_channels=8, conv_channels=16, n_critic=1)
    case = dp_parity.make_case(h, seed=3, device="cuda")
    kw = dict(world=2, device="cuda", backend="gloo", local_ranks=[0, 0], timeout=300)
    out = dp_parity.run(case, **kw)
    assert out["world"] == 2 and out["backend"] == "gloo" and out["device"] == "cuda:0"
    assert not dp_parity.failures(out["report"])
    ctl = dp_parity.failures(dp_parity.run(case, control=True, **kw)["report"])
    for name in out["report"]:
        assert any(x.startswith(f"{name}: grad_norm_rel") for x in ctl), (name, ctl)


def test_tp_parity_two_ranks_on_one_card_over_gloo(cuda):
    """tools/dp_parity.py at data=1, model=2 on cuda:0 over gloo, tiny
    width (JAX's min_size 128), from Adam moments that are not zero: every
    step meets dp_parity.failures' bars against the single-process step
    (whole leaves bit-equal across the model group, blocks gathered);
    each rank's resident state after a step of each kind is what it held
    once placed (no whole weight or gradient outlives a step) and below a
    world-1 state's; with the planted fault (gradient blocks swapped
    between the model ranks) every step misses its gradient bar."""
    from zerospeech_tts_tpu_torch.config import Hps
    from zerospeech_tts_tpu_torch.tools import dp_parity

    h = Hps(speaker_norm=False, batch_size=8, seg_len=32, n_feat=64, emb_size=32, spk_emb_size=8, n_speakers=4,
            bank_size=4, bank_channels=8, conv_channels=16, n_critic=1)
    case = dp_parity.make_case(h, seed=3, device="cuda")
    kw = dict(world=2, model=2, min_size=128, device="cuda", backend="gloo", local_ranks=[0, 0], timeout=300)
    out = dp_parity.run(case, **kw)
    assert (out["data"], out["model"], out["device"]) == (1, 2, "cuda:0")
    assert not dp_parity.failures(out["report"])
    assert len(out["memory"]) == 2
    for m in out["memory"]:
        assert m["placed_after_steps"] == m["placed"] < m["world1_built"], m
        assert m["count"] < m["count_world1"]
    ctl = dp_parity.failures(dp_parity.run(case, control=True, **kw)["report"])
    for name in out["report"]:
        assert any(x.startswith(f"{name}: grad_rel_l2") for x in ctl), (name, ctl)


def test_resident_reading_leaves_out_a_free_pending_on_another_stream(cuda):
    """tools/dp_parity.resident, the resident-bytes reading: a tensor freed
    while a side stream still used it (gloo and NCCL record their streams
    on a collective's tensors) counts in neither of its readings, though
    the allocator keeps its block in requested_bytes until it sees the
    stream's event done."""
    from zerospeech_tts_tpu_torch.tools import dp_parity

    base = dp_parity.resident(cuda)
    x = torch.ones(1 << 22, device=cuda)  # 16 MiB
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        x.mul_(2)
    x.record_stream(side)
    del x
    assert dp_parity.resident(cuda) == base
