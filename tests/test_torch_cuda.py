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


# "hop50": hop and win not multiples of 4, the analysis loop's scalar path
CONFIGS = {"default": {}, "small": dict(n_fft=256, hop_length=64, win_length=256, n_mels=20),
           "hop50": dict(n_fft=256, hop_length=50, win_length=250, n_mels=20)}


@pytest.mark.parametrize("cfg_kw", CONFIGS.values(), ids=CONFIGS.keys())
def test_frontend_kernel_matches_plain(cuda, cfg_kw):
    cfg = AudioConfig(**cfg_kw)
    n = 512 * cfg.hop_length - 1  # 512 frames
    y = torch.from_numpy(np.stack([_noisy_tones(n, s) for s in range(8)])).to(cuda)
    lens = torch.tensor([n, n - 900, n // 2, n // 3, n, n - 1, 1000, n // 5], device=cuda)
    ypad = audio.mirror_pad(audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2, lens).contiguous()
    before = frontend.launches
    mel, mag = frontend.fused_frontend(ypad, cfg, 500)  # 500: a ragged last frame tile
    torch.cuda.synchronize()
    assert frontend.launches == before + 1
    pmel, pmag = frontend.frontend_plain(ypad, cfg, 500)
    torch.testing.assert_close(mag, pmag, atol=1e-4, rtol=0)
    torch.testing.assert_close(mel, pmel, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,t,h,reverse,masked", [
    (16, 512, 512, False, False),  # decoder
    (8, 64, 512, True, True),      # encoder backward direction, bucket-padded
    (8, 64, 512, True, False),
    (3, 7, 40, False, False),      # ragged: H and B not multiples of the tiles
])
def test_gru_kernel_matches_plain(cuda, b, t, h, reverse, masked):
    gen = torch.Generator().manual_seed(t)
    xw = torch.randn(b, t, 3 * h, generator=gen).to(cuda)
    wh = (torch.randn(h, 3 * h, generator=gen) / math.sqrt(h)).to(cuda)
    bh = (0.1 * torch.randn(3 * h, generator=gen)).to(cuda)
    lens = torch.randint(1, t + 1, (b,), generator=gen, dtype=torch.int32).to(cuda) if masked else None
    before = gru.launches
    out = gru.gru_scan(xw, wh, bh, lens, reverse=reverse)
    torch.cuda.synchronize()
    assert gru.launches == before + 1
    ref = gru.gru_scan_plain(xw, wh, bh, lens, reverse=reverse)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,t,cfg_name", [(4, 512, "default"), (1, 2500, "default"),
                                          (2, 5, "default"), (3, 100, "hop50")])
def test_griffin_lim_kernel_matches_plain(cuda, b, t, cfg_name):
    cfg = AudioConfig(**CONFIGS[cfg_name])
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


def test_wrappers_reject_bad_cuda_inputs(cuda):
    cfg = AudioConfig()
    with pytest.raises(ValueError):  # not contiguous
        griffin_lim.griffin_lim(torch.rand(1, cfg.n_freq, 20, device=cuda).transpose(1, 2), cfg, 1)
    with pytest.raises(ValueError):  # wrong dtype
        gru.gru_scan(torch.rand(2, 3, 12, device=cuda, dtype=torch.float64),
                     torch.rand(4, 12, device=cuda), torch.rand(12, device=cuda))
