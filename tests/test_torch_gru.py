"""PyTorch port, kernel 2 (GRU recurrence): the plain version against the
JAX Pallas kernel in interpret mode (forward, reverse, reverse masked with
mixed lengths) and the CPU dispatch of the wrapper (the CUDA kernel
itself: tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.ops.pallas_gru import pallas_gru_scan
from zerospeech_tts_tpu_torch.ops import gru

torch.set_num_threads(1)

# Measured: max |port - JAX| 3.3e-7 (forward), 3.0e-7 (reverse, masked).
ATOL = 1e-5
LENGTHS = np.array([16, 3, 9, 1, 12, 16, 7, 5], np.int32)


def _inputs(b=8, t=16, h=128, seed=0):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, t, 3 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * h)).astype(np.float32)
    return xw, wh, bh


@pytest.mark.parametrize(
    "reverse,masked", [(False, False), (True, False), (True, True)],
    ids=["forward", "reverse", "reverse_masked"],
)
def test_gru_plain_matches_pallas(reverse, masked):
    xw, wh, bh = _inputs()
    lens = LENGTHS if masked else None
    ref = pallas_gru_scan(
        jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(bh),
        None if lens is None else jnp.asarray(lens), reverse=reverse, interpret=True,
    )
    out = gru.gru_scan_plain(
        torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(bh),
        None if lens is None else torch.from_numpy(lens), reverse=reverse,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    if masked:  # pad steps of the reversed scan pass h0 = 0 through
        for b, n in enumerate(LENGTHS):
            assert not out[b, n:].any()


def test_gru_wrapper_cpu_takes_plain_path_and_rejects_masked_forward():
    xw, wh, bh = (torch.from_numpy(a) for a in _inputs(b=2, t=5, h=16))
    gru.launches = 0
    out = gru.gru_scan(xw, wh, bh, reverse=True)
    assert gru.launches == 0
    assert torch.equal(out, gru.gru_scan_plain(xw, wh, bh, reverse=True))
    with pytest.raises(NotImplementedError):
        gru.gru_scan(xw, wh, bh, torch.tensor([5, 2], dtype=torch.int32))
