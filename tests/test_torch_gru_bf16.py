"""PyTorch port, kernel 2's bf16 mode: the plain version in bf16 (f32 state,
products of h rounded to bf16 summed in f32, bf16 ys) against the JAX
package's ``pallas_gru_scan`` in bf16 (interpret mode on the CPU), forward
and length-masked reverse; the bf16-state control; the bf16 GRU layer on
the CPU. The CUDA kernel itself: tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.ops.pallas_gru import pallas_gru_scan
from zerospeech_tts_tpu_torch.models.layers import GRU
from zerospeech_tts_tpu_torch.ops import gru
from zerospeech_tts_tpu_torch.tools.workload import gru_scan_bf16_state

torch.set_num_threads(1)

B, T, H = 16, 24, 128


def _inputs(seed):
    """bf16-representable xw [B, T, 3H], wh [H, 3H], bh [3H] and ragged
    lengths, made with numpy."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    xw = bf(rng.standard_normal((B, T, 3 * H)))
    wh = bf(rng.standard_normal((H, 3 * H)) / np.sqrt(H))
    bh = bf(0.1 * rng.standard_normal(3 * H))
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    return xw, wh, bh, lens


def _jax(a: torch.Tensor):
    return jnp.asarray(a.float().numpy(), jnp.bfloat16)


ULP = 2.0**-8  # one bf16 ulp at |y| in [0.5, 1): the top of the GRU's output range


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse_masked"])
def test_plain_bf16_matches_pallas_interpret(reverse):
    """Bar: every element within one bf16 ulp at the top of the GRU's
    range (|y| < 1: 2^-8) of JAX's, and at least 99% bit-equal. The two
    keep the same f32 state and round h to bf16 for the product; only the
    product's f32 summation order differs, so where a state lies on a bf16
    rounding boundary the two round it apart, and that step's product, and
    the states after it, move by a few ulps of a small value. Read at B=16,
    T=24, H=128: forward 99.996% bit-equal (max |diff| 1.9e-6), reverse
    masked 99.945% (max |diff| 1.95e-3 = 2^-9)."""
    xw, wh, bh, lens = _inputs(3 if reverse else 2)
    lengths = lens if reverse else None
    ref = np.asarray(pallas_gru_scan(_jax(xw), _jax(wh), _jax(bh),
                                     None if lengths is None else jnp.asarray(lengths),
                                     reverse=reverse, interpret=True).astype(jnp.float32))
    out = gru.gru_scan_plain(xw, wh, bh, None if lengths is None else torch.from_numpy(lengths),
                             reverse=reverse)
    assert out.dtype == torch.bfloat16 and out.shape == (B, T, H)
    got = out.float().numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= ULP, diff.max()
    equal = float((diff == 0).mean())
    print(f"bf16 plain vs pallas_gru_scan ({'reverse masked' if reverse else 'forward'}): "
          f"{equal:.4%} bit-equal, max |diff| {diff.max():.3e}")
    assert equal >= 0.99, equal


def test_plain_bf16_keeps_an_f32_state():
    """Rounding the state to bf16 between steps (what a bf16 lax.scan does,
    and the control the card holds kernel 2's bf16 mode against,
    tools/workload.py ``gru_scan_bf16_state``) is a different, less
    accurate recurrence: forward and masked reverse, the plain version must
    not equal it, and must stay nearer the f32 recurrence of the same bf16
    inputs."""
    xw, wh, bh, lens = _inputs(4)
    for reverse, lengths in ((False, None), (True, torch.from_numpy(lens))):
        out = gru.gru_scan_plain(xw, wh, bh, lengths, reverse=reverse).float()
        f32 = gru.gru_scan_plain(xw.float(), wh.float(), bh.float(), lengths, reverse=reverse)
        rounded = gru_scan_bf16_state(xw, wh, bh, lengths, reverse=reverse)
        assert rounded.dtype == torch.bfloat16
        rounded = rounded.float()
        assert not torch.equal(out, rounded), reverse
        assert (out - f32).abs().mean() < (rounded - f32).abs().mean(), reverse


def test_bf16_gru_layer_runs_the_plain_bf16_scan_on_the_cpu():
    """A bf16 GRU layer on CPU tensors: its xw (a bf16 dense layer) goes
    through gru_scan_plain in bf16, masked reverse."""
    torch.manual_seed(0)
    layer = GRU(24, 32, reverse=True).to(torch.bfloat16).eval()
    x = torch.randn(3, 10, 24).to(torch.bfloat16)
    lens = torch.tensor([10, 7, 3], dtype=torch.int32)
    with torch.no_grad():
        ys = layer(x, lengths=lens)
        ref = gru.gru_scan_plain(layer.wi(x).contiguous(), layer.wh, layer.bh, lens, reverse=True)
    assert ys.dtype == torch.bfloat16
    assert torch.equal(ys, ref)
