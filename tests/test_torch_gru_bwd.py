"""PyTorch port, kernel 3 (GRU backward pass) and the training half of the
GRU layer: gru_bwd_plain against the JAX Pallas backward kernel in
interpret mode, GRUScan against autograd through the plain forward and
against jax.grad of the custom VJP, the GRU layer's gradients against
jax.grad through models.layers.GRU, the grad guards, and dropout (the
CUDA kernel itself: tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.models.layers import GRU as JaxGRU
from zerospeech_tts_tpu.ops.pallas_gru import _gru_bwd_call, gru_scan_diff, pallas_gru_scan
from zerospeech_tts_tpu_torch.models.layers import GRU, FedNoise, Noise, dropout
from zerospeech_tts_tpu_torch.ops import gru

torch.set_num_threads(1)

# f32 on both sides; sums over B*T = 128 rows in another order. Measured
# below 2e-6 on these inputs.
ATOL = 1e-5


def _inputs(b=8, t=16, h=128, seed=0):
    """The smallest shape pallas_gru_supported admits (B % 8, H % 128)."""
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, t, 3 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    bh = (0.1 * rng.standard_normal(3 * h)).astype(np.float32)
    dys = rng.standard_normal((b, t, h)).astype(np.float32)
    return xw, wh, bh, dys


def test_gru_bwd_plain_matches_pallas_backward_kernel():
    xw, wh, bh, dys = _inputs()
    ys = np.array(pallas_gru_scan(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(bh), interpret=True))
    ref = _gru_bwd_call(*(jnp.asarray(a) for a in (xw, wh, bh, ys, dys)), interpret=True)
    out = gru.gru_bwd_plain(*(torch.from_numpy(a) for a in (xw, wh, bh, ys, dys)))
    for o, r, name in zip(out, ref, ("dxw", "dwh", "dbh")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_gru_scan_grads_match_jax_custom_vjp(reverse):
    """GRUScan (kernel 2 + kernel 3 plain versions) against jax.grad of
    gru_scan_diff, whose reverse direction conjugates the backward kernel
    by time flips."""
    xw, wh, bh, dys = _inputs(seed=1)

    def loss(a, b_, c):
        return jnp.sum(gru_scan_diff(reverse, a, b_, c) * dys)

    ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(bh))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (xw, wh, bh)]
    (gru.GRUScan.apply(*args, reverse) * torch.from_numpy(dys)).sum().backward()
    for a, r, name in zip(args, ref, ("dxw", "dwh", "dbh")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(r), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_gru_scan_grads_match_autograd_through_plain(reverse):
    xw, wh, bh, dys = _inputs(b=3, t=7, h=10, seed=2)  # any shape on the CPU
    a1 = [torch.from_numpy(a).double().requires_grad_(True) for a in (xw, wh, bh)]
    a2 = [torch.from_numpy(a).double().requires_grad_(True) for a in (xw, wh, bh)]
    d = torch.from_numpy(dys).double()
    (gru.GRUScan.apply(*a1, reverse) * d).sum().backward()
    (gru.gru_scan_plain(*a2, reverse=reverse) * d).sum().backward()
    for x, y in zip(a1, a2):  # float64: the two differ only by rounding
        torch.testing.assert_close(x.grad, y.grad, atol=1e-12, rtol=1e-10)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_gru_layer_grads_match_jax(reverse):
    """GRU layer gradients (wi, bi, wh, bh and the input) against jax.grad
    through models.layers.GRU (its lax.scan path) with the same weights."""
    rng = np.random.default_rng(3)
    b, t, i, h = 4, 9, 12, 16
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    dys = rng.standard_normal((b, t, h)).astype(np.float32)
    jgru = JaxGRU(h, reverse=reverse)
    params = jgru.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1 * jnp.ones_like(a), params)  # nonzero biases

    def loss(p, xx):
        return jnp.sum(jgru.apply(p, xx) * dys)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    pp, gp = params["params"], gp["params"]
    layer = GRU(i, h, reverse=reverse)
    with torch.no_grad():
        layer.wi.weight.copy_(torch.from_numpy(np.array(pp["wi"]["kernel"]).T))
        layer.wi.bias.copy_(torch.from_numpy(np.array(pp["wi"]["bias"])))
        layer.wh.copy_(torch.from_numpy(np.array(pp["wh"])))
        layer.bh.copy_(torch.from_numpy(np.array(pp["bh"])))
    xt = torch.from_numpy(x).requires_grad_(True)
    (layer(xt) * torch.from_numpy(dys)).sum().backward()
    pairs = [(layer.wi.weight.grad.T, gp["wi"]["kernel"]), (layer.wi.bias.grad, gp["wi"]["bias"]),
             (layer.wh.grad, gp["wh"]), (layer.bh.grad, gp["bh"]), (xt.grad, gx)]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_gru_output_under_grad_goes_through_gru_scan():
    """A GRU output that requires grad has the GRUScan node as its grad_fn
    (the kernel-3 backward), on every device; the CPU dispatch of
    gru_bwd takes the plain version and counts no launch."""
    layer = GRU(6, 8)
    y = layer(torch.randn(2, 5, 6))
    assert y.grad_fn is not None and "GRUScan" in type(y.grad_fn).__name__
    before = gru.bwd_launches
    y.sum().backward()
    assert gru.bwd_launches == before
    assert layer.wh.grad is not None and layer.wh.grad.abs().sum() > 0
    with torch.no_grad():  # inference keeps the no-grad contract
        assert layer(torch.randn(2, 5, 6)).grad_fn is None


def test_masked_scan_under_grad_raises():
    layer = GRU(6, 8, reverse=True)
    x = torch.randn(2, 5, 6)
    with pytest.raises(NotImplementedError):
        layer(x, lengths=torch.tensor([5, 3]))
    with torch.no_grad():  # inference-only: fine without grad
        out = layer(x, lengths=torch.tensor([5, 3]))
    assert not out[1, 3:].any()


def test_dropout_keep_rate_scale_and_fed_draws():
    """flax semantics: keep with probability 1 - p (uniform < 1 - p), kept
    values scaled by 1/(1 - p). Over 200k draws the keep rate sits within
    5 binomial standard deviations (0.0045) of 0.7."""
    x = torch.ones(200_000)
    y = dropout(x, 0.3, Noise(torch.Generator().manual_seed(0)))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 5 * np.sqrt(0.21 / 200_000)
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(dropout(x, 0.3, None), x) and torch.equal(dropout(x, 0.0, Noise(None)), x)
    u = np.array([[0.1, 0.75], [0.69, 0.71]], np.float32)  # fed uniforms: keep where u < 0.7
    z = dropout(torch.ones(2, 2), 0.3, FedNoise([u]))
    assert torch.equal(z != 0, torch.from_numpy(u < 0.7))


def test_gru_bwd_plain_reverse_matches_flipped_call_and_jax():
    """Kernel 3's ``reverse`` flag: the backward pass of a back-to-front
    scan, walking time forwards, equals the forward-time pass on the
    time-flipped tensors with dxw flipped back, and both match JAX's
    _gru_bwd_call (interpret mode) on the flipped inputs. f32 on all three
    sides, sums in other orders: within ATOL."""
    xw, wh, bh, dys = _inputs(seed=4)
    ys = np.array(pallas_gru_scan(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(bh), reverse=True,
                                  interpret=True))
    flip = lambda a: np.ascontiguousarray(a[:, ::-1])  # noqa: E731
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    rev = gru.gru_bwd_plain(t(xw), t(wh), t(bh), t(ys), t(dys), reverse=True)
    conj = gru.gru_bwd_plain(t(flip(xw)), t(wh), t(bh), t(flip(ys)), t(flip(dys)))
    ref = _gru_bwd_call(*(jnp.asarray(a) for a in (flip(xw), wh, bh, flip(ys), flip(dys))), interpret=True)
    ref = (flip(np.asarray(ref[0])), np.asarray(ref[1]), np.asarray(ref[2]))
    conj = (conj[0].flip(1), conj[1], conj[2])
    for name, r, c, j in zip(("dxw", "dwh", "dbh"), rev, conj, ref):
        np.testing.assert_allclose(r.numpy(), c.numpy(), atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(r.numpy(), j, atol=ATOL, rtol=0, err_msg=name)
