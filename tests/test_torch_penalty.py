"""PyTorch port, the WGAN-GP penalty's explicit route
(``PatchDiscriminator.penalty_input_grad``) against autograd's
``create_graph`` route it replaces: the input gradient and the penalty's
gradients over the critic's weights at flagship width (batch 2) and at small
odd and even T and F; a whole ``step_patch_d``'s critic gradients; and a
census of the ops the penalty's backward dispatches.

All in float64, where the two routes differ by rounding alone: the input
gradient is the same dgrad convs and leaky-relu rule in the same order
(measured equal), and each weight gradient is the same sum of products,
taken by backward-filter here and by a forward conv with batch and channels
swapped there (measured within 1e-15 relative). Bound 1e-12.
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.models import PatchDiscriminator
from zerospeech_tts_tpu_torch.models.patch_discriminator import penalty_counts
from zerospeech_tts_tpu_torch.train.solver import Solver, init_state

torch.set_num_threads(1)

REL = 1e-12  # float64 rounding only (module docstring)

# (batch, T, F): the flagship segment; even T and F; odd T and F; odd T, even F
SHAPES = {"flagship": (2, 128, 513), "even": (2, 32, 64), "odd": (3, 31, 65), "mixed": (2, 17, 40)}


def _autograd_route(dis, x):
    """The penalty's input gradient as autograd's double backward takes it."""
    x = x.detach().requires_grad_(True)
    patch, _ = dis(x, train=False)
    (g,) = torch.autograd.grad(patch.mean(dim=(1, 2)).sum(), x, create_graph=True)
    return g


def _penalty(g):
    return ((torch.sqrt((g * g).sum(dim=(1, 2)) + 1e-12) - 1.0) ** 2).mean()


def _critic(f, seed=0):
    torch.manual_seed(seed)
    dis = PatchDiscriminator(Hps(n_feat=f)).double()
    with torch.no_grad():  # nonzero biases, as after training
        for name, p in dis.named_parameters():
            if name.endswith("bias"):
                p.add_(0.01 * torch.randn_like(p))
    return dis


def _rel(a, b):
    return float(((a - b).norm() / b.norm()).detach())


@pytest.mark.parametrize("b,t,f", SHAPES.values(), ids=SHAPES.keys())
def test_penalty_input_grad_matches_autograd(b, t, f):
    dis = _critic(f)
    x = torch.rand(b, t, f, dtype=torch.float64, generator=torch.Generator().manual_seed(t))
    weights = [p for n, p in dis.named_parameters() if n.endswith("weight") and not n.startswith("cls")]
    biases = [p for n, p in dis.named_parameters() if n.endswith("bias") and not n.startswith("cls")]
    ref = _autograd_route(dis, x)
    got = dis.penalty_input_grad(x)
    assert got.shape == ref.shape == (b, t, f) and got.dtype == torch.float64
    assert _rel(got, ref) <= REL
    ref_w = torch.autograd.grad(_penalty(ref), weights + biases, allow_unused=True)
    got_w = torch.autograd.grad(_penalty(got), weights + biases, allow_unused=True)
    for name, r, g in zip(("conv_0", "conv_1", "conv_2", "conv_3", "patch_head"), ref_w, got_w):
        assert _rel(g, r) <= REL, name
    # the biases do not enter the input gradient: autograd gives them zeros
    # (the head's bias no gradient at all)
    for r, g in zip(ref_w[len(weights):], got_w[len(weights):]):
        assert g is None and (r is None or not r.any())


def _tiny_hps():
    return Hps(speaker_norm=False, batch_size=4, seg_len=32, n_feat=64, emb_size=32, spk_emb_size=8,
               n_speakers=4, bank_size=4, bank_channels=8, conv_channels=16, n_critic=1, lr=1e-3)


def _step_patch_d(hps):
    st = init_state(hps, seed=3, device="cpu")
    for m in st.modules.values():
        m.double()
    g = torch.Generator().manual_seed(0)
    b, t, f = hps.batch_size, hps.seg_len, hps.n_feat
    batch = {"x": torch.rand(b, t, f, generator=g, dtype=torch.float64),
             "x_real": torch.rand(b, t, f, generator=g, dtype=torch.float64),
             "spk_real": torch.randint(0, hps.n_speakers, (b,), generator=g)}
    metrics = Solver(hps).step_patch_d(st, batch)
    return metrics, {n: p.grad for n, p in st.modules["dis"].named_parameters()}


def test_step_patch_d_critic_grads_match_autograd_route(monkeypatch):
    """One critic step through the explicit route against the same step
    (same state, batch and draws) with autograd's route in its place: the
    losses and every clipped critic gradient within 1e-12; one route and
    five backward-filter calls a critic step."""
    hps = _tiny_hps()
    before = penalty_counts()
    got_m, got_g = _step_patch_d(hps)
    after = penalty_counts()
    assert after["routes"] == before["routes"] + 1
    assert after["weight_grads"] == before["weight_grads"] + 5  # four convs and the patch head
    monkeypatch.setattr(PatchDiscriminator, "penalty_input_grad", _autograd_route)
    ref_m, ref_g = _step_patch_d(hps)
    assert penalty_counts() == after
    for k in ref_m:
        assert float(got_m[k]) == pytest.approx(float(ref_m[k]), rel=REL, abs=1e-15), k
    for n in ref_g:
        if n == "patch_head.bias":  # cancels in mean(real) - mean(fake): ~1e-17 either way
            assert float(got_g[n].abs().max()) <= 1e-12 and float(ref_g[n].abs().max()) <= 1e-12
        else:
            assert _rel(got_g[n], ref_g[n]) <= REL, n


class _Census(TorchDispatchMode):
    """Every aten.convolution's weight size and dilation, and whether each
    aten.convolution_backward's grad_output is all zero."""

    def __init__(self):
        super().__init__()
        self.convs, self.zero_backwards, self.backwards = [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.convs.append((tuple(args[1].shape[2:]), tuple(args[5])))
        elif func is torch.ops.aten.convolution_backward.default:
            self.backwards += 1
            self.zero_backwards += int(not bool(args[0].any()))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("route", ["explicit", "autograd"])
def test_penalty_backward_census(route):
    """The explicit route's backward runs every conv at a layer's own kernel
    (5x5, or the head's 3x3), undilated, and no convolution_backward on an
    all-zero grad_output. Autograd's route, censused alike, runs the weight
    gradient as a dilated conv with the gradient map as its filter, and
    backward on zeros: the census sees what the explicit route leaves out."""
    b, t, f = SHAPES["odd"]
    dis = _critic(f)
    x = torch.rand(b, t, f, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    g = dis.penalty_input_grad(x) if route == "explicit" else _autograd_route(dis, x)
    census = _Census()
    with census:
        torch.autograd.grad(_penalty(g), list(dis.parameters()), allow_unused=True)
    kernels = {(5, 5), (3, 3)}
    big = [c for c in census.convs if c[0] not in kernels or c[1] != (1, 1)]
    if route == "explicit":
        assert census.convs and census.backwards == 5
        assert big == [] and census.zero_backwards == 0
    else:
        assert len(big) == 5 and census.zero_backwards > 0

