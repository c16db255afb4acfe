"""PyTorch port, the training models: the speaker classifier and the patch
discriminator against flax on bridged weights (even and odd T and F, to
hold flax's asymmetric SAME padding), the parameter bridge of all four
modules (2-D kernels included), and the Gumbel-softmax discretizer in its
three modes against JAX on the same uniform noise, with its
straight-through gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.models import PatchDiscriminator as JaxPatchDiscriminator
from zerospeech_tts_tpu.models import SpeakerClassifier as JaxSpeakerClassifier
from zerospeech_tts_tpu.models.mbv import discretize as jax_discretize
from zerospeech_tts_tpu_torch.models import PatchDiscriminator, SpeakerClassifier, discretize
from zerospeech_tts_tpu_torch.models.layers import FedNoise
from zerospeech_tts_tpu_torch.models.patch_discriminator import same_pad
from zerospeech_tts_tpu_torch.params import (
    MODULES,
    flatten,
    flax_from_state_dicts,
    init_params,
    state_dicts_from_flax,
)

torch.set_num_threads(1)

# f32 convs on both sides, summed in other orders; measured below 1e-6.
ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_same_pad_matches_flax_rule():
    assert [same_pad(n, 5, 2) for n in (128, 64, 32, 16)] == [(1, 2)] * 4
    assert [same_pad(n, 5, 2) for n in (513, 257, 129, 65)] == [(2, 2)] * 4
    assert same_pad(9, 3, 1) == (1, 1)


def test_classifier_matches_flax(tiny_hps):
    h = tiny_hps
    z = np.random.default_rng(0).standard_normal((3, 5, h.emb_size)).astype(np.float32)
    params = _np(JaxSpeakerClassifier(h).init(jax.random.PRNGKey(0), jnp.asarray(z)))
    ref = np.asarray(JaxSpeakerClassifier(h).apply(params, jnp.asarray(z)))
    clf = SpeakerClassifier(h)
    clf.load_state_dict(state_dicts_from_flax({"clf": params})["clf"])  # strict
    with torch.no_grad():
        out = clf(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (3, h.n_speakers)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,f", [(32, 64), (31, 65), (16, 513)], ids=["even", "odd", "odd513"])
def test_patch_discriminator_matches_flax(tiny_hps, t, f):
    h = tiny_hps.replace(n_feat=f)
    x = np.random.default_rng(t).uniform(size=(2, t, f)).astype(np.float32)
    params = _np(JaxPatchDiscriminator(h).init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params = jax.tree_util.tree_map_with_path(  # nonzero biases
        lambda path, a: a + 0.01 if path[-1].key == "bias" else a, params)
    ref_patch, ref_cls = JaxPatchDiscriminator(h).apply(params, jnp.asarray(x))
    dis = PatchDiscriminator(h)
    dis.load_state_dict(state_dicts_from_flax({"dis": params})["dis"])
    with torch.no_grad():
        patch, cls = dis(torch.from_numpy(x))
    assert patch.shape == ref_patch.shape
    np.testing.assert_allclose(patch.numpy(), np.asarray(ref_patch), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cls.numpy(), np.asarray(ref_cls), atol=ATOL, rtol=0)


def test_params_roundtrip_all_four_modules(tiny_hps):
    """flax -> torch -> flax is the identity for enc, dec, clf and dis (2-D
    kernels [kh, kw, in, out] <-> [out, in, kh, kw] with kh, kw kept apart),
    and the seeded init has the flax shapes."""
    from zerospeech_tts_tpu.train import Solver as JaxSolver

    h = tiny_hps
    st = JaxSolver(h).init_state(jax.random.PRNGKey(0))
    tree = {n: _np(getattr(st, n)) for n in MODULES}
    sds = state_dicts_from_flax(tree)
    w = sds["dis"]["conv_0.weight"]  # flax [5, 5, 1, 32] -> [32, 1, 5, 5]
    k = tree["dis"]["params"]["conv_0"]["kernel"]
    assert tuple(w.shape) == (32, 1, 5, 5)
    assert w[3, 0, 1, 4] == k[1, 4, 0, 3]  # (kh, kw) = (1, 4), not swapped
    back = flatten(flax_from_state_dicts(sds))
    ref = flatten({n: v["params"] for n, v in tree.items()})
    assert set(back) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)
    seeded = flatten(init_params(h, 0, MODULES))
    assert {k_: v.shape for k_, v in seeded.items()} == {k_: v.shape for k_, v in ref.items()}
    np.testing.assert_array_equal(  # enc/dec weights do not depend on what follows
        flatten(init_params(h, 0))["dec/out/kernel"], seeded["dec/out/kernel"])


@pytest.mark.parametrize("mode", ["binary", "one_hot", "continues"])
def test_discretize_gumbel_matches_jax(mode):
    """Same uniforms (JAX's own draw, minval 1e-20) -> the same latents,
    and the same straight-through gradient w.r.t. the logits."""
    key = jax.random.PRNGKey(5)
    logits = np.random.default_rng(1).standard_normal((2, 3, 8, 2)).astype(np.float32)
    shape = logits.shape if mode == "binary" else logits.shape[:-1]
    u = np.asarray(jax.random.uniform(key, shape, minval=1e-20, maxval=1.0))
    w = np.random.default_rng(2).standard_normal(logits.shape[:-1]).astype(np.float32)

    def jloss(lg):
        return jnp.sum(jax_discretize(lg, mode, 0.7, key) * w)

    ref = np.asarray(jax_discretize(jnp.asarray(logits), mode, 0.7, key))
    ref_g = np.asarray(jax.grad(jloss)(jnp.asarray(logits)))
    lt = torch.from_numpy(logits).requires_grad_(True)
    out = discretize(lt, mode, 0.7, FedNoise([u]) if mode != "continues" else FedNoise([]))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(lt.grad.numpy(), ref_g, atol=1e-5, rtol=0)
    if mode == "binary":  # hard forward: exact 0/1
        assert set(np.unique(out.detach().numpy())) <= {0.0, 1.0}
