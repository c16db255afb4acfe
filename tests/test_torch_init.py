"""PyTorch port, the fresh init (params.init_modules) against flax's, the
JAX ``Solver.init_state`` at ``tiny_hps``: every Conv and Dense kernel is
flax's ``lecun_normal`` (a normal of sigma = sqrt(1/fan_in) / 0.8796 cut at
+-2 sigma), the speaker embedding ``nn.Embed``'s default (an untruncated
normal of std 1/sqrt(features)), biases zero and ``wh`` orthogonal.

Tolerances: the cut is exact (max |x| <= 2 sigma in f32); a leaf's sample
std is held to the analytic std within SE_BAR standard errors of a sample
std (SE = std * sqrt((excess kurtosis + 2) / 4n), the kurtosis of the
distribution drawn), the port's against JAX's within sqrt(2) x that; the
pooled kernels of a module, each divided by its sigma, pass a
Kolmogorov-Smirnov test against the truncated normal at KS_ALPHA, as JAX's
own draws do."""

import jax
import numpy as np
import pytest
import scipy.stats
import torch

from zerospeech_tts_tpu.train import Solver as JaxSolver
from zerospeech_tts_tpu_torch.params import MODULES, init_modules, lecun_sigma, state_dicts_from_flax

torch.set_num_threads(1)

SE_BAR = 5.0  # standard errors of a sample std
KS_ALPHA = 1e-3
TRUNC = scipy.stats.truncnorm(-2.0, 2.0)  # flax's cut, in units of sigma


def _se(std: float, n: int, excess_kurtosis: float) -> float:
    return std * np.sqrt((excess_kurtosis + 2.0) / (4.0 * n))


@pytest.fixture(scope="module")
def leaves(tiny_hps):
    """{module: {state-dict key: (port array, JAX array)}}, both from seed 0."""
    port = {n: {k: v.numpy() for k, v in m.state_dict().items()} for n, m in init_modules(tiny_hps, 0).items()}
    st = JaxSolver(tiny_hps).init_state(jax.random.PRNGKey(0))
    ref = state_dicts_from_flax({n: jax.tree.map(np.asarray, getattr(st, n)) for n in MODULES})
    out = {}
    for n in MODULES:
        assert set(port[n]) == set(ref[n]), n
        out[n] = {k: (port[n][k], ref[n][k].numpy()) for k in port[n]}
    return out


def _kind(key: str) -> str:
    leaf = key.rsplit(".", 1)[-1]
    return {"bias": "zero", "bh": "zero", "wh": "orthogonal", "embedding": "embedding"}.get(leaf, "kernel")


@pytest.mark.parametrize("module", MODULES)
def test_kernels_are_lecun_normal_as_flax_draws_them(leaves, module):
    k_trunc = float(TRUNC.stats(moments="k"))
    pooled = {"port": [], "jax": []}
    n_kernels = 0
    for key, (p, j) in leaves[module].items():
        if _kind(key) != "kernel":
            continue
        n_kernels += 1
        assert p.shape == j.shape and p.dtype == np.float32
        s = lecun_sigma(int(np.prod(p.shape[1:])))
        assert np.abs(p).max() <= np.float32(2 * s), (key, np.abs(p).max() / s)  # the cut is exact
        assert np.abs(j).max() <= 2 * s * (1 + 1e-6), key
        want = np.sqrt(1.0 / np.prod(p.shape[1:]))  # variance_scaling(1, fan_in): var 1/fan_in
        se = _se(want, p.size, k_trunc)
        assert abs(p.std() - want) <= SE_BAR * se, (key, p.std(), want, se)
        assert abs(j.std() - want) <= SE_BAR * se, (key, j.std(), want, se)
        assert abs(p.std() - j.std()) <= SE_BAR * np.sqrt(2) * se, (key, p.std(), j.std())
        pooled["port"].append(p.ravel() / s)
        pooled["jax"].append(j.ravel() / s)
    assert n_kernels > 0
    for who, xs in pooled.items():
        ks = scipy.stats.kstest(np.concatenate(xs), TRUNC.cdf)
        assert ks.pvalue > KS_ALPHA, (module, who, ks)


def test_speaker_embedding_is_flax_embed_default(leaves, tiny_hps):
    p, j = leaves["dec"]["spk_embed.embedding"]
    assert p.shape == j.shape == (tiny_hps.n_speakers, tiny_hps.spk_emb_size)
    want = 1.0 / np.sqrt(tiny_hps.spk_emb_size)
    se = _se(want, p.size, 0.0)  # a normal's excess kurtosis
    assert abs(p.std() - want) <= SE_BAR * se, (p.std(), want)
    assert abs(j.std() - want) <= SE_BAR * se, (j.std(), want)
    # untruncated, as flax's "normal": the pooled draw over many seeds reaches past 2 sigma
    draws = np.concatenate([init_modules(tiny_hps, s, ("dec",))["dec"].spk_embed.embedding.detach().numpy().ravel()
                            for s in range(40)]) / want
    assert np.abs(draws).max() > 2.5
    assert scipy.stats.kstest(draws, "norm").pvalue > KS_ALPHA


@pytest.mark.parametrize("module", MODULES)
def test_biases_zero_and_wh_orthogonal(leaves, module):
    for key, (p, j) in leaves[module].items():
        kind = _kind(key)
        if kind == "zero":
            assert not p.any() and not j.any(), key
        elif kind == "orthogonal":  # wh [H, 3H]: orthonormal rows, as flax's orthogonal()
            h = p.shape[0]
            for w in (p, j):
                np.testing.assert_allclose(w @ w.T, np.eye(h), atol=1e-5)


def test_each_leaf_draws_from_the_one_generator(tiny_hps):
    """Same seed, same weights; another seed, other weights; enc and dec
    first, whatever follows."""
    a, b = init_modules(tiny_hps, 3), init_modules(tiny_hps, 3)
    c = init_modules(tiny_hps, 4, ("enc", "dec"))
    for n in MODULES:
        for (k, x), y in zip(a[n].state_dict().items(), b[n].state_dict().values()):
            assert torch.equal(x, y), k
    assert not torch.equal(a["enc"].state_dict()["dense.weight"], c["enc"].state_dict()["dense.weight"])
    d = init_modules(tiny_hps, 3, ("enc", "dec"))
    for n in ("enc", "dec"):
        for x, y in zip(a[n].state_dict().values(), d[n].state_dict().values()):
            assert torch.equal(x, y)
