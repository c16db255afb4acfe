"""PyTorch port, the solver: each of the five training steps against the
JAX Solver from the same state (parameters and Adam moments bridged),
with dropout rates 0 and every random draw fed from the arrays JAX's key
derivation gives (``fold_in(k, 1)`` Gumbel, ``(k, 4)`` target speakers,
``(k, 7)`` penalty mixes); the alpha ramp; the pair term.

Bars: losses 1e-5 relative (1e-6 absolute near 0); each module's clipped
gradient 1e-4 rel-L2 (JAX's is read back from its updated Adam moment,
g = (mu1 - b1 mu0) / (1 - b1)); parameters after the Adam step within
2 lr per element (Adam's early steps are ~lr sign(g), so a gradient near
Adam's eps may round the other way and move the step by 2 lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.train import Solver as JaxSolver
from zerospeech_tts_tpu_torch.models.layers import FedNoise
from zerospeech_tts_tpu_torch.params import state_dicts_from_flax, train_state_from_flax
from zerospeech_tts_tpu_torch.train.solver import PAIR_SEP_MARGIN, Solver, TrainState

torch.set_num_threads(1)

MODS = ("enc", "dec", "clf", "dis")


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(enc_dp=0.0, dis_dp=0.0, lr=1e-3, lat_sched_iters=10, alpha_enc=0.5)


@pytest.fixture(scope="module")
def jsolver(hps):
    return JaxSolver(hps)


def _batch(h, seed):
    rng = np.random.default_rng(seed)
    b, ds = h.batch_size, h.downsample
    f = lambda: rng.uniform(0, 1, (b, h.seg_len, h.n_feat)).astype(np.float32)  # noqa: E731
    return {
        "x": f(), "spk": rng.integers(0, h.n_speakers, b).astype(np.int32),
        "x2": f(), "pair_dt": (ds * rng.integers(-2, 3, b)).astype(np.int32),
        "x_real": f(), "spk_real": rng.integers(0, h.n_speakers, b).astype(np.int32),
    }


@pytest.fixture(scope="module")
def base(hps, jsolver):
    """A JAX state one pretrain_AE step in (nonzero Adam moments for enc and
    dec), stamped into the 'train' phase at step 0 (alpha = alpha_enc / 10)."""
    st = jsolver.init_state(jax.random.PRNGKey(0))
    st, _ = jsolver.step_pretrain_ae(st, {k: jnp.asarray(v) for k, v in _batch(hps, 99).items()})
    return st.replace(train_start=jnp.asarray(0, jnp.int32))


def _port_state(hps, jst) -> TrainState:
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    adam = {}
    for n in MODS:
        a = getattr(jst, f"opt_{n}")[1][0]  # chain(clip, adam): ScaleByAdamState
        adam[n] = (int(a.count), np_(a.mu), np_(a.nu))
    return train_state_from_flax(hps, {n: np_(getattr(jst, n)) for n in MODS}, adam,
                                 step=int(jst.step), train_start=int(jst.train_start), device="cpu")


def _gumbel(k, shape):
    return np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), shape, minval=1e-20, maxval=1.0))


def _target_u(k, n):
    """Uniforms that pick JAX's target indices: floor(u n) = choice index."""
    idx = np.asarray(jax.random.choice(jax.random.fold_in(k, 4), jnp.arange(n), (n,)))
    return ((idx + 0.5) / n).astype(np.float32)


def _eps(k, b):
    return np.asarray(jax.random.uniform(jax.random.fold_in(k, 7), (b, 1, 1)))


def _run_both(hps, jsolver, jst, step, batch, draws, grad_mods):
    """Run ``step`` on both sides; check metrics, gradients, parameters."""
    _, k = jax.random.split(jst.rng)
    draws = draws(k)
    pst = _port_state(hps, jst)
    jb = {kk: jnp.asarray(v) for kk, v in batch.items()}
    tb = {kk: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for kk, v in batch.items()}
    jnew, jm = getattr(jsolver, step)(jax.tree.map(jnp.copy, jst), jb)
    noise = FedNoise(draws)
    pm = getattr(Solver(hps), step)(pst, tb, noise=noise)
    assert not noise.arrays, "not every fed draw was used"
    assert set(pm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(pm[name]), float(jm[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert pst.step == int(jnew.step)
    b1 = hps.beta1
    for n in grad_mods:
        a0, a1 = getattr(jst, f"opt_{n}")[1][0], getattr(jnew, f"opt_{n}")[1][0]
        g_ref = jax.tree.map(lambda m1, m0: (np.asarray(m1) - b1 * np.asarray(m0)) / (1 - b1),
                             a1.mu, a0.mu)
        g_ref = state_dicts_from_flax({n: g_ref})[n]
        new_ref = state_dicts_from_flax({n: jax.tree.map(np.asarray, getattr(jnew, n))})[n]
        num = den = 0.0
        for pname, p in pst.modules[n].named_parameters():
            num += float(((p.grad - g_ref[pname]) ** 2).sum())
            den += float((g_ref[pname] ** 2).sum())
            assert (p.detach() - new_ref[pname]).abs().max().item() <= 2 * hps.lr + 1e-6, pname
        assert np.sqrt(num / den) <= 1e-4, (n, np.sqrt(num / den))
    for n in set(MODS) - set(grad_mods):  # untouched modules stay as they were
        ref = state_dicts_from_flax({n: jax.tree.map(np.asarray, getattr(jst, n))})[n]
        for pname, p in pst.modules[n].named_parameters():
            assert torch.equal(p.detach(), ref[pname]), (n, pname)


def _lat(h):
    return (h.batch_size, h.n_bins, h.emb_size, 2)


def test_step_pretrain_ae_matches_jax(hps, jsolver):
    h = hps
    st = jsolver.init_state(jax.random.PRNGKey(1))
    b2 = (2 * h.batch_size,) + _lat(h)[1:]
    _run_both(h, jsolver, st, "step_pretrain_ae", _batch(h, 0), lambda k: [_gumbel(k, b2)],
              ("enc", "dec"))


def test_step_pretrain_clf_matches_jax(hps, jsolver, base):
    h = hps
    batch = {k: v for k, v in _batch(h, 1).items() if k in ("x", "spk")}
    _run_both(h, jsolver, base, "step_pretrain_clf", batch, lambda k: [_gumbel(k, _lat(h))], ("clf",))


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "no_pairs"])
def test_step_train_matches_jax(hps, jsolver, base, pairs):
    """Classifier step, then the adversarial AE step against the updated
    classifier. JAX encodes both passes with one key: with the pair they
    draw at [B] and [2B]; without it the two are one draw."""
    h = hps
    batch = _batch(h, 2)
    if not pairs:
        batch = {k: v for k, v in batch.items() if k not in ("x2", "pair_dt")}
    b2 = (2 * h.batch_size,) + _lat(h)[1:]

    def draws(k):
        return [_gumbel(k, _lat(h)), _gumbel(k, b2)] if pairs else [_gumbel(k, _lat(h))]

    _run_both(h, jsolver, base, "step_train", batch, draws, ("clf", "enc", "dec"))


def test_step_patch_d_matches_jax(hps, jsolver, base):
    """WGAN-GP critic step (per-sample penalty gradients in eval mode)."""
    h = hps

    def draws(k):
        return [_target_u(k, h.batch_size), _gumbel(k, _lat(h)), _eps(k, h.batch_size)]

    _run_both(h, jsolver, base, "step_patch_d", _batch(h, 3), draws, ("dis",))


@pytest.mark.parametrize("beta_rec", [0.0, 2.0], ids=["plain", "rec_anchor"])
def test_step_patch_g_matches_jax(hps, base, beta_rec):
    h = hps.replace(beta_rec=beta_rec)
    draws = lambda k: [_target_u(k, h.batch_size), _gumbel(k, _lat(h))]  # noqa: E731
    _run_both(h, JaxSolver(h), base, "step_patch_g", _batch(h, 4), draws, ("dec",))


def test_alpha_ramps_from_train_start(hps, jsolver):
    s = Solver(hps)
    for step, start in ((777, 777), (782, 777), (790, 777), (900, 777), (5, -1), (10, -1), (3, 8)):
        ref = float(jsolver._alpha(jnp.asarray(step, jnp.int32), jnp.asarray(start, jnp.int32)))
        assert s.alpha(step, start) == pytest.approx(ref, rel=1e-6, abs=1e-9)
    assert s.alpha(777, 777) == 0.0 and s.alpha(777 + hps.lat_sched_iters, 777) == hps.alpha_enc
    st = train_state_from_flax(hps, {n: jax.tree.map(np.asarray, getattr(
        jsolver.init_state(jax.random.PRNGKey(0)), n)) for n in MODS}, step=12, device="cpu")
    Solver.stamp_train_start(st, "pretrain_AE")
    assert st.train_start == -1
    Solver.stamp_train_start(st, "train")
    st.step = 20
    Solver.stamp_train_start(st, "train")  # idempotent
    assert st.train_start == 12


def test_pair_consistency_matches_jax(hps, jsolver):
    """Alignment on the overlap for positive, negative, zero and full
    offsets, and the separation hinge on collapsed latents."""
    rng = np.random.default_rng(0)
    n, e, ds = 8, 16, hps.downsample
    s = Solver(hps)
    base_z = rng.standard_normal((1, n + 4, e)).astype(np.float32)
    cases = [
        (base_z[:, :n], base_z[:, 2 : 2 + n], [2 * ds]),   # shifted copy: 0 alignment
        (base_z[:, 2 : 2 + n], base_z[:, :n], [-2 * ds]),
        (rng.standard_normal((3, n, e)), rng.standard_normal((3, n, e)), [0, 3 * ds, -n * ds]),
        (np.ones((2, n, e)), np.ones((2, n, e)), [0, ds]),  # collapsed: the hinge costs the margin
    ]
    for z, z2, dt in cases:
        z, z2, dt = np.float32(z), np.float32(z2), np.asarray(dt, np.int32)
        ref = float(jsolver._pair_consistency(jnp.asarray(z), jnp.asarray(z2), jnp.asarray(dt)))
        got = float(s.pair_consistency(torch.from_numpy(z), torch.from_numpy(z2), torch.from_numpy(dt)))
        assert got == pytest.approx(ref, rel=1e-5, abs=1e-6)
    assert got >= PAIR_SEP_MARGIN - 1e-6


def test_train_state_from_flax_defaults_to_the_card(hps):
    """The port's entry points run on the card unless the caller asks for
    the CPU: with no device argument and no CUDA device, it refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_state_from_flax(hps, {})
