"""PyTorch port, models: the flax -> torch parameter bridge, the encoder
(logits and MBV units, exact-length and bucket-padded) and the decoder
against the JAX modules on the same converted parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.models import Decoder as JaxDecoder
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu.models.mbv import discretize as jax_discretize
from zerospeech_tts_tpu.models.mbv import unit_bits as jax_unit_bits
from zerospeech_tts_tpu_torch.models import Decoder, Encoder, discretize, unit_bits
from zerospeech_tts_tpu_torch.params import flatten, from_flax, init_params, to_flax

torch.set_num_threads(1)

# Measured max |port - JAX| on these inputs: encoder logits 2.4e-7,
# decoder output 4.8e-7 (CPU f32 on both sides).
ATOL = 1e-4
MARGIN = 1e-4  # a flipped unit must sit within this JAX logit margin


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(n_feat=129)


@pytest.fixture(scope="module")
def jax_params(hps):
    enc = JaxEncoder(hps).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, hps.n_feat)))
    dec = JaxDecoder(hps).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 4, hps.emb_size)), jnp.zeros((1,), jnp.int32)
    )
    return jax.tree.map(np.asarray, {"enc": enc, "dec": dec})


@pytest.fixture(scope="module")
def port_models(hps, jax_params):
    enc_sd, dec_sd = from_flax(jax_params)
    enc, dec = Encoder(hps).eval(), Decoder(hps).eval()
    enc.load_state_dict(enc_sd)  # strict: every flax leaf maps to a torch key
    dec.load_state_dict(dec_sd)
    return enc, dec


def _assert_units_under_margin(units, ref_units, ref_logits):
    flipped = units != ref_units
    margin = np.abs(ref_logits[..., 0] - ref_logits[..., 1])
    assert (margin[flipped] < MARGIN).all(), margin[flipped]


def test_from_flax_roundtrip_and_seeded_init_layout(hps, jax_params):
    back = to_flax(*from_flax(jax_params))
    ref = flatten({k: v["params"] for k, v in jax_params.items()})
    got = flatten(back)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    seeded = flatten(init_params(hps, seed=3))
    assert {k: v.shape for k, v in seeded.items()} == {k: v.shape for k, v in ref.items()}
    wh = seeded["enc/rnn/fwd/wh"]  # orthonormal rows
    np.testing.assert_allclose(wh @ wh.T, np.eye(wh.shape[0]), atol=1e-5)
    assert not seeded["dec/out/bias"].any()
    np.testing.assert_array_equal(flatten(init_params(hps, seed=3))["enc/head/kernel"],
                                  seeded["enc/head/kernel"])


@pytest.mark.parametrize("pad", [0, 5, 11], ids=["pad0", "pad5", "pad11"])
def test_encoder_matches_jax(hps, jax_params, port_models, pad):
    """Bucket-padded rows (pad 0 or >= 4 frames) with lengths: logits and
    units against JAX Encoder.apply(lengths=...), and the true rows against
    the port's exact-length encoding."""
    enc, _ = port_models
    rng = np.random.default_rng(pad)
    t_true = np.array([40, 40 - pad, 27, 40 - pad], np.int32)  # bucket 40
    x = rng.standard_normal((4, 40, hps.n_feat)).astype(np.float32)
    for b, n in enumerate(t_true):
        x[b, n:] = 0.0
    ref = np.asarray(JaxEncoder(hps).apply(jax_params["enc"], jnp.asarray(x), lengths=jnp.asarray(t_true)))
    with torch.no_grad():
        logits = enc(torch.from_numpy(x), lengths=torch.from_numpy(t_true)).numpy()
    assert logits.shape == ref.shape == (4, 5, hps.emb_size, 2)
    np.testing.assert_allclose(logits, ref, atol=ATOL, rtol=0)
    units = unit_bits(torch.from_numpy(logits)).numpy()
    _assert_units_under_margin(units, np.asarray(jax_unit_bits(jnp.asarray(ref))), ref)
    with torch.no_grad():  # padding invariance: row 1 at its exact length
        n = int(t_true[1])
        exact = enc(torch.from_numpy(x[1:2, :n])).numpy()
    z = -(-n // hps.downsample)
    np.testing.assert_allclose(logits[1, :z], exact[0, :z], atol=1e-5, rtol=0)


def test_decoder_matches_jax(hps, jax_params, port_models):
    _, dec = port_models
    rng = np.random.default_rng(7)
    z = (rng.uniform(size=(3, 6, hps.emb_size)) > 0.5).astype(np.float32)
    spk = np.array([0, 3, 1], np.int32)
    zlens = np.array([6, 4, 5], np.int32)
    ref = np.asarray(JaxDecoder(hps).apply(
        jax_params["dec"], jnp.asarray(z), jnp.asarray(spk), lengths=jnp.asarray(zlens)
    ))
    with torch.no_grad():
        out = dec(torch.from_numpy(z), torch.from_numpy(spk).long(), lengths=torch.from_numpy(zlens))
    assert out.shape == ref.shape == (3, 48, hps.n_feat)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["binary", "one_hot", "continues"])
def test_mbv_inference_modes_match_jax(mode):
    logits = np.random.default_rng(0).standard_normal((2, 3, 8, 2)).astype(np.float32)
    ref_bits = np.asarray(jax_unit_bits(jnp.asarray(logits), mode))
    ref_z = np.asarray(jax_discretize(jnp.asarray(logits), mode, 1.0, None))
    np.testing.assert_array_equal(unit_bits(torch.from_numpy(logits), mode).numpy(), ref_bits)
    np.testing.assert_array_equal(discretize(torch.from_numpy(logits), mode, 1.0).numpy(), ref_z)
