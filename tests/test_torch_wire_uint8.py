"""PyTorch port, the uint8 feature wire (``Converter(wire="uint8")``,
``--wire-uint8``) against the JAX package's, on tests/test_parallel.py's
``test_uint8_wire_converter`` setup (the JAX Solver's init from
PRNGKey(0), three 64-frame feature arrays of U(0, 1), GL-2).

Tolerances: the host codes, lo and scale equal JAX's ``_wire_batch`` bit
for bit; units equal JAX's uint8 Converter's except where JAX's logit
margin on the dequantised input is < MARGIN; unit agreement with the
port's own bf16 wire above AGREE, on the full route and on encode_units
(JAX's bar); the split over devices gives the one device's units bit for
bit and its PCM within 1 LSB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu.train import Solver as JaxSolver
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter, read_units, uint8_wire
from zerospeech_tts_tpu_torch.params import from_flax

torch.set_num_threads(1)

ACFG = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
MARGIN = 1e-4
AGREE = 0.95


@pytest.fixture(scope="module")
def setup(tiny_hps):
    h = tiny_hps.replace(n_feat=129)
    st = JaxSolver(h).init_state(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, {"enc": st.enc, "dec": st.dec})
    feats = [np.random.default_rng(i).uniform(0, 1, (64, 129)).astype(np.float32) for i in range(3)]
    return h, params, feats


def _pair(setup, **kw):
    h, params, _ = setup
    j = JaxConverter(h, JaxAudioConfig(**ACFG), params["enc"], params["dec"], batch_size=3, bucket_frames=32,
                     gru_impl="scan", wire="uint8", **kw)
    p = Converter(h, AudioConfig(**ACFG), *from_flax(params), batch_size=3, bucket_frames=32, device="cpu",
                  wire="uint8", **kw)
    return j, p


def _margin(h, params, x):
    logits = np.asarray(JaxEncoder(h).apply(params["enc"], jnp.asarray(x)[None]))[0]
    return np.abs(logits[..., 0] - logits[..., 1])


def _dequantised(f, bucket):
    """The f32 features the device reads for one utterance padded to its
    bucket, at its true length."""
    x = np.zeros((1, bucket, f.shape[1]), np.float32)
    x[0, : f.shape[0]] = f
    q, lo, scale = uint8_wire(x)
    return (q[0].astype(np.float32) * scale[0] + lo[0])[: f.shape[0]]


def test_host_codes_equal_jax_wire_batch(setup):
    """uint8_wire on a padded batch (rows of 64, 47 and 30 true frames, a
    zero dummy row, a constant row, normalised features below zero) equals
    the JAX Converter's _wire_batch on the same rows, bit for bit."""
    h, params, feats = setup
    j, _ = _pair(setup)
    rng = np.random.default_rng(5)
    mean, std = rng.uniform(0.2, 0.5, 129).astype(np.float32), rng.uniform(0.05, 0.2, 129).astype(np.float32)
    rows = [(feats[0] - mean) / std, feats[1][:47], feats[2][:30],
            np.full((40, 129), 0.25, np.float32)]
    xs = [np.pad(r, ((0, 64 - r.shape[0]), (0, 0))) for r in rows] + [np.zeros((64, 129), np.float32)]
    q, lo, scale = uint8_wire(np.stack(xs))
    jq, jlo, jscale = (np.asarray(a) for a in j._wire_batch(xs))
    assert q.dtype == jq.dtype == np.uint8 and lo.dtype == jlo.dtype == scale.dtype == jscale.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(scale, jscale)
    assert lo[0] < 0 and lo[1] == 0.0  # zero padding counts in the row's range
    assert scale[4] == np.float32(1e-6) / np.float32(255.0) and not q[4].any()  # the dummy row


def test_units_match_jax_uint8_converter(setup):
    """Full route and encode_units against JAX's uint8 Converter: flips only
    within MARGIN of JAX's logits on the dequantised features."""
    h, params, feats = setup
    j, p = _pair(setup)
    (pu, pw), (ju, jw) = p.convert_features_multi(feats, [0, 1]), j.convert_features_multi(feats, [0, 1])
    for route, got, ref in (("full", pu, ju), ("units", p.encode_units(feats), j.encode_units(feats))):
        for f, a, b in zip(feats, got, ref):
            assert a.shape == b.shape and a.dtype == np.int32, route
            if (a != b).any():
                m = _margin(h, params, _dequantised(f, 64))
                assert (m[a != b] < MARGIN).all(), (route, m[a != b])
    for k in range(2):
        for a, b in zip(pw[k], jw[k]):
            assert a.dtype == np.int16 and a.shape == b.shape


def test_agreement_with_the_bf16_wire(setup):
    """JAX's bar: the uint8 wire's units agree with the bf16 wire's above
    AGREE on the full route and on encode_units; its PCM is finite int16."""
    h, params, feats = setup
    _, p = _pair(setup)
    b = Converter(h, AudioConfig(**ACFG), *from_flax(params), batch_size=3, bucket_frames=32, device="cpu")
    ub, _ = b.convert_features_multi(feats, [0])
    uq, wq = p.convert_features_multi(feats, [0])
    agree = np.mean([(x == y).mean() for x, y in zip(ub, uq)])
    agree_e = np.mean([(x == y).mean() for x, y in zip(ub, p.encode_units(feats))])
    assert agree > AGREE and agree_e > AGREE, (agree, agree_e)
    for w in wq[0]:
        assert w.dtype == np.int16 and w.size


def test_dequantises_in_the_compute_dtype(setup, monkeypatch):
    """The full route dequantises in the compute dtype (bf16 under
    compute_dtype=bfloat16, JAX's cd), units only in f32; the split over
    two devices takes its share of lo and scale."""
    h, params, feats = setup
    p = Converter(h, AudioConfig(**ACFG), *from_flax(params), batch_size=3, bucket_frames=32, device="cpu",
                  wire="uint8", compute_dtype="bfloat16")
    seen = []
    core, enc = p._convert_core, p._encode
    monkeypatch.setattr(p, "_convert_core", lambda dev, x, *a: seen.append(("full", x.dtype)) or core(dev, x, *a))
    monkeypatch.setattr(p, "_encode", lambda dev, x, t: seen.append(("units", x.dtype)) or enc(dev, x, t))
    p.convert_features_multi(feats, [0])
    p.encode_units(feats)
    assert set(seen) == {("full", torch.bfloat16), ("units", torch.float32)}
    one, two = (Converter(h, AudioConfig(**ACFG), *from_flax(params), batch_size=4, bucket_frames=32,
                          device="cpu", wire="uint8", devices=d) for d in (None, ["cpu", "cpu"]))
    (u0, w0), (u1, w1) = one.convert_features_multi(feats, [0, 1]), two.convert_features_multi(feats, [0, 1])
    for a, b in zip(u0, u1):
        np.testing.assert_array_equal(a, b)
    for t0, t1 in zip(w0, w1):
        for a, b in zip(t0, t1):
            assert a.shape == b.shape and np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
    for a, b in zip(one.encode_units(feats), two.encode_units(feats)):
        np.testing.assert_array_equal(a, b)


def test_cli_wire_uint8_on_the_corpus_route(tmp_path, setup):
    """convert -dataset_path --wire-uint8 through the CLI: the units the
    Converter's uint8 wire gives the same corpus features, and unit
    agreement with the bf16-wire run above AGREE; --units-only too."""
    from zerospeech_tts_tpu_torch.convert import load_corpus_split
    from zerospeech_tts_tpu_torch.data.corpus import build_corpus
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
    from zerospeech_tts_tpu_torch.export import save_export

    h, params, _ = setup
    acfg = AudioConfig(**ACFG)
    rng = np.random.default_rng(3)
    for spk in ("S01", "V001"):
        for i, n in enumerate((3000, 4032)):
            y = 0.4 * np.sin(2 * np.pi * (180 + 70 * i) * np.arange(n) / 16000) + 0.02 * rng.standard_normal(n)
            save_wav(tmp_path / "corpus" / "test" / f"{spk}_{i}.wav", y.astype(np.float32), 16000)
    build_corpus(tmp_path / "corpus", tmp_path / "ds", acfg, device="cpu")
    save_export(tmp_path / "bundle", h, acfg, params["enc"], params["dec"], {"S01": 0, "V001": 1})
    base = ["convert", "--from-export", str(tmp_path / "bundle"), "-dataset_path", str(tmp_path / "ds"),
            "--target", "V001", "--device", "cpu"]
    cli.main([*base, "-result_dir", str(tmp_path / "b")])
    cli.main([*base, "-result_dir", str(tmp_path / "q"), "--wire-uint8"])
    cli.main([*base, "-result_dir", str(tmp_path / "qu"), "--wire-uint8", "--units-only"])
    feats, names, _ = load_corpus_split(tmp_path / "ds", "test")
    ref = Converter(h, acfg, *from_flax(params), device="cpu", wire="uint8").encode_units(feats)
    same = bits = 0
    for utt, r in zip(names, ref):
        uq = read_units(tmp_path / "q" / "units" / f"{utt}.txt")
        np.testing.assert_array_equal(uq, r)
        np.testing.assert_array_equal(read_units(tmp_path / "qu" / "units" / f"{utt}.txt"), r)
        same += int((uq == read_units(tmp_path / "b" / "units" / f"{utt}.txt")).sum())
        bits += uq.size
        assert (tmp_path / "q" / "V001" / f"{utt}.wav").exists()
    assert same / bits > AGREE
