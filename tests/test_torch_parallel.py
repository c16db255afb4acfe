"""PyTorch port, multi-device pieces in one process: ``--mesh`` parsing (both
axes) and what the CLI refuses, the process-group no-op, ``ShardedDeviceDataset`` shard for
shard against the JAX ``ShardedDeviceDataset`` at world 2 and 4, the
Converter split over k devices against the single-device Converter and
the JAX Converter on a ``data=4`` mesh, and the ``SegmentLoader``'s rank
slices against the single-process batch."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.data.device_dataset import ShardedDeviceDataset as JaxShardedDeviceDataset
from zerospeech_tts_tpu.parallel import make_mesh
from zerospeech_tts_tpu_torch import cli, parallel
from zerospeech_tts_tpu_torch.config import AudioConfig
from zerospeech_tts_tpu_torch.convert import Converter
from zerospeech_tts_tpu_torch.data.device_dataset import ShardedDeviceDataset
from zerospeech_tts_tpu_torch.data.loader import SegmentLoader
from zerospeech_tts_tpu_torch.data.segments import make_segment_index
from zerospeech_tts_tpu_torch.params import from_flax

torch.set_num_threads(1)

MARGIN = 1e-4  # a unit that differs from JAX's must sit within this JAX logit margin


# ------------------------------------------------------------- mesh, groups


def test_parse_mesh_and_refusals():
    """(data, model) as JAX's make_mesh reads them (the model axis
    accepted); a mesh wider than the devices, an unknown axis and a batch
    that does not divide raise; Mesh places rank r at (r // M, r % M)."""
    assert parallel.parse_mesh(None) == (1, 1) and parallel.parse_mesh("") == (1, 1)
    assert parallel.parse_mesh("data=4") == (4, 1)
    assert parallel.parse_mesh("data=2,model=1", n_devices=2) == (2, 1)
    assert parallel.parse_mesh("model=1", n_devices=8) == (8, 1)  # data left out: all devices
    assert parallel.parse_mesh("data=4,model=2") == (4, 2)
    assert parallel.parse_mesh("model=2", n_devices=8) == (4, 2)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        parallel.parse_mesh("data=16", n_devices=8)
    with pytest.raises(ValueError, match="needs 8 devices, have 4"):
        parallel.parse_mesh("data=4,model=2", n_devices=4)
    with pytest.raises(ValueError, match="data=D"):
        parallel.parse_mesh("pipe=2")
    assert [(parallel.Mesh(2, 2, r).d, parallel.Mesh(2, 2, r).m) for r in range(4)] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert parallel.batch_slice(1, 4, 32) == slice(8, 16)
    with pytest.raises(ValueError, match="does not divide"):
        parallel.batch_slice(0, 3, 32)
    assert parallel.conversion_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert parallel.conversion_devices("cpu", 2, 2) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            parallel.conversion_devices("cuda", 2)
        with pytest.raises(ValueError, match="data=2 x model=2 needs 4 devices, have 0"):
            parallel.conversion_devices("cuda", 2, 2)


def test_initialize_is_a_noop_without_the_launcher(monkeypatch):
    for k in parallel.distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    assert parallel.initialize(device="cpu") is False
    assert parallel.is_primary() and parallel.rank() == 0 and parallel.world() == 1
    assert parallel.local_device("cpu") == torch.device("cpu")
    parallel.barrier()  # no group: returns at once
    parallel.destroy()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="torchrun"):
        parallel.initialize(device="cpu")


def test_cli_refuses_what_the_mesh_cannot_do(tmp_path, monkeypatch):
    """train1 --mesh data=2 or data=1,model=2 outside a launch names the
    torchrun line with data x model processes; a world that is not data x
    model is refused; a conversion verb in a multi-process launch exits
    (the JAX package has no multi-process conversion)."""
    for k in parallel.distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    args = ["train1", "-dataset_path", "ds", "-index_path", "i.json", "-ckpt_dir", str(tmp_path / "ck"),
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2 -m zerospeech_tts_tpu_torch train1"):
        cli.main(args + ["--mesh", "data=2"])
    want = ("(?s)--mesh data=1,model=2 but WORLD_SIZE is 1: .*\n  torchrun --nproc-per-node 2 "
            "-m zerospeech_tts_tpu_torch train1 .* --mesh data=1,model=2")
    with pytest.raises(SystemExit, match=want):
        cli.main(args + ["--mesh", "data=1,model=2"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="--nproc-per-node 2 .* --mesh data=2"):
        cli.main(args)
    with pytest.raises(SystemExit, match="(?s)--mesh data=2,model=2 but WORLD_SIZE is 2: .* --nproc-per-node 4 "):
        cli.main(args + ["--mesh", "data=2,model=2"])
    with pytest.raises(SystemExit, match="the JAX package has no multi-process \\(multi-host\\) conversion"):
        cli.main(["convert-single", "--from-export", "b", "--source", "x.wav", "--target", "V001",
                  "-result_dir", "o", "--device", "cpu", "--mesh", "data=2"])
    assert not (tmp_path / "ck").exists()


# ---------------------------------------------------------------- the arena

# 12 utterances of 4 speakers (V001 the target); the 16-frame one is too
# short for a 16-frame segment; the index lists them out of name order
UTTS = [("S02", "S02_1", 40), ("V001", "V001_0", 30), ("S01", "S01_0", 50), ("S03", "S03_0", 16),
        ("S01", "S01_1", 35), ("S02", "S02_0", 45), ("S03", "S03_1", 60), ("V001", "V001_1", 33),
        ("S01", "S01_2", 28), ("S03", "S03_2", 41), ("S02", "S02_2", 38), ("S01", "S01_3", 44)]


@pytest.fixture(scope="module")
def arena_corpus(tmp_path_factory, tiny_hps):
    """The same utterances as a port corpus directory and as a JAX h5;
    utterance i's frames hold 100 i + its frame index."""
    import h5py

    h = tiny_hps.replace(batch_size=8, seg_len=16)
    root = tmp_path_factory.mktemp("arena")
    speakers = {s: i for i, s in enumerate(sorted({s for s, _, _ in UTTS}))}
    feats = [np.tile((100.0 * i + np.arange(n, dtype=np.float32))[:, None], (1, h.n_feat))
             for i, (_, _, n) in enumerate(UTTS)]
    (root / "ds" / "train").mkdir(parents=True)
    np.save(root / "ds" / "train" / "lin.npy", np.concatenate(feats))
    lens = [n for _, _, n in UTTS]
    (root / "ds" / "train" / "index.json").write_text(json.dumps(dict(
        names=[u for _, u, _ in UTTS], speakers=[s for s, _, _ in UTTS], lengths=lens,
        starts=np.concatenate([[0], np.cumsum(lens)[:-1]]).tolist())))
    (root / "ds" / "speakers.json").write_text(json.dumps(speakers))
    with h5py.File(root / "ds.h5", "w") as f:
        for (spk, utt, _), arr in zip(UTTS, feats):
            f.create_dataset(f"train/{spk}/{utt}/lin", data=arr)
        f.attrs["speakers"] = json.dumps(speakers)
    return h, root


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_arena_equals_jax_shards(arena_corpus, world):
    """Every rank's shard equals JAX's shard on a data=world mesh: arena
    rows, starts, lens, spk, real_w and x_w (JAX pads each shard to the
    largest; the padding has length 0). Each rank's draws come from its
    shard only, its reals from the target only."""
    h, root = arena_corpus
    ref = JaxShardedDeviceDataset.from_h5(root / "ds.h5", h, make_mesh(data=world), stats=False,
                                          target_speakers=["V001"])
    ref = {k: np.asarray(getattr(ref, k)) for k in ("arena", "starts", "lens", "spk", "real_w", "x_w")}
    seen = set()
    for rank in range(world):
        ds = ShardedDeviceDataset.from_corpus(root / "ds", h, rank, world, target_speakers=["V001"], device="cpu")
        u, frames = ds.lens.numel(), int(ds.lens.sum())
        for k in ("starts", "lens", "spk", "real_w", "x_w"):
            np.testing.assert_array_equal(getattr(ds, k).numpy(), ref[k][rank, :u], err_msg=k)
        assert (ref["lens"][rank, u:] == 0).all()
        np.testing.assert_array_equal(ds.arena.numpy(), ref["arena"][rank, :frames])
        assert ds.real_w.sum() == 2 and np.allclose(ds.x_w.numpy()[:2], 1 / world)
        utts = set((ds.arena[ds.starts, 0] // 100).long().tolist())
        seen |= utts
        b = ds.sample_batch(torch.Generator().manual_seed(rank))
        assert b["x"].shape == (h.batch_size // world, h.seg_len, h.n_feat) and "x2" in b
        assert set((b["x"][:, 0, 0] // 100).long().tolist()) <= utts
        assert set(b["spk_real"].tolist()) == {3}  # V001
        assert set((b["x_real"][:, 0, 0] // 100).long().tolist()) <= {1, 7}
        assert (b["pair_dt"] % h.downsample == 0).all()
    assert seen == set(range(len(UTTS))) - {3}  # every usable utterance is on some rank
    with pytest.raises(ValueError, match="fewer non-target utterances"):  # 11 usable, round-robin
        ShardedDeviceDataset.from_corpus(root / "ds", h, 11, 12, device="cpu")


def test_sharded_arena_without_targets_is_round_robin(arena_corpus):
    h, root = arena_corpus
    ref = JaxShardedDeviceDataset.from_h5(root / "ds.h5", h, make_mesh(data=2), stats=False)
    for rank in range(2):
        ds = ShardedDeviceDataset.from_corpus(root / "ds", h, rank, 2, device="cpu")
        for k in ("starts", "lens", "spk", "real_w", "x_w"):
            np.testing.assert_array_equal(getattr(ds, k).numpy(), np.asarray(getattr(ref, k))[rank, : ds.lens.numel()])
        assert (ds.real_w == 1).all() and (ds.x_w == 1).all()


def test_loader_rank_slices_make_the_single_batch(arena_corpus):
    """Two ranks' SegmentLoader batches, concatenated, equal the
    single-process batch key for key, batch after batch (and after a
    reseed)."""
    h, root = arena_corpus
    make_segment_index(root / "ds", root / "idx.json", h.seg_len, 200, seed=0, pair_grid=h.downsample)
    kw = dict(hps=h, target_speakers=["V001"], device="cpu", seed=3, prefetch=0, pairs=True)
    one = SegmentLoader(root / "ds", root / "idx.json", **kw)
    ranks = [SegmentLoader(root / "ds", root / "idx.json", rank=r, world=2, **kw) for r in range(2)]
    for i in range(4):
        if i == 2:
            for ld in (one, *ranks):
                ld.reseed(7)
        full, parts = next(one), [next(ld) for ld in ranks]
        assert set(full) == set(parts[0]) == {"x", "spk", "x_real", "spk_real", "x2", "pair_dt"}
        for k in full:
            assert parts[0][k].shape[0] == h.batch_size // 2
            assert torch.equal(torch.cat([p[k] for p in parts]), full[k]), k
    with pytest.raises(ValueError, match="does not divide"):
        SegmentLoader(root / "ds", root / "idx.json", rank=0, world=3, **kw)


# ------------------------------------------------------------ the converter


@pytest.fixture(scope="module")
def conv_setup(tiny_hps):
    """tests/test_parallel.py's mesh conversion setup (seeded parameters,
    four 64-frame feature arrays, GL-2) and the JAX Converter's units on a
    data=4 mesh; three wavs of 47-82 frames."""
    from zerospeech_tts_tpu.models import Decoder as JaxDecoder
    from zerospeech_tts_tpu.models import Encoder as JaxEncoder

    h = tiny_hps.replace(n_feat=129)
    acfg = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
    enc = jax.jit(JaxEncoder(h).init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, h.n_feat)))
    dec = jax.jit(JaxDecoder(h).init)(jax.random.PRNGKey(1), jnp.zeros((1, 4, h.emb_size)),
                                      jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(np.asarray, {"enc": enc, "dec": dec})
    feats = [np.random.default_rng(i).uniform(0, 1, (64, 129)).astype(np.float32) for i in range(4)]
    rng = np.random.default_rng(7)
    wavs = [(0.5 * np.sin(2 * np.pi * (200 + 60 * i) * np.arange(n) / 16000)
             + 0.01 * rng.standard_normal(n)).astype(np.float32) for i, n in enumerate((3000, 5200, 4032))]
    jconv = JaxConverter(h, JaxAudioConfig(**acfg), params["enc"], params["dec"], batch_size=4, bucket_frames=32,
                         mesh=make_mesh(data=4), gru_impl="scan")
    jax_units, _ = jconv.convert_features_multi(feats, [0, 1])
    margins = []  # JAX's logit margins on the bf16 feature wire, at exact length
    for f in feats:
        logits = np.asarray(JaxEncoder(h).apply(params["enc"], jnp.asarray(f, jnp.bfloat16).astype(jnp.float32)[None]))
        margins.append(np.abs(logits[0, ..., 0] - logits[0, ..., 1]))
    return h, acfg, params, feats, wavs, jax_units, margins


def _port_conv(setup, **kw):
    h, acfg, params = setup[:3]
    enc_sd, dec_sd = from_flax(params)
    return Converter(h, AudioConfig(**acfg), enc_sd, dec_sd, batch_size=4, bucket_frames=32, device="cpu", **kw)


@pytest.mark.parametrize("k", [2, 3])
def test_converter_split_matches_one_device_and_jax_mesh(conv_setup, k):
    """Converter(devices=["cpu"] * k): units equal the single-device
    Converter's, PCM within 1 LSB, for features (two targets), wavs and
    units only; units equal the JAX Converter's on a data=4 mesh except
    where JAX's logit margin is < 1e-4."""
    h, acfg, params, feats, wavs, jax_units, margins = conv_setup
    one, split = _port_conv(conv_setup), _port_conv(conv_setup, devices=["cpu"] * k)
    assert split.batch_size % k == 0 and split._chunk_batch(1) % k == 0
    for fn, args in (("convert_features_multi", (feats, [0, 1])), ("convert_wavs_multi", (wavs, [2]))):
        (u0, w0), (u1, w1) = getattr(one, fn)(*args), getattr(split, fn)(*args)
        for a, b in zip(u0, u1):
            np.testing.assert_array_equal(a, b)
        for t0, t1 in zip(w0, w1):
            for a, b in zip(t0, t1):
                assert a.shape == b.shape and np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
        if fn == "convert_features_multi":
            for a, b, m in zip(u1, jax_units, margins):
                assert a.shape == b.shape and (m[a != b] < MARGIN).all()
    for a, b in zip(one.encode_units(feats), split.encode_units(feats)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(one.encode_units_from_wavs(wavs), split.encode_units_from_wavs(wavs)):
        np.testing.assert_array_equal(a, b)


def test_cli_convert_mesh_splits_over_the_cpu(conv_setup, tmp_path):
    """convert --mesh data=2 --device cpu (a bundle, a directory of wavs)
    writes the files the one-device CLI writes: units equal, PCM within
    1 LSB."""
    import scipy.io.wavfile

    from zerospeech_tts_tpu_torch.convert import read_units
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
    from zerospeech_tts_tpu_torch.export import save_export

    h, acfg, params, _, wavs = conv_setup[:5]
    save_export(tmp_path / "bundle", h, AudioConfig(**acfg), params["enc"], params["dec"], {"S01": 0, "V001": 1})
    for i, w in enumerate(wavs):
        save_wav(tmp_path / "wavs" / f"u{i}.wav", w, 16000)
    base = ["convert", "--from-export", str(tmp_path / "bundle"), "--from-wavs", str(tmp_path / "wavs"),
            "--target", "V001", "--device", "cpu"]
    cli.main(base + ["-result_dir", str(tmp_path / "one")])
    cli.main(base + ["-result_dir", str(tmp_path / "two"), "--mesh", "data=2"])
    for i in range(len(wavs)):
        np.testing.assert_array_equal(read_units(tmp_path / "two" / "units" / f"u{i}.txt"),
                                      read_units(tmp_path / "one" / "units" / f"u{i}.txt"))
        a = scipy.io.wavfile.read(tmp_path / "one" / "V001" / f"u{i}.wav")[1].astype(np.int32)
        b = scipy.io.wavfile.read(tmp_path / "two" / "V001" / f"u{i}.wav")[1].astype(np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
