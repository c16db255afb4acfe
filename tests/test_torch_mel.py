"""PyTorch port, ``feat="mel"``: ``melspectrogram2wav`` against the JAX
package's, and the mel pipeline of tests/test_e2e.py::test_08_mel_pipeline
(n_feat = n_mels = 20) through the port's CLI: preprocess -> train1 --feat
mel (bf16 arena too) -> export --feat mel -> convert (checkpoint and
bundle), convert-single from the checkpoint, eval --feat mel; units held
against the JAX Converter (feat="mel") on the same parameters and
features."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from zerospeech_tts_tpu.config import AudioConfig as JaxAudioConfig
from zerospeech_tts_tpu.config import Hps as JaxHps
from zerospeech_tts_tpu.convert import Converter as JaxConverter
from zerospeech_tts_tpu.data.speaker_norm import SpeakerStats as JaxSpeakerStats
from zerospeech_tts_tpu.dsp import audio as jax_audio
from zerospeech_tts_tpu.models import Encoder as JaxEncoder
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.convert import load_corpus_split, read_units
from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset
from zerospeech_tts_tpu_torch.dsp import audio as port_audio
from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
from zerospeech_tts_tpu_torch.export import load_export

torch.set_num_threads(1)

TINY_AUDIO = dict(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=8)
TINY_HPS = dict(batch_size=4, seg_len=32, n_feat=20, emb_size=16, spk_emb_size=8, n_speakers=8,
                bank_size=4, bank_channels=8, conv_channels=16, n_critic=1, log_interval=1,
                save_interval=100)
MARGIN = 1e-4  # a unit may differ from JAX's only within this JAX logit margin
# STFT-magnitude rel-L2 of the port's audio against JAX's: the bar the
# linear route's tests hold (tests/test_torch_convert.py, ROADMAP.md §3):
# the vocoders share the recurrence but not its edges (the port follows
# the Pallas kernel's overlap-add tails, JAX's CPU program the XLA path's
# re-pad).
PCM_REL_L2 = 0.25


def _mel_input(cfg):
    """A normalised mel spectrogram [T, n_mels] of a seeded noisy tone pair,
    from the JAX frontend."""
    rng = np.random.default_rng(0)
    t = np.arange(6000) / 16000
    y = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 990 * t) + 0.01 * rng.standard_normal(6000)
    mel, _ = jax_audio.wav_to_features(jnp.asarray(y.astype(np.float32)), JaxAudioConfig(**cfg), method="fused")
    return np.array(mel)


def _stft_rel(a, b, cfg):
    def mag(y):
        re, im = port_audio.stft(torch.from_numpy(np.asarray(y, np.float32))[None], cfg)
        return torch.sqrt(re * re + im * im)[0].numpy()

    ma, mb = mag(a), mag(b)
    return float(np.linalg.norm(ma - mb) / np.linalg.norm(mb))


@pytest.mark.parametrize("n_iters", [0, 2], ids=["gl0", "gl2"])
def test_melspectrogram2wav_matches_jax(n_iters):
    """The lift (dB-denorm, pinv(mel_basis) product clamped at 1e-10,
    ** gl_power) within 1e-5 relative of JAX's, the wav within the lin
    route's edge bar (STFT-magnitude rel-L2 < 0.25). Read: lift 3.6e-8;
    wav 0.0951 at GL-0, 0.0997 at GL-2."""
    cfg_kw = dict(TINY_AUDIO)
    mel = _mel_input(cfg_kw)
    jcfg, cfg = JaxAudioConfig(**cfg_kw), AudioConfig(**cfg_kw)
    amp_j = np.maximum(np.asarray(jax_audio.db_norm_to_amp(jnp.asarray(mel), jcfg))
                       @ jax_audio._mel_pinv(jcfg).T, 1e-10) ** jcfg.gl_power
    amp_p = port_audio.mel_to_gl_magnitudes(torch.from_numpy(mel)[None], cfg)[0].numpy()
    lift = np.linalg.norm(amp_p - amp_j) / np.linalg.norm(amp_j)
    assert lift < 1e-5, lift
    wav_j = np.asarray(jax_audio.melspectrogram2wav(jnp.asarray(mel), jcfg, n_iters=n_iters))
    wav_p = port_audio.melspectrogram2wav(torch.from_numpy(mel)[None], cfg, n_iters=n_iters)[0].numpy()
    assert wav_p.shape == wav_j.shape and np.isfinite(wav_p).all()
    rel = _stft_rel(wav_p, wav_j, cfg)
    print(f"GL-{n_iters}: lift rel-L2 {lift:.2e}, wav STFT-magnitude rel-L2 {rel:.4f}")
    assert rel < PCM_REL_L2, rel


@pytest.fixture(scope="module")
def mel_run(tmp_path_factory):
    """The corpus of test_08_mel_pipeline (train S01, V001; test S09: two
    0.75 s tones each) through the port's CLI on the CPU."""
    root = tmp_path_factory.mktemp("mel_pipeline")
    hps_d = dict(TINY_HPS, audio=TINY_AUDIO)
    (root / "hps.json").write_text(json.dumps(hps_d))
    for split, speakers in [("train", ["S01", "V001"]), ("test", ["S09"])]:
        for spk in speakers:
            for i in range(2):
                t = np.arange(12000) / 16000
                y = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)).astype(np.float32)
                save_wav(root / "corpus" / split / f"{spk}_{i:04d}.wav", y, 16000)
    ds, ck, hp = str(root / "ds"), str(root / "ck"), str(root / "hps.json")
    c = ["--hps", hp, "--device", "cpu"]
    idx = ["-index_path", str(root / "idx.json")]
    cli.main(["preprocess", "--corpus", str(root / "corpus"), "-dataset_path", ds, *idx, "--n-samples", "64", *c])
    r1 = cli.main(["train1", "-dataset_path", ds, *idx, "--device-data", "-ckpt_dir", ck, "--iters-override", "1",
                   "--feat", "mel", *c])
    ex = cli.main(["export", "-dataset_path", ds, "-ckpt_dir", ck, "--out", str(root / "bundle"),
                   "--feat", "mel", *c])
    cv = cli.main(["convert", "-dataset_path", ds, "-ckpt_dir", ck, "-result_dir", str(root / "out"),
                   "--target", "V001", "--gl-iters", "4", "--batch-size", "2", "--feat", "mel", *c])
    cb = cli.main(["convert", "--from-export", str(root / "bundle"), "-dataset_path", ds,
                   "-result_dir", str(root / "out_b"), "--target", "V001", "--gl-iters", "4",
                   "--batch-size", "2", "--device", "cpu"])
    return dict(root=root, ds=ds, ck=ck, hps=hp, r1=r1, ex=ex, cv=cv, cb=cb)


def test_mel_pipeline_runs_and_records_feat(mel_run):
    """test_08's checks (two nonsilent-or-finite wavs per target), plus:
    train1 ran its three phases on mel, the bundle records feat=mel, and
    the bundle's conversion equals the checkpoint's."""
    root = mel_run["root"]
    assert mel_run["r1"]["step"] == 3 and mel_run["ex"]["feat"] == "mel"
    assert json.loads((root / "bundle" / "meta.json").read_text())["feat"] == "mel"
    assert load_export(root / "bundle").feat == "mel"
    wavs = sorted((root / "out" / "V001").glob("*.wav"))
    assert len(wavs) == 2 and mel_run["cv"]["n_wavs"] == 2
    sr, pcm = scipy.io.wavfile.read(wavs[0])
    assert sr == 16000 and pcm.dtype == np.int16 and len(pcm) > 1000
    for w in wavs:
        assert np.array_equal(read_units(root / "out" / "units" / f"{w.stem}.txt"),
                              read_units(root / "out_b" / "units" / f"{w.stem}.txt"))
        assert np.array_equal(scipy.io.wavfile.read(w)[1],
                              scipy.io.wavfile.read(root / "out_b" / "V001" / w.name)[1])


def test_mel_pipeline_units_match_jax(mel_run):
    """The JAX Converter with feat="mel" and the bundle's parameters and
    statistics, on the corpus's mel arrays: every unit of the port's
    conversion equals JAX's where the JAX logit margin is >= 1e-4 (features
    rounded to bf16 as both feature wires do)."""
    root = mel_run["root"]
    b = load_export(root / "bundle")
    hps = JaxHps(**dataclasses.asdict(b.hps))
    jstats = JaxSpeakerStats(b.stats.mean, b.stats.std)
    jconv = JaxConverter(hps, JaxAudioConfig(**TINY_AUDIO), {"params": b.enc}, {"params": b.dec},
                         batch_size=2, stats=jstats, feat="mel", gru_impl="scan", gl_iters=4)
    feats, names, srcs = load_corpus_split(mel_run["ds"], "test", feat="mel")
    assert feats[0].shape[1] == 20
    units, _ = jconv.convert_features_multi(feats, [b.speakers["V001"]], tgt_names=["V001"], src_speakers=srcs)
    n_bits = flips = 0
    for f, utt, spk, ref in zip(feats, names, srcs, units):
        u = read_units(root / "out" / "units" / f"{utt}.txt")
        assert u.shape == ref.shape
        n_bits += u.size
        if (u != ref).any():
            x = jnp.asarray(jstats.normalize(f, spk), jnp.bfloat16).astype(jnp.float32)
            lg = np.asarray(JaxEncoder(hps).apply({"params": b.enc}, x[None]))[0]
            m = np.abs(lg[..., 0] - lg[..., 1])[u != ref]
            flips += m.size
            assert (m < MARGIN).all(), m
    print(f"mel pipeline: {flips} of {n_bits} unit bits differ from JAX's (all within the margin)")


def test_mel_convert_single_from_checkpoint_and_eval(mel_run):
    """convert-single from -dataset_path -ckpt_dir (no bundle) on mel, and
    eval --recon --stability --feat mel on the checkpoint."""
    root = mel_run["root"]
    c = ["--hps", mel_run["hps"], "--device", "cpu"]
    out = cli.main(["convert-single", "-dataset_path", mel_run["ds"], "-ckpt_dir", mel_run["ck"],
                    "--source", str(root / "corpus" / "test" / "S09_0000.wav"), "--target", "V001",
                    "-result_dir", str(root / "single"), "--gl-iters", "2", "--feat", "mel", *c])
    sr, pcm = scipy.io.wavfile.read(out["wav"])
    assert sr == 16000 and pcm.dtype == np.int16 and len(pcm) > 1000
    assert read_units(out["units"]).shape[1] == 16
    rep = cli.main(["eval", "-dataset_path", mel_run["ds"], "-ckpt_dir", mel_run["ck"], "--recon",
                    "--stability", "--n-segments", "4", "--feat", "mel", *c])
    assert rep["reconstruction"]["feat"] == "mel" and np.isfinite(rep["reconstruction"]["recon_l1"])
    assert "stability" in rep


def test_device_dataset_feat_guard_and_bf16_arena(mel_run):
    """The mel arena in bf16 holds the f32 arena's values rounded once, and
    batches come out in f32; an n_feat that does not match the chosen
    features is refused."""
    hps = Hps(**TINY_HPS)
    d32 = DeviceDataset.from_corpus(mel_run["ds"], hps, device="cpu", feat="mel")
    d16 = DeviceDataset.from_corpus(mel_run["ds"], hps, device="cpu", feat="mel", dtype=torch.bfloat16)
    assert d16.arena.dtype == torch.bfloat16 and d32.arena.shape == (d32.arena.shape[0], 20)
    assert torch.equal(d16.arena, d32.arena.to(torch.bfloat16))
    batch = d16.sample_batch(torch.Generator().manual_seed(0))
    assert batch["x"].dtype == torch.float32 and batch["x"].shape == (4, 32, 20)
    with pytest.raises(ValueError, match="check --feat"):
        DeviceDataset.from_corpus(mel_run["ds"], hps, device="cpu", feat="lin")
