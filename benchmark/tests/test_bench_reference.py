"""The frozen reference against the port's plain path on the CPU, at the
tests' geometry: parameter names and shapes (at flagship width too),
each module's forward pass, the frontend, Griffin-Lim and a whole cell's
comparison, which must read near zero for a sound program."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.core import manifest, traffic, weights
from benchmark.reference import dsp, model
from benchmark.tests.tiny import CELLS, TINY_AUDIO, TINY_HPS, tiny_cell

torch.set_num_threads(1)
FLAGSHIP = manifest.load_json(manifest.HERE / "configs" / "zs19-en-lin-f32.json")


def _port(hp: dict, ac: dict | None = None):
    from zerospeech_tts_tpu_torch.config import AudioConfig, Hps

    return Hps.from_dict(hp), AudioConfig.from_dict(ac or FLAGSHIP["audio"])


def _tiny():
    hp = dict(FLAGSHIP["hps"], **TINY_HPS)
    ac = dict(FLAGSHIP["audio"], **TINY_AUDIO)
    return hp, ac


@pytest.mark.parametrize("module", model.MODULES)
@pytest.mark.parametrize("size", ["flagship", "tiny"])
def test_parameter_names_and_shapes_are_the_ports(module, size):
    from zerospeech_tts_tpu_torch.params import make_module

    hp = FLAGSHIP["hps"] if size == "flagship" else _tiny()[0]
    with torch.device("meta"):
        m = make_module(module, _port(hp)[0])
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == model.param_shapes(hp, module)
    if size == "flagship":
        assert sum(p.numel() for p in m.parameters()) == FLAGSHIP["parameters"][module]


def _modules(hp, dtype=torch.float32):
    from zerospeech_tts_tpu_torch.params import make_module

    params = weights.make_params(hp, model.MODULES, 11, "cpu")
    mods = {}
    for name in model.MODULES:
        mods[name] = make_module(name, _port(hp)[0])
        mods[name].load_state_dict(params[name])
        mods[name].to(dtype).eval()
    return {n: {k: v.to(dtype) for k, v in p.items()} for n, p in params.items()}, mods


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_and_decoder_match_the_ports(dtype):
    hp, _ = _tiny()
    p, mods = _modules(hp, dtype)
    x = torch.randn(3, 40, hp["n_feat"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model.encoder(p["enc"], hp, x)
        want = mods["enc"](x)
        assert torch.equal(model.units(got), (want[..., 0] > want[..., 1]).int()) or dtype == torch.bfloat16
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
        z = model.units(got).float()
        spk = torch.tensor([0, 2, 3])
        torch.testing.assert_close(model.decoder(p["dec"], hp, z, spk).float(), mods["dec"](z, spk).float(),
                                   atol=tol, rtol=tol)


def test_critic_matches_the_ports():
    hp, _ = _tiny()
    p, mods = _modules(hp)
    x = torch.randn(2, hp["seg_len"], hp["n_feat"], generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for a, b in zip(model.critic(p["dis"], hp, x), mods["dis"](x)):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_frontend_and_griffin_lim_match_the_ports():
    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.ops.griffin_lim import griffin_lim_plain

    ac = FLAGSHIP["audio"]
    _, acfg = _port(FLAGSHIP["hps"])
    y = traffic.speechlike(16000 + 57, traffic.rng(1, 2))
    pcm = dsp.pcm16(y)
    bs = dsp.bases(ac, "cpu")
    mag = dsp.features(pcm, ac, bs, "cpu")
    _, want = audio.wav_to_features(torch.from_numpy(pcm.astype(np.float32) / 32768.0), acfg)
    torch.testing.assert_close(mag, want, atol=2e-5, rtol=1e-4)
    amp = (dsp.db_norm_to_amp(mag, ac) ** ac["gl_power"])[None]
    ours = dsp.griffin_lim(amp, ac, bs, 4)
    theirs = griffin_lim_plain(amp, acfg, n_iters=4)
    assert (torch.linalg.norm(ours - theirs) / torch.linalg.norm(theirs)).item() < 1e-3
    de = dsp.de_emphasis(ours.numpy(), ac["preemphasis"])
    np.testing.assert_allclose(de, audio.de_emphasis(ours, ac["preemphasis"]).numpy(), atol=1e-4)


def test_trim_matches_the_ports():
    from zerospeech_tts_tpu_torch.dsp.wavio import trim_silence

    y = np.concatenate([np.zeros(5000, np.float32), traffic.speechlike(9000, traffic.rng(2, 2)),
                        np.zeros(7000, np.float32)])
    assert np.array_equal(dsp.trim_silence(y, 15.0), trim_silence(y, 15.0))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_program_reads_near_zero(name):
    """A whole tiny run of each cell: the port's plain path against the
    reference, every number inside a quarter of its limit."""
    from benchmark import run

    c = tiny_cell(name)
    res = run.run(name, 2**31 + 99, 0.2, False, "cpu", c)
    assert res["correct"], res["checks"]
    for k, v in res["checks"].items():
        assert v["value"] <= 0.25 * v["limit"], (k, v)
