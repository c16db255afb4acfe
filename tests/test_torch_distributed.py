"""PyTorch port, data-parallel training across two real processes on gloo
(launched with torchrun's variables, ``parallel.launch``, which retries a
rendezvous port that was taken).

One step of each kind from a JAX state, each rank fed its slice of JAX's
draws (``tools/dp_parity.py``): the all-reduced update against the port's
single-process step on the global batch (gradients, updated parameters and
metrics within 1e-5 relative) and against JAX's step on a ``data=2`` mesh
(the solver tests' bars: metrics 1e-5 relative, each module's gradient
1e-4 rel-L2, parameters within 2 lr; marked slow, as it compiles a JAX
mesh program for each step kind). The batch's pair offsets differ
across the ranks' rows (the global masked mean) and the stage-2 targets
JAX draws reach across the ranks (the global target draw).

Then ``train1 --device cpu --mesh data=2`` under the launcher, from the
SegmentLoader and from the sharded arena (``--device-data``): rank 0 alone
prints and writes, and a resumed run trims the schedule as at world 1.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zerospeech_tts_tpu.parallel import batch_sharding, make_mesh, replicate_state
from zerospeech_tts_tpu.train import Solver as JaxSolver
from zerospeech_tts_tpu_torch.config import Hps
from zerospeech_tts_tpu_torch.data.segments import make_segment_index
from zerospeech_tts_tpu_torch.params import state_dicts_from_flax, train_state_from_flax
from zerospeech_tts_tpu_torch.parallel import launch
from zerospeech_tts_tpu_torch.tools import dp_parity

torch.set_num_threads(1)

MODS = ("enc", "dec", "clf", "dis")
ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")  # each rank's torch threads, as this process's


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(enc_dp=0.0, dis_dp=0.0, lr=1e-3, lat_sched_iters=10, alpha_enc=0.5)


def _batch(h, seed):
    rng = np.random.default_rng(seed)
    b, ds = h.batch_size, h.downsample
    f = lambda: rng.uniform(0, 1, (b, h.seg_len, h.n_feat)).astype(np.float32)  # noqa: E731
    return {
        "x": f(), "spk": rng.integers(0, h.n_speakers, b).astype(np.int32),
        "x2": f(), "pair_dt": (ds * np.array([0, 1, 3, -2])).astype(np.int32),  # rank 0: 0, ds; rank 1: 3ds, -2ds
        "x_real": f(), "spk_real": np.array([0, 1, 2, 3], np.int32),
    }


def _gumbel(k, shape):
    return np.asarray(jax.random.uniform(jax.random.fold_in(k, 1), shape, minval=1e-20, maxval=1.0))


def _target_idx(k, n):
    return np.asarray(jax.random.choice(jax.random.fold_in(k, 4), jnp.arange(n), (n,)))


def _eps(k, b):
    return np.asarray(jax.random.uniform(jax.random.fold_in(k, 7), (b, 1, 1)))


def jax_case(h):
    """A fresh JAX state at step 5 of the 'train' phase (alpha = alpha_enc /
    2), a global batch and JAX's draws for each step; the dp_parity case
    built from them: (JAX solver, JAX state, case, the stage-2 target
    uniforms)."""
    js = JaxSolver(h)
    base = jax.jit(js.init_state)(jax.random.PRNGKey(0)).replace(
        step=jnp.asarray(5, jnp.int32), train_start=jnp.asarray(0, jnp.int32))
    _, k = jax.random.split(base.rng)
    lat = (h.batch_size, h.n_bins, h.emb_size, 2)
    lat2 = (2 * h.batch_size,) + lat[1:]
    b = h.batch_size
    target_u = ((_target_idx(k, b) + 0.5) / b).astype(np.float32)  # floor(u b) = JAX's index
    draws = {"pretrain_AE": [_gumbel(k, lat)], "pretrain_AE pairs": [_gumbel(k, lat2)],
             "pretrain_C": [_gumbel(k, lat)], "train": [_gumbel(k, lat), _gumbel(k, lat2)],
             "patch_d": [target_u, _gumbel(k, lat), _eps(k, b)], "patch_g": [target_u, _gumbel(k, lat)]}
    full = _batch(h, 5)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    adam = {n: (int(a.count), np_(a.mu), np_(a.nu))
            for n in MODS for a in [getattr(base, f"opt_{n}")[1][0]]}
    pst = train_state_from_flax(h, {n: np_(getattr(base, n)) for n in MODS}, adam, step=int(base.step),
                                train_start=0, device="cpu")
    case = dict(hps=dataclasses.asdict(h), seed=0, state=dict(
        modules={n: m.state_dict() for n, m in pst.modules.items()},
        opts={n: o.state_dict() for n, o in pst.opts.items()}, step=pst.step, train_start=pst.train_start),
        steps=[dict(name=name, fn=fn, batch={kk: full[kk] for kk in keys}, draws=draws[name])
               for name, fn, keys in dp_parity.STEPS])
    return js, base, case, target_u


@pytest.fixture(scope="module")
def case(hps):
    return jax_case(hps)


@pytest.fixture(scope="module")
def dp(case):
    """Every step through dp_parity on two gloo ranks, with results."""
    return dp_parity.run(case[2], world=2, device="cpu", results=True, timeout=300, env=ONE_THREAD)


def test_dp_step_of_each_kind_equals_the_single_process_step(hps, case, dp):
    target_u = case[3]
    assert dp["world"] == 2 and dp["backend"] == "gloo"
    # the stage-2 draw picks rows of the other rank's spk_real too
    idx = np.floor(target_u * hps.batch_size).astype(int)
    assert (idx[:2] >= 2).any() or (idx[2:] < 2).any()
    assert set(dp["report"]) == {name for name, _, _ in dp_parity.STEPS}
    # ranks bit-equal, untouched modules unmoved; parameters, gradients and
    # pre-clip gradient norms within 1e-5 relative; metrics within 1e-5
    assert not dp_parity.failures(dp["report"], metrics_bar=1e-5)


@pytest.mark.parametrize("control", [False, True], ids=["as_built", "undivided_all_reduce"])
def test_dp_parity_bars_catch_a_gradient_of_the_wrong_scale(hps, control):
    """dp_parity's own case (Adam moments warmed by one step, so an update
    depends on the gradient's scale) meets every bar as built; with the
    planted fault (the gradient all_reduce not divided by the world size)
    every step misses its pre-clip norm bar, and the updated parameters
    move apart too (from zero moments Adam's first update is ~lr sign(g)
    and would hide it)."""
    case = dp_parity.make_case(hps, seed=1)
    out = dp_parity.run(case, world=2, device="cpu", timeout=300, env=ONE_THREAD, control=control)
    missed = dp_parity.failures(out["report"], metrics_bar=1e-5)
    if not control:
        assert not missed
        return
    for name in out["report"]:
        assert any(x.startswith(f"{name}: grad_norm_rel") for x in missed), (name, missed)
    assert any(": param_rel" in x for x in missed), missed


@pytest.mark.slow  # a JAX mesh program compiled for each step kind: ~35 s in all on one CPU thread
@pytest.mark.parametrize("kind", [name for name, _, _ in dp_parity.STEPS])
def test_dp_step_of_each_kind_equals_jax_on_a_mesh(hps, case, dp, kind):
    h, (js, base, c, _) = hps, case
    spec = next(s for s in c["steps"] if s["name"] == kind)
    mesh = make_mesh(data=2, model=1)
    jb = jax.device_put({kk: jnp.asarray(v) for kk, v in spec["batch"].items()}, batch_sharding(mesh))
    jnew, jm = getattr(js, spec["fn"])(replicate_state(jax.tree.map(jnp.copy, base), mesh), jb)
    jnew = jax.tree.map(np.asarray, jnew)
    res = dp["results"][kind]["dp"]
    assert set(res["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(res["metrics"][k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    b1 = h.beta1
    for n in dp_parity.UPDATES[spec["fn"]]:
        a0, a1 = getattr(base, f"opt_{n}")[1][0], getattr(jnew, f"opt_{n}")[1][0]
        g_ref = jax.tree.map(lambda m1, m0: (np.asarray(m1) - b1 * np.asarray(m0)) / (1 - b1), a1.mu, a0.mu)
        g_ref = state_dicts_from_flax({n: g_ref})[n]
        p_ref = state_dicts_from_flax({n: getattr(jnew, n)})[n]
        num = den = 0.0
        for pname, g in res["grads"][n].items():
            num += float(((g - g_ref[pname]) ** 2).sum())
            den += float((g_ref[pname] ** 2).sum())
            assert (res["params"][n][pname] - p_ref[pname]).abs().max().item() <= 2 * h.lr + 1e-6, pname
        assert np.sqrt(num / den) <= 1e-4, (n, np.sqrt(num / den))


# ----------------------------------------------------------- train1 --mesh


def _corpus(root, h):
    """A port corpus directory (6 utterances of 3 speakers, V001 among
    them) and its segment index."""
    rng = np.random.default_rng(0)
    lens = [70, 64, 80, 66, 75, 90]
    spks = ["S01", "S01", "S02", "S02", "V001", "V001"]
    (root / "ds" / "train").mkdir(parents=True)
    np.save(root / "ds" / "train" / "lin.npy", rng.uniform(0, 1, (sum(lens), h.n_feat)).astype(np.float32))
    (root / "ds" / "train" / "index.json").write_text(json.dumps(dict(
        names=[f"{s}_{i}" for i, s in enumerate(spks)], speakers=spks, lengths=lens,
        starts=np.concatenate([[0], np.cumsum(lens)[:-1]]).tolist())))
    (root / "ds" / "speakers.json").write_text(json.dumps({"S01": 0, "S02": 1, "V001": 2}))
    make_segment_index(root / "ds", root / "idx.json", h.seg_len, 200, seed=0, pair_grid=h.downsample)


@pytest.mark.parametrize("device_data", [False, True], ids=["loader", "device_data"])
def test_train1_mesh_data_2_writes_once_and_resumes(tmp_path, tiny_hps, device_data):
    h = tiny_hps.replace(n_speakers=3, log_interval=1, save_interval=100, n_critic=1)
    _corpus(tmp_path, h)
    (tmp_path / "tiny.json").write_text(json.dumps(dataclasses.asdict(h)))
    ck = tmp_path / "ck"
    cmd = ["-m", "zerospeech_tts_tpu_torch", "train1", "-dataset_path", str(tmp_path / "ds"),
           "-index_path", str(tmp_path / "idx.json"), "-ckpt_dir", str(ck), "--hps", str(tmp_path / "tiny.json"),
           "--device", "cpu", "--mesh", "data=2"] + (["--device-data"] if device_data else [])
    for iters, want in (("2", "stage-1 done at step 6"), ("3", "stage-1 done at step 9")):
        outs = launch(cmd + ["--iters-override", iters], 2, env=ONE_THREAD, timeout=300)
        for r, (rc, _, err) in enumerate(outs):
            assert rc == 0, f"rank {r}:\n{err[-3000:]}"
        (_, out0, _), (_, out1, _) = outs
        assert want in out0 and "== phase" in out0
        assert out1.strip() == "", out1  # rank 1 prints nothing
    assert "resumed from step 6" in out0 and "== phase train: 3 iters" in out0
    assert "pretrain_AE" not in out0  # the resumed schedule skips the finished phases
    files = sorted(str(p.relative_to(ck)) for p in ck.rglob("*") if p.is_file())
    events = [f for f in files if f.startswith("logs/events.out.tfevents")]  # tensorboardX, where it imports
    assert len(events) in (0, 2), files  # one a run: rank 0's
    assert [f for f in files if f not in events] == ["hps.json", "logs/metrics.jsonl", "step_6.pt", "step_9.pt"]
    lines = [json.loads(x) for x in (ck / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [(x["mode"], x["step"]) for x in lines] == (
        [("pretrain_AE", 1), ("pretrain_AE", 2), ("pretrain_C", 3), ("pretrain_C", 4), ("train", 5),
         ("train", 6), ("train", 7), ("train", 8), ("train", 9)])
    assert all(np.isfinite(v) for x in lines for k, v in x.items() if k not in ("mode", "step"))
    assert torch.load(ck / "step_9.pt", weights_only=True)["step"] == 9
    Hps(**json.loads((ck / "hps.json").read_text()))  # written whole, once
